"""BatchedExecutor — the host serving loop over the engine.

Counterpart of `hcrag_tpu/query/executor.py`.  Concurrent requests (one
query embedding each) accumulate into device batches of a few fixed sizes,
padded at the tail; a dispatcher thread issues each batch's step without
waiting for the device, and a resolver thread reads the outputs back and
resolves the requests' futures.  Two modes, each returning what it
dispatches:

* ``mode="retrieval"`` (default): the engine's selection and rescore alone
  (`retrieve_batch_device`); a future resolves to ``(scores [k], indices
  [k])``;
* ``mode="full"``: the whole step (`query_batch_device`: selection,
  relevance metrics, expansion, the 0.7/0.3 blend); a future resolves to a
  `ServedResult`.

On a CUDA engine, dispatch and readback overlap as follows.

* The dispatcher normalizes the batch on the host into pinned memory, copies
  it to the card without waiting (`non_blocking`), runs the step (its
  kernels launch on the dispatcher's current stream and the step has no
  host sync), records a CUDA event after it, and queues (outputs, event).
  The engine's per-call operands go the same way
  (`QueryEngine._put_operand`), so no copy from pageable memory makes a
  dispatch wait for the batches before it.
* The resolver makes a copy stream wait on that batch's event alone, copies
  the batch's outputs on that stream into pinned host buffers kept per
  dispatch size, marks the outputs as used there (`record_stream`, so the
  caching allocator does not hand their memory out early), waits for the
  copies and hands the callers copies of the buffers.  A plain `.cpu()`
  would run on the dispatcher's stream, behind every batch dispatched
  after this one; and a new pinned allocation per batch would call
  `cudaHostAlloc` whenever callers still hold earlier results.
* `resolve_time` is stamped when the copies are done; `pipeline_depth`
  bounds the batches in flight.

On a CPU engine (the tests) the step has finished when it returns, and the
resolver reads its tensors directly.

The rest follows the JAX executor: `SlotFuture` is a view into a per-batch
result (one event and one time stamp per batch, results sliced lazily);
`submit_many` enqueues an [m, d] block under one lock; `batch_sizes` lets a
lightly loaded dispatcher ship a small padded batch; `max_wait_ms` bounds
how long a batch is held open from its first request; `shutdown` lets
in-flight batches drain, then fails every request still queued so no caller
blocks forever.

Usage:
    ex = BatchedExecutor(engine, batch_size=256, max_wait_ms=2.0)
    fut = ex.submit(query_embedding)          # thread-safe
    scores, indices = fut.result()
    ex.shutdown()
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class ServedResult:
    """Per-request slice of the full step (mode="full")."""

    top_scores: np.ndarray  # [k] cosine similarity
    top_indices: np.ndarray  # [k] index rows
    relevance: np.ndarray  # [k] isRelevant scores
    combined: np.ndarray  # [k] 0.7*rel + 0.3*sim
    expanded_nodes: np.ndarray  # [max_expanded] graph node ids (-1 pad)
    expanded_count: int
    expanded_relevance: np.ndarray  # [max_expanded]


class _BatchResult:
    """Resolution state shared by every request of one dispatched batch:
    one Event resolves the whole batch, and `SlotFuture.result()` slices
    the host arrays lazily, so the resolver does O(1) Python work per
    batch."""

    __slots__ = ("event", "payload", "exc", "mode", "resolve_time")

    def __init__(self, mode: str):
        self.event = threading.Event()
        self.payload = None  # host arrays after the readback
        self.exc: Optional[BaseException] = None
        self.mode = mode
        self.resolve_time = 0.0


class SlotFuture:
    """Future-like handle for one request inside a batch: `result(timeout)`,
    `done()`, `add_done_callback(fn)`, and `resolve_time` (the resolver's
    monotonic stamp for the whole batch)."""

    __slots__ = ("_batch", "_slot", "_callbacks")

    def __init__(self):
        self._batch: Optional[_BatchResult] = None
        self._slot = -1
        self._callbacks: Optional[list] = None

    # -- executor side -------------------------------------------------
    def _bind(self, batch: _BatchResult, slot: int) -> None:
        self._batch = batch
        self._slot = slot

    def _fail(self, exc: BaseException) -> None:
        b = _BatchResult("error")
        b.exc = exc
        b.event.set()
        self._batch = b

    def _fire_callbacks(self) -> None:
        if self._callbacks:
            for fn in self._callbacks:
                try:
                    fn(self)
                except Exception:  # a caller's callback must not stop the resolver
                    pass
            self._callbacks = None

    # -- caller side ---------------------------------------------------
    def done(self) -> bool:
        return self._batch is not None and self._batch.event.is_set()

    @property
    def resolve_time(self) -> float:
        return self._batch.resolve_time if self._batch is not None else 0.0

    def add_done_callback(self, fn) -> None:
        if self.done():
            fn(self)
            return
        if self._callbacks is None:
            self._callbacks = []
        self._callbacks.append(fn)
        # Resolution may have raced the append; _fire_callbacks clears the
        # list, so a concurrent resolver fire never calls twice.
        if self.done():
            self._fire_callbacks()

    def result(self, timeout: Optional[float] = None):
        deadline = None if timeout is None else time.monotonic() + timeout
        # The dispatcher binds the batch; before that there is nothing to
        # wait on, so poll the binding with short sleeps.
        while self._batch is None:
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError("request was never dispatched")
            time.sleep(0.0005)
        remaining = (
            None if deadline is None else max(0.0, deadline - time.monotonic())
        )
        if not self._batch.event.wait(remaining):
            raise TimeoutError("batch did not resolve in time")
        b = self._batch
        if b.exc is not None:
            raise b.exc
        i = self._slot
        if b.mode == "retrieval":
            scores, indices = b.payload
            return scores[i], indices[i]
        v, idx, rel, comb, exp, exp_n, exp_rel = b.payload
        return ServedResult(
            top_scores=v[i], top_indices=idx[i], relevance=rel[i],
            combined=comb[i], expanded_nodes=exp[i],
            expanded_count=int(exp_n[i]), expanded_relevance=exp_rel[i],
        )


class BatchedExecutor:
    def __init__(
        self,
        engine,
        *,
        batch_size: int = 256,
        max_wait_ms: float = 2.0,
        top_k: int = 10,
        expansion_depth: int = 1,
        pipeline_depth: int = 4,
        mode: str = "retrieval",
        batch_sizes: Optional[Sequence[int]] = None,
    ):
        if mode not in ("retrieval", "full"):
            raise ValueError(f"mode must be 'retrieval' or 'full', got {mode!r}")
        mesh = getattr(engine, "mesh", None)
        if mesh is not None and mesh.size > 1:
            # Every rank of a sharded engine must make the same calls; one
            # dispatcher per rank would batch different requests.
            raise ValueError(
                f"BatchedExecutor serves one rank; this engine spans {mesh.size}. "
                "Serving over several ranks needs rank 0's dispatcher to "
                "broadcast each batch to the others (ROADMAP A, item 9)"
            )
        self.engine = engine
        self.device = torch.device(engine.device)
        self.batch_size = batch_size
        # Allowed dispatch sizes, ascending: the dispatcher ships the
        # smallest that covers the waiting requests.
        sizes = sorted(set(batch_sizes or [])) or [batch_size]
        if sizes[-1] < batch_size:
            sizes.append(batch_size)
        self.batch_sizes = [s for s in sizes if s <= batch_size]
        self.max_wait_s = max_wait_ms / 1000.0
        self.top_k = top_k
        self.expansion_depth = expansion_depth
        self.mode = mode
        self._cuda = self.device.type == "cuda"
        # The card's index, fixed here: each thread selects it before its
        # first CUDA call (a new thread starts on card 0).
        self._card = None
        self._copy_stream = None
        self._staging = {}  # the resolver's pinned readback buffers
        if self._cuda:
            self._card = (self.device.index if self.device.index is not None
                          else torch.cuda.current_device())
            self._copy_stream = torch.cuda.Stream(self._card)
        # Pending request blocks (embs [m, d] f32, futures, offset) under
        # one lock; `_pending_n` counts their requests.
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._blocks: List[Tuple[np.ndarray, List[SlotFuture], int]] = []
        self._pending_n = 0
        # Dispatched, unresolved batches, at most `pipeline_depth`.
        self._inflight: "queue.Queue" = queue.Queue(maxsize=pipeline_depth)
        self._stop = threading.Event()
        self.batches_dispatched = 0
        self.requests_served = 0
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._resolver = threading.Thread(target=self._resolve_loop, daemon=True)
        self._thread.start()
        self._resolver.start()

    # -- submission ----------------------------------------------------
    def submit(self, query_embedding: np.ndarray) -> SlotFuture:
        """Enqueue one query embedding.  Resolves to (scores [k],
        indices [k]) in retrieval mode, or a `ServedResult` in full mode."""
        return self.submit_many(
            np.asarray(query_embedding, np.float32).reshape(1, -1)
        )[0]

    def submit_many(self, embs: np.ndarray) -> List[SlotFuture]:
        """Enqueue a block of [m, d] query embeddings under one lock."""
        embs = np.asarray(embs, np.float32)
        if embs.ndim != 2:
            embs = embs.reshape(1, -1)
        futs = [SlotFuture() for _ in range(embs.shape[0])]
        with self._not_empty:
            if self._stop.is_set():
                raise RuntimeError("executor is shut down")
            self._blocks.append((embs, futs, 0))
            self._pending_n += embs.shape[0]
            self._not_empty.notify()
        return futs

    # -- dispatcher ----------------------------------------------------
    def _take(self, limit: int) -> Tuple[List[np.ndarray], List[SlotFuture]]:
        """Pop up to `limit` requests (lock held by the caller), splitting
        a block that straddles the limit."""
        arrs: List[np.ndarray] = []
        futs: List[SlotFuture] = []
        taken = 0
        while self._blocks and taken < limit:
            embs, bfuts, off = self._blocks[0]
            avail = embs.shape[0] - off
            want = min(avail, limit - taken)
            arrs.append(embs[off:off + want])
            futs.extend(bfuts[off:off + want])
            taken += want
            if want == avail:
                self._blocks.pop(0)
            else:
                self._blocks[0] = (embs, bfuts, off + want)
        self._pending_n -= taken
        return arrs, futs

    def _collect(self) -> Tuple[List[np.ndarray], List[SlotFuture]]:
        """Micro-batching with a total deadline: everything already queued,
        then one window of `max_wait_ms` from the first request, after which
        the batch ships however full it is.  While the in-flight queue is
        full, keep absorbing requests until the batch is full or a slot
        frees: an early ship would only wait on the queue while its padded
        slots cost device time."""
        with self._not_empty:
            while self._pending_n == 0 and not self._stop.is_set():
                self._not_empty.wait(timeout=0.1)
            if self._pending_n == 0:
                return [], []
            if self._pending_n < self.batch_size:
                deadline = time.monotonic() + self.max_wait_s
                while self._pending_n < self.batch_size:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or self._stop.is_set():
                        break
                    self._not_empty.wait(timeout=remaining)
            while (
                self._pending_n < self.batch_size
                and self._inflight.full()
                and not self._stop.is_set()
            ):
                self._not_empty.wait(timeout=0.001)
            return self._take(self.batch_size)

    def _queries(self, arrs: List[np.ndarray], dispatch_b: int) -> torch.Tensor:
        """The batch [dispatch_b, d], zero-padded and L2-normalized on the
        host, on the engine's device: on CUDA written into pinned memory and
        copied without waiting."""
        batch = arrs[0] if len(arrs) == 1 else np.concatenate(arrs, axis=0)
        d = batch.shape[1]
        host = torch.zeros((dispatch_b, d), dtype=torch.float32, pin_memory=self._cuda)
        norms = np.maximum(np.linalg.norm(batch, axis=1, keepdims=True), 1e-12)
        np.divide(batch, norms, out=host.numpy()[: batch.shape[0]])
        if not self._cuda:
            return host
        return host.to(self.device, non_blocking=True)

    def _loop(self) -> None:
        """Dispatcher: batch requests and issue their steps without
        waiting for the device."""
        if self._cuda:
            torch.cuda.set_device(self._card)
        while not self._stop.is_set():
            arrs, futs = self._collect()
            if not futs:
                continue
            n = len(futs)
            dispatch_b = next(
                (s for s in self.batch_sizes if s >= n), self.batch_size
            )
            try:
                q = self._queries(arrs, dispatch_b)
                if self.mode == "retrieval":
                    out = tuple(self.engine.retrieve_batch_device(q, top_k=self.top_k))
                else:
                    out = tuple(self.engine.query_batch_device(
                        q, top_k=self.top_k, expansion_depth=self.expansion_depth,
                    )[:7])
                done = None
                if self._cuda:
                    done = torch.cuda.Event()
                    done.record()
                self.batches_dispatched += 1
                batch_res = _BatchResult(self.mode)
                for i, fut in enumerate(futs):
                    fut._bind(batch_res, i)
                self._inflight.put((out, done, batch_res, futs))
            except Exception as e:  # a failed dispatch fails its requests
                for fut in futs:
                    fut._fail(e)
                    fut._fire_callbacks()

    # -- resolver ------------------------------------------------------
    def _readback(self, out: Tuple[torch.Tensor, ...], done) -> tuple:
        """The batch's outputs as host arrays.  On CUDA: a copy stream
        waits on the batch's event only, then copies every output into
        pinned memory, and the host waits for those copies alone."""
        if done is None:
            return tuple(t.numpy() for t in out)
        stream = self._copy_stream
        key = tuple((tuple(t.shape), t.dtype) for t in out)
        host = self._staging.get(key)
        if host is None:  # one set of pinned buffers per dispatch size and mode
            host = self._staging[key] = [
                torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in out]
        with torch.cuda.stream(stream):
            stream.wait_event(done)
            for h, t in zip(host, out):
                h.copy_(t, non_blocking=True)
                t.record_stream(stream)
        stream.synchronize()
        # Callers keep their results: copies out of the reused buffers.
        return tuple(h.numpy().copy() for h in host)

    def _resolve_loop(self) -> None:
        """Resolver: read batches back, in dispatch order, while dispatch
        goes on."""
        if self._cuda:
            torch.cuda.set_device(self._card)
        while not self._stop.is_set() or not self._inflight.empty():
            try:
                out, done, batch_res, futs = self._inflight.get(timeout=0.1)
            except queue.Empty:
                continue
            try:
                batch_res.payload = self._readback(out, done)
                batch_res.resolve_time = time.monotonic()
                self.requests_served += len(futs)
            except Exception as e:  # a failed readback fails its batch
                batch_res.exc = e
            del out
            batch_res.event.set()
            for fut in futs:
                if fut._callbacks is not None:
                    fut._fire_callbacks()

    def shutdown(self) -> None:
        """Let in-flight batches drain (up to 10 s), stop both threads, then
        fail every request still queued."""
        deadline = 10.0
        t0 = time.time()
        while not self._inflight.empty() and time.time() - t0 < deadline:
            time.sleep(0.05)
        self._stop.set()
        with self._not_empty:
            self._not_empty.notify_all()
        self._thread.join(timeout=5)
        self._resolver.join(timeout=5)
        with self._lock:
            leftovers = [
                f for _, bfuts, off in self._blocks for f in bfuts[off:]
            ]
            self._blocks.clear()
            self._pending_n = 0
        exc = RuntimeError("executor shut down before request was served")
        for f in leftovers:
            if not f.done():
                f._fail(exc)
                f._fire_callbacks()
