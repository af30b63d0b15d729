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

Over a sharded engine (`parallel.ShardedQueryEngine`, one process per rank)
every rank's step must join the same collectives in the same order, so the
executor runs a rank protocol, at any world size (one rank included):

* every rank constructs `BatchedExecutor(engine, ...)` with the same
  arguments, and every rank calls `shutdown()`.  The constructor makes a
  gloo group over the mesh's ranks (the headers; it takes the mesh's
  `timeout`) and the ranks exchange a fingerprint of `mode`, `top_k`,
  `expansion_depth`, `batch_size`, `batch_sizes`, `pipeline_depth` and the
  engine's `resolved_kernel_config`: on a mismatch every rank raises the
  same `ValueError` (it would hang or mis-shape a collective);
* rank 0 (the mesh's global rank 0) takes the requests and batches them as
  above.  Its dispatcher checks the batch on the host (the width against
  the index's), then sends a header (step, dispatch size, sequence number)
  over the gloo group, then the padded, normalized batch [dispatch_b, d]
  f32 over the mesh's world group on the engine's device (NCCL where each
  rank has a card), and only then issues the step.  The queries are
  normalized once, on rank 0, and travel as bits.  Only the dispatcher
  thread issues collectives; the resolver issues none.  An idle dispatcher
  sends an idle header every second (or a quarter of the mesh's timeout),
  so the followers' receives do not time out while rank 0 waits for work;
* every other rank follows: `submit` raises; one thread receives each
  header and batch, checks that the sequence number is the next one, runs
  the same step with the executor's `top_k` and `expansion_depth`, and
  drops the outputs (at most `pipeline_depth` steps in flight on the
  device), so `batches_dispatched` equals rank 0's;
* a batch that fails on rank 0 before its header goes out (a request of
  another width) fails its own requests only.  A step that raises on any
  rank after the header is fatal to the group: the other ranks sit in a
  collective that will never complete, until the mesh's timeout frees
  them (build the mesh with a finite one).  Over gloo groups (the CPU, or
  ranks sharing a card), where a collective blocks the host and raises at
  the timeout, rank 0 then fails that batch, every batch in flight and
  every queued request, and later submits raise with the cause; each
  follower's loop ends with the error, which its `shutdown()` re-raises.
  Over NCCL (a card per rank) a step only enqueues its collectives, so
  the dispatcher may see no error: there NCCL's watchdog acts at the
  timeout (by default it ends the process), and this contract is untested;
* rank 0's `shutdown()` drains the batches in flight, sends the stop, and
  fails what is left; a follower's waits, for at most its `timeout`, for
  the stop (or for its loop to end with an error: a rank 0 that is gone
  sends no header within the mesh's timeout) and joins its thread.  Each
  rank then destroys the executor's gloo group.

While an executor serves a multi-rank engine, nothing else may call that
engine: another caller's collectives would interleave with the
dispatcher's.
"""

from __future__ import annotations

import collections
import dataclasses
import queue
import threading
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

#: The rank protocol's header ops (int64 [op, dispatch size, sequence]).
_STOP, _STEP, _IDLE = 0, 1, 2


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


def _fail_all(futs: Sequence[SlotFuture], exc: BaseException) -> None:
    for fut in futs:
        fut._fail(exc)
        fut._fire_callbacks()


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
        # Allowed dispatch sizes, ascending: the dispatcher ships the
        # smallest that covers the waiting requests.
        sizes = sorted(set(batch_sizes or [])) or [batch_size]
        if sizes[-1] < batch_size:
            sizes.append(batch_size)
        self.batch_sizes = [s for s in sizes if s <= batch_size]
        mesh = getattr(engine, "mesh", None)
        # The rank protocol (see the module's docstring): headers over a
        # gloo group, batches over the mesh's world group; none for an
        # engine of one process.
        self._ctrl = self._world = None
        self._rank, self._d, self._idle_s = 0, None, float("inf")
        if mesh is not None:
            self._ctrl = dist.new_group(backend="gloo", timeout=mesh.timeout)
            self._world = mesh.world
            self._rank = dist.get_rank()
            self._d = int(engine.index.emb.shape[1])
            # A follower's shutdown waits this long for rank 0's stop.
            self._wait_s = (mesh.timeout or dist.default_pg_timeout).total_seconds()
            self._idle_s = min(1.0, self._wait_s / 4)
            try:
                self._check_same_arguments(dict(
                    mode=mode, top_k=top_k, expansion_depth=expansion_depth,
                    batch_size=batch_size, batch_sizes=self.batch_sizes,
                    pipeline_depth=pipeline_depth,
                    engine=engine.resolved_kernel_config(batch_size, top_k)))
            except ValueError:
                self._close_group()
                raise
        if mode not in ("retrieval", "full"):
            raise ValueError(f"mode must be 'retrieval' or 'full', got {mode!r}")
        self.engine = engine
        self.device = torch.device(engine.device)
        self.batch_size = batch_size
        self.max_wait_s = max_wait_ms / 1000.0
        self.top_k = top_k
        self.expansion_depth = expansion_depth
        self.pipeline_depth = pipeline_depth
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
        # The error that ended the rank protocol (a step that raised after
        # its header went out), and the last batch's sequence number.
        self._fatal: Optional[BaseException] = None
        self._seq = 0
        self.batches_dispatched = 0
        self.requests_served = 0
        self._resolver = None
        if self._rank == 0:
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._resolver = threading.Thread(target=self._resolve_loop, daemon=True)
            self._resolver.start()
        else:
            self._thread = threading.Thread(target=self._follow, daemon=True)
        self._thread.start()

    def _check_same_arguments(self, fingerprint: dict) -> None:
        """Every rank's fingerprint against rank 0's; on a mismatch every
        rank raises the same `ValueError`."""
        every = [None] * dist.get_world_size(self._ctrl)
        dist.all_gather_object(every, fingerprint, group=self._ctrl)
        other = [r for r, f in enumerate(every) if f != every[0]]
        if other:
            raise ValueError(
                "BatchedExecutor takes the same arguments on every rank of a sharded "
                f"engine; rank(s) {other} differ from rank 0: {every[other[0]]} "
                f"against {every[0]}"
            )

    # -- submission ----------------------------------------------------
    def submit(self, query_embedding: np.ndarray) -> SlotFuture:
        """Enqueue one query embedding.  Resolves to (scores [k],
        indices [k]) in retrieval mode, or a `ServedResult` in full mode."""
        return self.submit_many(
            np.asarray(query_embedding, np.float32).reshape(1, -1)
        )[0]

    def submit_many(self, embs: np.ndarray) -> List[SlotFuture]:
        """Enqueue a block of [m, d] query embeddings under one lock."""
        if self._rank != 0:
            raise RuntimeError(
                f"requests go to rank 0: rank {self._rank} follows rank 0's batches"
            )
        embs = np.asarray(embs, np.float32)
        if embs.ndim != 2:
            embs = embs.reshape(1, -1)
        futs = [SlotFuture() for _ in range(embs.shape[0])]
        with self._not_empty:
            if self._fatal is not None:
                raise RuntimeError(
                    f"executor stopped: a step failed across ranks ({self._fatal!r})"
                ) from self._fatal
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
        slots cost device time.  Returns nothing after `_idle_s` without a
        request (the rank protocol's idle header)."""
        with self._not_empty:
            idle_until = time.monotonic() + self._idle_s
            while self._pending_n == 0 and not self._stop.is_set():
                remaining = idle_until - time.monotonic()
                if remaining <= 0:
                    break
                self._not_empty.wait(timeout=min(0.1, remaining))
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
        copied without waiting.  Under the rank protocol a width other than
        the index's raises here, before the batch's header goes out."""
        batch = arrs[0] if len(arrs) == 1 else np.concatenate(arrs, axis=0)
        d = batch.shape[1]
        if self._d is not None and d != self._d:
            raise ValueError(f"a query of width {d}; the index's rows have {self._d}")
        host = torch.zeros((dispatch_b, d), dtype=torch.float32, pin_memory=self._cuda)
        norms = np.maximum(np.linalg.norm(batch, axis=1, keepdims=True), 1e-12)
        np.divide(batch, norms, out=host.numpy()[: batch.shape[0]])
        if not self._cuda:
            return host
        return host.to(self.device, non_blocking=True)

    def _step(self, q: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """The mode's step on the device batch, without waiting for it."""
        if self.mode == "retrieval":
            return tuple(self.engine.retrieve_batch_device(q, top_k=self.top_k))
        return tuple(self.engine.query_batch_device(
            q, top_k=self.top_k, expansion_depth=self.expansion_depth,
        )[:7])

    def _send_header(self, op: int, size: int) -> None:
        header = torch.tensor([op, size, self._seq], dtype=torch.int64)
        dist.broadcast(header, src=0, group=self._ctrl)

    def _loop(self) -> None:
        """Dispatcher: batch requests and issue their steps without
        waiting for the device; under the rank protocol, send each batch to
        the other ranks first, an idle header while there is no work, and
        the stop at the end."""
        if self._cuda:
            torch.cuda.set_device(self._card)
        try:
            while not self._stop.is_set():
                arrs, futs = self._collect()
                if futs:
                    self._dispatch(arrs, futs)
                elif self._ctrl is not None:
                    self._send_header(_IDLE, 0)
            if self._ctrl is not None:
                self._send_header(_STOP, 0)
        except Exception as e:  # a collective failed: the protocol is over
            with self._lock:
                self._fatal = e
                self._stop.set()
            self._fail_queued(e)

    def _dispatch(self, arrs: List[np.ndarray], futs: List[SlotFuture]) -> None:
        n = len(futs)
        dispatch_b = next((s for s in self.batch_sizes if s >= n), self.batch_size)
        try:
            q = self._queries(arrs, dispatch_b)
        except Exception as e:  # found on the host: fails this batch alone
            _fail_all(futs, e)
            return
        # The send and the step both read q from this thread's stream (an
        # NCCL send makes it wait on NCCL's stream and keeps q until done),
        # so the allocator cannot hand q's memory out before both; the
        # resolver's copy stream reads only the outputs.
        try:
            if self._ctrl is not None:
                self._seq += 1
                self._send_header(_STEP, dispatch_b)
                dist.broadcast(q, src=0, group=self._world)
            out = self._step(q)
            done = None
            if self._cuda:
                done = torch.cuda.Event()
                done.record()
        except Exception as e:  # a failed step fails its requests
            _fail_all(futs, e)
            if self._ctrl is not None:  # ... and, after its header, the group
                raise
            return
        self.batches_dispatched += 1
        batch_res = _BatchResult(self.mode)
        for i, fut in enumerate(futs):
            fut._bind(batch_res, i)
        self._inflight.put((out, done, batch_res, futs))

    def _follow(self) -> None:
        """A follower's loop: receive each header and batch from rank 0 and
        run the same step, its outputs dropped, at most `pipeline_depth`
        steps in flight on the device; ends at rank 0's stop, or with the
        error that `shutdown` re-raises."""
        if self._cuda:
            torch.cuda.set_device(self._card)
        in_flight = collections.deque()
        try:
            while True:
                header = torch.empty(3, dtype=torch.int64)
                dist.broadcast(header, src=0, group=self._ctrl)
                op, size, seq = header.tolist()
                if op == _STOP:
                    return
                if op == _IDLE:
                    continue
                if seq != self._seq + 1:
                    raise RuntimeError(
                        f"rank {self._rank} expected batch {self._seq + 1} from rank 0, "
                        f"got {seq}"
                    )
                self._seq = seq
                q = torch.empty((size, self._d), dtype=torch.float32, device=self.device)
                dist.broadcast(q, src=0, group=self._world)
                if len(in_flight) == self.pipeline_depth:
                    in_flight.popleft().synchronize()
                self._step(q)
                self.batches_dispatched += 1
                if self._cuda:
                    in_flight.append(torch.cuda.Event())
                    in_flight[-1].record()
        except Exception as e:  # re-raised by shutdown
            self._fatal = e

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
        goes on; after a fatal step, fail them instead."""
        if self._cuda:
            torch.cuda.set_device(self._card)
        while not self._stop.is_set() or not self._inflight.empty():
            try:
                out, done, batch_res, futs = self._inflight.get(timeout=0.1)
            except queue.Empty:
                continue
            if self._fatal is not None:
                batch_res.exc = self._fatal
            else:
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

    def _fail_queued(self, exc: BaseException) -> None:
        """Fail every request still queued."""
        with self._lock:
            leftovers = [
                f for _, bfuts, off in self._blocks for f in bfuts[off:]
            ]
            self._blocks.clear()
            self._pending_n = 0
        _fail_all([f for f in leftovers if not f.done()], exc)

    def _close_group(self) -> None:
        """Destroy the rank protocol's gloo group (once)."""
        if self._ctrl is not None:
            dist.destroy_process_group(self._ctrl)
            self._ctrl = None

    def shutdown(self, timeout: Optional[float] = None) -> None:
        """Rank 0 (or an engine of one process): let in-flight batches
        drain for up to `timeout` seconds (None: 10), stop both threads
        (under the rank protocol the dispatcher sends the stop first), then
        fail every request still queued.  A follower: wait up to `timeout`
        seconds (None: the mesh's timeout, torch's default of 30 minutes
        without one) for rank 0's stop, or for its loop to end with an
        error, which is re-raised here; past the bound raise
        `TimeoutError` (the loop goes on, and a later call waits again).
        Under the rank protocol, the group of the headers is destroyed once
        this rank's thread has ended."""
        if self._rank != 0:
            self._thread.join(self._wait_s if timeout is None else timeout)
            if self._thread.is_alive():
                raise TimeoutError(
                    f"rank {self._rank}: rank 0 did not stop within the bound"
                )
            self._close_group()
            if self._fatal is not None:
                raise self._fatal
            return
        deadline = 10.0 if timeout is None else timeout
        t0 = time.time()
        while not self._inflight.empty() and time.time() - t0 < deadline:
            time.sleep(0.05)
        self._stop.set()
        with self._not_empty:
            self._not_empty.notify_all()
        self._thread.join(timeout=5)
        self._resolver.join(timeout=5)
        self._fail_queued(RuntimeError("executor shut down before request was served"))
        if not self._thread.is_alive():
            self._close_group()
