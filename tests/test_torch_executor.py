"""`BatchedExecutor` of the PyTorch port on the CPU, against the port's own
engine and the JAX package's executor on the same queries.

The cases of the JAX package's executor tests
(`tests/integration/test_serving_and_extras.py`), over a synthetic index:
both modes (retrieval and full), `submit_many`, adaptive dispatch sizes,
the total batching deadline, the bulk drain, shutdown failing every queued
future, a failed dispatch failing its batch, and done callbacks.  Served
results equal the engine's `query_batch` on the same queries (indices
exact, scores within 1e-6 at the same batch size) and the JAX executor's
(indices exact, scores within 1e-5: f32 sums in another order; JAX with
Pallas in interpret mode).  Every `result()` has a timeout and every
executor is shut down in a `finally`, so no thread outlives its test.
"""

import threading
import time

import numpy as np
import pytest
import torch

from __graft_entry__ import _synthetic_setup
from hcrag_tpu.query.engine import QueryEngine as JaxEngine
from hcrag_tpu.query.executor import BatchedExecutor as JaxExecutor
from hcrag_tpu_torch.query.engine import QueryEngine
from hcrag_tpu_torch.query.executor import BatchedExecutor, ServedResult, SlotFuture
from hcrag_tpu_torch.utils.synthetic import synthetic_setup

N, D = 300, 128  # the JAX float kernel takes d % 128 == 0
WAIT = 60  # seconds any one future may take
MODES = {"f32": {}, "int8": dict(quantize_int8=True, int8_rescore=32, int8_f32_rescore=True)}


@pytest.fixture(scope="module")
def engines():
    jidx, jg = _synthetic_setup(N, D, graph_degree=4)
    tidx, tg = synthetic_setup(N, D, graph_degree=4)
    return {
        mode: (JaxEngine(jidx, jg, use_pallas=True, pallas_interpret=True,
                         ell_max_degree=8, **opts),
               QueryEngine(tidx, tg, device="cpu", ell_max_degree=8, **opts))
        for mode, opts in MODES.items()
    }


@pytest.fixture()
def engine(engines):
    return engines["int8"][1]


def _rows(engine, lo, hi):
    return np.asarray(engine.index.emb[lo:hi], np.float32)


def _serve(ex, embs, many=True):
    try:
        futs = ex.submit_many(embs) if many else [ex.submit(e) for e in embs]
        return [f.result(timeout=WAIT) for f in futs], futs
    finally:
        ex.shutdown()


def test_serves_all_requests(engine):
    ex = BatchedExecutor(engine, batch_size=8, top_k=5, max_wait_ms=5)
    results, _ = _serve(ex, _rows(engine, 0, 20), many=False)
    assert len(results) == 20
    for i, (scores, indices) in enumerate(results):
        assert indices[0] == i
        assert scores[0] == pytest.approx(1.0, abs=1e-4)
    assert ex.batches_dispatched >= 3


@pytest.mark.parametrize("mode", sorted(MODES))
def test_retrieval_mode_matches_engine_and_jax(engines, mode):
    je, te = engines[mode]
    q = np.random.default_rng(3).standard_normal((16, D)).astype(np.float32)
    ex = BatchedExecutor(te, batch_size=16, top_k=5, max_wait_ms=50)
    got, _ = _serve(ex, q)
    ref = te.query_batch(q, top_k=5)
    jex = JaxExecutor(je, batch_size=16, top_k=5, max_wait_ms=50)
    try:
        want = [f.result(timeout=WAIT) for f in jex.submit_many(q)]
    finally:
        jex.shutdown()
    for i, (scores, indices) in enumerate(got):
        np.testing.assert_array_equal(indices, ref.top_indices[i])
        np.testing.assert_allclose(scores, ref.top_scores[i], atol=1e-6, rtol=0)
        np.testing.assert_array_equal(indices, np.asarray(want[i][1]))
        np.testing.assert_allclose(scores, np.asarray(want[i][0]), atol=1e-5, rtol=0)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_full_mode_returns_complete_results(engines, mode):
    """mode='full' futures carry everything the step computed, equal to
    the engine's and the JAX executor's."""
    je, te = engines[mode]
    q = _rows(te, 0, 6)
    ex = BatchedExecutor(te, batch_size=8, top_k=5, max_wait_ms=50, mode="full")
    got, _ = _serve(ex, q, many=False)
    ref = te.query_batch(np.pad(q, ((0, 2), (0, 0))), top_k=5)
    jex = JaxExecutor(je, batch_size=8, top_k=5, max_wait_ms=50, mode="full")
    try:
        want = [f.result(timeout=WAIT) for f in jex.submit_many(q)]
    finally:
        jex.shutdown()
    for i, (r, w) in enumerate(zip(got, want)):
        assert isinstance(r, ServedResult)
        assert r.top_indices[0] == i
        assert r.relevance.shape == (5,) and r.combined.shape == (5,)
        assert (r.relevance >= 0).all() and r.expanded_count >= 0
        np.testing.assert_allclose(
            r.combined, 0.7 * r.relevance + 0.3 * r.top_scores, atol=1e-5)
        assert r.expanded_count == int(ref.expanded_counts[i]) == w.expanded_count
        for field, ref_field in (("top_indices", "top_indices"),
                                 ("expanded_nodes", "expanded_nodes")):
            np.testing.assert_array_equal(getattr(r, field), getattr(ref, ref_field)[i])
            np.testing.assert_array_equal(getattr(r, field), np.asarray(getattr(w, field)))
        for field, ref_field in (("top_scores", "top_scores"), ("relevance", "relevance"),
                                 ("combined", "combined"),
                                 ("expanded_relevance", "expanded_relevance")):
            np.testing.assert_allclose(getattr(r, field), getattr(ref, ref_field)[i],
                                       atol=1e-6, rtol=0)
            np.testing.assert_allclose(getattr(r, field), np.asarray(getattr(w, field)),
                                       atol=1e-5, rtol=0)


def test_shutdown_idempotent(engine):
    ex = BatchedExecutor(engine, batch_size=4)
    ex.shutdown()
    ex.shutdown()
    assert not ex._thread.is_alive() and not ex._resolver.is_alive()
    with pytest.raises(RuntimeError, match="shut down"):
        ex.submit(np.zeros(D, np.float32))


def test_partial_batch_ships_within_total_deadline(engine):
    """A batch is held open at most ~max_wait_ms from its first request,
    not max_wait_ms per empty slot."""
    ex = BatchedExecutor(engine, batch_size=64, top_k=5, max_wait_ms=50)
    try:
        ex.submit(_rows(engine, 0, 1)[0]).result(timeout=WAIT)
        t0 = time.monotonic()
        _, indices = ex.submit(_rows(engine, 1, 2)[0]).result(timeout=WAIT)
        latency = time.monotonic() - t0
    finally:
        ex.shutdown()
    assert indices[0] == 1
    assert latency < 1.5, f"partial batch held {latency:.2f}s"


def test_bulk_drain_fills_batches(engine):
    ex = BatchedExecutor(engine, batch_size=16, top_k=5, max_wait_ms=2)
    try:
        futs = [ex.submit(_rows(engine, i % 100, i % 100 + 1)[0]) for i in range(64)]
        for f in futs:
            f.result(timeout=WAIT)
    finally:
        ex.shutdown()
    assert ex.batches_dispatched <= 8


def test_submit_many_matches_engine(engine):
    ex = BatchedExecutor(engine, batch_size=8, top_k=5, max_wait_ms=5)
    results, futs = _serve(ex, _rows(engine, 0, 20))
    assert len(results) == 20
    for i, (scores, indices) in enumerate(results):
        assert indices[0] == i
        assert scores[0] == pytest.approx(1.0, abs=1e-4)
    assert all(f.resolve_time > 0 for f in futs)
    # One stamp per batch: at most as many distinct stamps as batches.
    assert len({f.resolve_time for f in futs}) <= ex.batches_dispatched


def test_adaptive_dispatch_sizes(engine):
    """A lone request ships in the smallest size, a backlog in the
    largest."""
    seen = []
    real = engine.retrieve_batch_device

    def spy(q, top_k):
        seen.append(q.shape[0])
        return real(q, top_k=top_k)

    engine.retrieve_batch_device = spy
    ex = BatchedExecutor(engine, batch_size=32, top_k=5, max_wait_ms=2, batch_sizes=(4, 32))
    try:
        _, i = ex.submit(_rows(engine, 0, 1)[0]).result(timeout=WAIT)
        assert i[0] == 0
        for f in ex.submit_many(_rows(engine, 0, 32)):
            f.result(timeout=WAIT)
    finally:
        ex.shutdown()
        del engine.retrieve_batch_device
    assert ex.batches_dispatched == 2 and ex.requests_served == 33
    assert seen == [4, 32]


class _StallEngine:
    """An engine whose dispatch blocks until released, then raises."""

    device = torch.device("cpu")

    def __init__(self):
        self.release = threading.Event()

    def retrieve_batch_device(self, batch, top_k):
        self.release.wait(5)
        raise RuntimeError("stalled")


def test_shutdown_fails_pending_futures():
    """Futures still queued at shutdown raise instead of hanging."""
    stall = _StallEngine()
    ex = BatchedExecutor(stall, batch_size=4, top_k=5, max_wait_ms=1)
    try:
        futs = [ex.submit(np.zeros(D, np.float32)) for _ in range(12)]
        stall.release.set()
    finally:
        ex.shutdown()
    n_failed = 0
    for f in futs:
        with pytest.raises((RuntimeError, TimeoutError)):
            f.result(timeout=5)
        n_failed += 1
    assert n_failed == len(futs) and all(f.done() for f in futs)


def test_failed_dispatch_fails_its_batch_and_fires_callbacks():
    stall = _StallEngine()
    stall.release.set()
    ex = BatchedExecutor(stall, batch_size=4, top_k=5, max_wait_ms=1)
    fired = []
    try:
        f = ex.submit(np.zeros(D, np.float32))
        f.add_done_callback(fired.append)
        with pytest.raises(RuntimeError, match="stalled"):
            f.result(timeout=WAIT)
    finally:
        ex.shutdown()
    assert len(fired) == 1 and fired[0] is f


def test_done_callback_after_resolution(engine):
    ex = BatchedExecutor(engine, batch_size=4, top_k=5, max_wait_ms=2)
    fired = []
    try:
        f = ex.submit(_rows(engine, 2, 3)[0])
        f.add_done_callback(lambda fut: fired.append(fut.resolve_time))
        f.result(timeout=WAIT)
    finally:
        ex.shutdown()
    f.add_done_callback(lambda fut: fired.append("late"))
    assert len(fired) == 2 and fired[1] == "late" and fired[0] == f.resolve_time


def test_unbound_future_times_out():
    f = SlotFuture()
    assert not f.done() and f.resolve_time == 0.0
    with pytest.raises(TimeoutError, match="never dispatched"):
        f.result(timeout=0.01)


def test_bad_mode_raises(engine):
    with pytest.raises(ValueError, match="mode"):
        BatchedExecutor(engine, mode="bulk")
