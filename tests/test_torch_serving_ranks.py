"""`BatchedExecutor` of the PyTorch port over a sharded engine of several
ranks (the rank protocol of `hcrag_tpu_torch/query/executor.py`), on gloo
ranks spawned on the CPU by `parallel/launch.run_ranks`, whose rank
functions live in `tests/torch_sharded_workers.py`.

  * 4 ranks against the JAX package: JAX's `BatchedExecutor` over JAX's
    `ShardedQueryEngine` on 4 of the virtual CPU devices (Pallas in
    interpret mode) and the port's, on the same 16 requests by one
    `submit_many`, batch 8, in the f32 and int8 + rescore modes, retrieval
    and full: indices exact, scores within 1e-5.
  * 2 and 4 ranks against the port's unsharded engine: 64 requests in
    blocks and 24 single requests from 4 client threads, batch 16, sizes
    4 / 8 / 16, in five modes; full mode over the split graph at depths 1
    and 3 (2 ranks); the 2 x 2 (batch, rows) mesh with a ragged last batch
    (4 ranks).  Indices exact, scores within 1e-6 (the batch mesh 1e-5).
  * Every rank steps every batch, in sequence; a follower's `submit`
    raises; constructor arguments that differ on one rank raise the same
    `ValueError` on every rank; a request of another width fails its batch
    on rank 0 alone; a shutdown with requests queued fails them and ends
    every follower; a follower's shutdown past its bound raises; every
    executor's group is destroyed.
  * 3 ranks with a 10 s group timeout: rank 1's step raises at its third
    batch and rank 1 keeps its connections open; rank 0 fails that batch
    and every later request, later submits raise, each follower's
    `shutdown` re-raises its loop's error, and every rank returns within
    the timeout plus 30 s.
  * The engine's host API across 2 ranks (`process_query`,
    `search_by_category`, `hybrid_search`, `find_similar_content`,
    `query_batch(rerank=True)`, `refresh_index` after `DenseIndex.append`)
    equals the unsharded engine's, in three modes.
"""

import numpy as np
import pytest

from hcrag_tpu.parallel.mesh import make_row_mesh as jax_row_mesh
from hcrag_tpu.parallel.sharded_engine import ShardedQueryEngine as JaxSharded
from hcrag_tpu.query.executor import BatchedExecutor as JaxExecutor
from hcrag_tpu_torch.parallel.launch import run_ranks
from hcrag_tpu_torch.query.engine import QueryEngine
from tests import torch_sharded_workers as W
from tests.test_torch_sharded import _jax_index, _jax_opts

SPAWN_S = 300  # the most one spawn may take
INT_FIELDS = ("top_indices", "expanded_nodes", "expanded_counts")


@pytest.fixture(scope="module")
def four():
    return run_ranks(W.serving_cases, 4, timeout_s=SPAWN_S)


@pytest.fixture(scope="module")
def two():
    return run_ranks(W.host_api_cases, 2, timeout_s=SPAWN_S)


@pytest.fixture(scope="module")
def failure():
    return run_ranks(W.failure_case, 3, timeout_s=SPAWN_S)


@pytest.fixture(scope="module")
def serving(four, two):
    """world -> each rank's serving cases."""
    return {4: four, 2: [r["serving"] for r in two]}


@pytest.fixture(scope="module")
def unsharded():
    """mode -> the port's unsharded engine over the same rows (lazily)."""
    index, graph = W.index_and_graph()
    engines = {}

    def get(mode):
        if mode not in engines:
            engines[mode] = QueryEngine(index, graph, device="cpu", ell_max_degree=8,
                                        **W.ENGINE_MODES[mode][0])
        return engines[mode]

    return get


def _close(got, want, atol):
    """Integer fields exact, the others within `atol`, over the fields
    `got` holds."""
    for f, v in got.items():
        w = np.asarray(want[f])
        if f in INT_FIELDS:
            np.testing.assert_array_equal(v, w, err_msg=f)
        else:
            np.testing.assert_allclose(v, w, atol=atol, rtol=0, err_msg=f)


def _cases(out):
    """Every served case (output, batches, sequence) of a rank's dict."""
    if isinstance(out, tuple) and len(out) == 3 and isinstance(out[1], int):
        yield out
    elif isinstance(out, dict):
        for v in out.values():
            yield from _cases(v)


# ---------------------------------------------------------------------------
# Results
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["retrieval", "full"])
@pytest.mark.parametrize("mode", W.JAX_SERVE_MODES)
def test_executor_equals_jax(mode, kind, four):
    opts = W.ENGINE_MODES[mode][0]
    index, graph = _jax_index()
    engine = JaxSharded(index, graph, mesh=jax_row_mesh(W.SHARDS), ell_max_degree=8,
                        **_jax_opts(mode, opts))
    ex = JaxExecutor(engine, batch_size=8, top_k=10, max_wait_ms=50, mode=kind)
    try:
        want = [f.result(timeout=W.SERVE_WAIT) for f in ex.submit_many(W.engine_queries(16))]
    finally:
        ex.shutdown()
    got, batches, _ = four[0]["jax"][mode, kind]
    assert batches == ex.batches_dispatched == 2
    _close(got, W.served_arrays([tuple(np.asarray(a) for a in r) if kind == "retrieval"
                                 else r for r in want]), atol=1e-5)


@pytest.mark.parametrize("mode", W.SERVE_MODES)
@pytest.mark.parametrize("world", [2, 4])
def test_served_equals_unsharded(world, mode, serving, unsharded):
    got, _, _ = serving[world][0]["traffic"][mode]
    want = unsharded(mode).query_batch(W.serve_queries(), top_k=10)
    _close(got, W.result_arrays(want), atol=1e-6)


@pytest.mark.parametrize("depth", W.GRAPH_DEPTHS)
def test_full_mode_over_the_split_graph_equals_unsharded(depth, serving, unsharded):
    got, _, _ = serving[2][0]["graph"][depth]
    want = unsharded("f32").query_batch(W.serve_queries(), top_k=10, expansion_depth=depth)
    _close(got, W.result_arrays(want), atol=1e-6)


def test_batch_mesh_with_a_ragged_batch(serving, unsharded):
    """19 requests over the 2 x 2 mesh: batches of 8, 8 and 3 (slices of 2
    and 1 over the batch axis); the batch groups select for their slices,
    so the CPU's plain B4 sums dots in another order (1e-5)."""
    got, batches, _ = serving[4][0]["batch_mesh"]
    q = W.serve_queries()[:W.BATCH_MESH_REQUESTS]
    want = unsharded("f32").query_batch(q, top_k=W.BATCH_MESH_KW["top_k"])
    assert batches == 3
    _close(got, W.result_arrays(want), atol=1e-5)


# ---------------------------------------------------------------------------
# The protocol
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("world", [2, 4])
def test_every_rank_steps_every_batch_in_sequence(world, serving):
    cases = [list(_cases(r)) for r in serving[world]]
    assert len(cases[0]) >= len(W.SERVE_MODES)
    for r in range(world):
        assert len(cases[r]) == len(cases[0])
        for (_, batches, seq), (_, batches0, _) in zip(cases[r], cases[0]):
            assert batches == batches0 and seq == batches


def test_follower_submit_raises(four):
    assert four[0]["follower_submit"][0] is None
    for r in range(1, W.SHARDS):
        assert "requests go to rank 0" in four[r]["follower_submit"][0]


def test_arguments_that_differ_raise_on_every_rank(four):
    messages = [r["mismatch"] for r in four]
    assert messages[0] is not None and "rank(s) [3]" in messages[0]
    assert messages == [messages[0]] * W.SHARDS


def test_another_width_fails_its_batch_alone(four, unsharded):
    (err, got), batches, _ = four[0]["wrong_width"]
    assert f"width {W.ENGINE_DIM // 2}" in err
    assert batches == 1  # the failed batch never went out
    want = unsharded("f32").query_batch(W.serve_queries()[:8], top_k=10)
    _close(got, W.result_arrays(want), atol=1e-6)


def test_follower_shutdown_is_bounded(four):
    """Rank 0 serves past the followers' bound: each follower's shutdown
    raises `TimeoutError` at the bound, and a second one ends at the stop."""
    for r in range(1, W.SHARDS):
        (err, seconds), batches, _ = four[r]["bounded"]
        assert "did not stop within the bound" in err
        assert W.FOLLOWER_BOUND_S <= seconds < W.RANK0_SERVES_S
        assert batches == 0


@pytest.mark.parametrize("world", [2, 4])
def test_every_executor_destroys_its_group(world, serving):
    """The executors' gloo groups, the mismatched constructor's included,
    are gone after their shutdowns."""
    for r in serving[world]:
        assert r["groups"][0] == r["groups"][1]


def test_shutdown_fails_queued_requests(four):
    (outcome, served), batches, _ = four[0]["queued"]
    failed = [o for o in outcome if o is not None]
    assert failed and all("shut down" in o for o in failed)
    assert served == len(outcome) - len(failed) == 8 * batches


# ---------------------------------------------------------------------------
# A step that raises on rank 1
# ---------------------------------------------------------------------------
def test_failure_serves_the_batches_before_it(failure, unsharded):
    want = unsharded("f32").query_batch(W.serve_queries()[:16], top_k=10)
    _close(failure[0]["served"], W.result_arrays(want), atol=1e-6)
    assert [r["batches"] for r in failure] == [W.FAIL_AT - 1] * 3


def test_failure_fails_that_batch_and_every_later_one(failure):
    later = failure[0]["later"]
    assert len(later) == 32 and all(o is not None for o in later)
    assert "failed across ranks" in failure[0]["submit"]
    assert failure[0]["shutdown"] is None


def test_failure_ends_every_follower_with_its_error(failure):
    assert "injected step failure" in failure[1]["shutdown"]
    assert failure[2]["shutdown"] is not None


def test_failure_frees_every_rank_within_the_timeout(failure):
    """Rank 1 keeps its connections for the timeout and 5 s more, so
    ranks 0 and 2 are freed by the timeout alone."""
    for r in failure:
        assert r["seconds"] < W.FAIL_TIMEOUT_S + 30
    for r in (0, 2):
        assert failure[r]["seconds"] >= W.FAIL_TIMEOUT_S


# ---------------------------------------------------------------------------
# The host API across 2 ranks
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def host_api_unsharded():
    out = {}
    for mode in W.HOST_API_MODES:
        index, graph = W.host_index_and_graph()
        engine = QueryEngine(index, graph, device="cpu", ell_max_degree=8,
                             **W.ENGINE_MODES[mode][0])
        out[mode] = W.host_api_calls(engine, index)
    return out


def _same(a, b, where=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _same(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, where


@pytest.mark.parametrize("call", ["process_query", "search_by_category", "hybrid_search",
                                  "find_similar_content", "rerank", "refresh"])
@pytest.mark.parametrize("mode", W.HOST_API_MODES)
def test_host_api_equals_unsharded(mode, call, two, host_api_unsharded):
    got = two[0]["host_api"][mode][call]
    assert got  # every call returns results
    _same(got, host_api_unsharded[mode][call], call)
    _same(two[1]["host_api"][mode][call], got, f"rank 1 {call}")
