"""The sharded engine of the PyTorch port against the JAX package's.

The JAX side runs on the conftest's virtual CPU devices, over a mesh of the
first 4 (`make_row_mesh(4)`); the port's side runs 4 gloo ranks, spawned
once for the whole file (`tests/torch_sharded_workers.sharded_cases`), each
holding its block of rows.  The same shard count on both sides gives the
same padded bank and per-shard tiles.  JAX's engines run their Pallas
kernels in interpret mode, as its own sharded tests do; its Pallas route
refuses k > 128 a tile, so the top_k = 200 case runs JAX without it (the
route past 128 candidates on both sides).  Indices exact and scores within
1e-5 unless a case says otherwise; every rank returns the same bits.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from __graft_entry__ import _synthetic_setup
from hcrag_tpu.ops.quantize import quantize_rows as jax_quantize_rows
from hcrag_tpu.parallel.mesh import _auto_axis_types
from hcrag_tpu.parallel.mesh import make_row_mesh as jax_row_mesh
from hcrag_tpu.parallel.sharded_engine import ShardedQueryEngine as JaxSharded
from hcrag_tpu.parallel.sharded_ops import pad_rows as jax_pad_rows
from hcrag_tpu.parallel.sharded_ops import sharded_row_gather as jax_row_gather
from hcrag_tpu.parallel.sharded_ops import sharded_top_k as jax_top_k
from hcrag_tpu.pipeline.scorer_designs import (
    canonical_dynamic_weight_tensor as jax_dynamic_weights,
)
from hcrag_tpu_torch.parallel.launch import run_ranks
from hcrag_tpu_torch.parallel.sharded_ops import pad_rows
from hcrag_tpu_torch.query.engine import QueryEngine
from tests import torch_sharded_workers as W

jnp = jax.numpy


@pytest.fixture(scope="module")
def ranks():
    return run_ranks(W.sharded_cases, W.SHARDS)


@pytest.fixture(scope="module")
def jax_mesh():
    return jax_row_mesh(W.SHARDS)


def _same_bits(a, b, where=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _same_bits(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same_bits(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b), where
    else:
        assert a == b, where


def test_every_rank_returns_the_same_bits(ranks):
    for r in range(1, W.SHARDS):
        _same_bits(ranks[r], ranks[0], f"rank {r}")


# ---------------------------------------------------------------------------
# sharded_top_k, sharded_row_gather, pad_rows
# ---------------------------------------------------------------------------
def _jax_case(case, mesh):
    x = W.topk_inputs()
    emb = x["emb"]
    if case == "plain":
        return jax_top_k(mesh, x["q"], jnp.asarray(emb), 10)
    if case == "tied":
        return jax_top_k(mesh, x["tied_q"], jnp.asarray(x["tied_emb"]), 20)
    if case == "mask":
        return jax_top_k(mesh, x["mask_emb"][:1], jnp.asarray(x["mask_emb"]), 5,
                         jnp.asarray(x["mask"]))
    bf = jnp.asarray(emb).astype(jnp.bfloat16)
    if case == "rescore_key":
        return jax_top_k(mesh, x["rq"], None, 10,
                         banks={"emb": bf, "emb_f32": jnp.asarray(emb)},
                         fetch_k=32, rescore_key="emb_f32")
    if case == "rescore_rows":
        q8, s8 = jax_quantize_rows(emb)
        return jax_top_k(
            mesh, x["rq"], None, 10,
            banks={"emb": bf, "e8": jnp.asarray(q8), "es": jnp.asarray(s8)},
            fetch_k=32,
            rescore_rows=lambda bl, ix: bl["e8"][ix].astype(jnp.float32)
            * bl["es"][ix][..., None])

    def two_then_fillers(q, bl, mask, k, m):
        s = jnp.dot(q, bl["emb"].T, precision=jax.lax.Precision.HIGHEST)
        v, i = jax.lax.top_k(s, 2)
        fill = max(k, m) - 2
        return (jnp.concatenate([v, jnp.full((q.shape[0], fill), -1e30)], 1),
                jnp.concatenate([i, jnp.full((q.shape[0], fill), -1, i.dtype)], 1))

    return jax_top_k(mesh, x["q"], jnp.asarray(emb), 10, local_select=two_then_fillers)


@pytest.mark.parametrize(
    "case", ["plain", "tied", "mask", "rescore_key", "rescore_rows", "fillers"]
)
def test_sharded_top_k_equals_jax(case, ranks, jax_mesh):
    """4,096 x 64 rows over 4 shards, B = 4, k = 10; all-tied rows (k =
    20, across the first shard boundary); a mask; a bf16 selection with
    fetch_k = 32 and the f32 rescore by key, and by a callable (the int8
    reconstruction); a local selection that returns 2 candidates and
    (-1e30, -1) fillers, so 2 fillers reach the result."""
    tv, ti = ranks[0]["topk"][case]
    jv, ji = (np.asarray(a) for a in _jax_case(case, jax_mesh))
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tv, jv, atol=1e-5, rtol=0)


def test_ties_resolve_to_the_lowest_global_index(ranks):
    _, ti = ranks[0]["topk"]["tied"]
    assert ti[0].tolist() == list(range(20))  # rows 0-15 on shard 0, 16-19 on 1


def test_fillers_stay_fillers(ranks):
    tv, ti = ranks[0]["topk"]["fillers"]
    assert (ti[:, :8] >= 0).all() and (ti[:, 8:] == -1).all()
    assert (tv[:, 8:] == np.float32(-1e30)).all()


def test_ragged_batch_over_the_batch_axis(ranks):
    """3 queries over a batch axis of 2 (slices of 2 and 1, the second
    padded) and 2 row shards: every rank returns the 3 queries' top-k,
    equal to the 1-D mesh's."""
    tv, ti = ranks[0]["topk"]["ragged_batch"]
    pv, pi = ranks[0]["topk"]["plain"]
    np.testing.assert_array_equal(ti, pi[:3])
    np.testing.assert_allclose(tv, pv[:3], atol=1e-6, rtol=0)


def test_sharded_row_gather_equals_jax(ranks, jax_mesh):
    x = W.topk_inputs()
    got = ranks[0]["topk"]["gather"]
    want = np.asarray(jax_row_gather(jax_mesh, jnp.asarray(x["table"]),
                                     jnp.asarray(x["gather_idx"])))
    np.testing.assert_array_equal(got, want)
    assert (got[1, 2] == 0).all()  # id -1: a zero row


@pytest.mark.parametrize("n,multiple,pad_value", [(10, 8, 0), (16, 8, 0), (9, 4, -1)])
def test_pad_rows_equals_jax(n, multiple, pad_value):
    arr = np.arange(n * 3, dtype=np.int32).reshape(n, 3)
    got, got_n = pad_rows(arr, multiple, pad_value)
    want, want_n = jax_pad_rows(arr, multiple, pad_value)
    np.testing.assert_array_equal(got, want)
    assert got_n == want_n == n


def test_collective_traffic(ranks):
    """One rescored call at b = 8, k = 10, m = 32 over s = 4 ranks: the
    candidates' all-gathers carry s * b * m * (4 + 4) bytes, the rescore's
    one all-reduce b * m * 4 (the scores, not the rows), and nothing else
    crosses ranks."""
    b, m, s = 8, 32, W.SHARDS
    assert ranks[0]["topk"]["traffic"] == [
        ("all_gather", s * b * m * 4), ("all_gather", s * b * m * 4),
        ("all_reduce", b * m * 4),
    ]


# ---------------------------------------------------------------------------
# ShardedQueryEngine
# ---------------------------------------------------------------------------
def _jax_index(n_rows=W.ENGINE_ROWS):
    index, graph = _synthetic_setup(n_rows, W.ENGINE_DIM, graph_degree=4)
    meta = [dict(m, type="json_table" if r % 3 == 0 else "database_table")
            for r, m in enumerate(index.metadata)]
    return dataclasses.replace(index, metadata=meta), graph


def _jax_opts(mode, opts):
    opts = dict(opts)
    if mode == "top_k_200":
        return opts
    if not opts.get("quantize_int8"):
        opts["use_pallas"] = True
    opts["pallas_interpret"] = True
    return opts


def _jax_query_kwargs(qopts):
    kw = dict(qopts)
    if kw.pop("dynamic", False):
        kw["dynamic_weight_tensor"] = jax_dynamic_weights()
    return kw


def _assert_same_result(got, want, exact=False):
    for f in ("top_indices", "expanded_nodes", "expanded_counts"):
        np.testing.assert_array_equal(got[f], np.asarray(want[f]), err_msg=f)
    for f in ("top_scores", "relevance", "combined", "expanded_relevance"):
        if exact:
            np.testing.assert_array_equal(got[f], np.asarray(want[f]), err_msg=f)
        else:
            np.testing.assert_allclose(got[f], np.asarray(want[f]), atol=1e-5, rtol=0,
                                       err_msg=f)


@pytest.mark.parametrize("mode", list(W.ENGINE_MODES))
def test_engine_equals_jax(mode, ranks, jax_mesh):
    """Every field of `QueryBatchResult` against JAX's sharded engine at the
    same shard count (the batch mesh: 2 x 2 on both sides)."""
    opts, qopts, b = W.ENGINE_MODES[mode]
    mesh = jax_mesh
    if opts.get("shard_queries"):
        mesh = jax.make_mesh((2, 2), ("batch", "rows"), devices=jax.devices()[:4],
                             axis_types=_auto_axis_types(2))
    index, graph = _jax_index()
    engine = JaxSharded(index, graph, mesh=mesh, ell_max_degree=8, **_jax_opts(mode, opts))
    want = engine.query_batch(W.engine_queries(b), **_jax_query_kwargs(qopts))
    _assert_same_result(ranks[0]["engine"][mode], W.result_arrays(want))


@pytest.mark.parametrize("mode", list(W.ENGINE_MODES))
def test_engine_equals_unsharded(mode, ranks):
    """Against the port's unsharded engine (JAX's sharded and unsharded
    engines agree in every one of these modes): the same bits, but for the
    batch mesh, whose ranks select for 4 of the 8 queries: the CPU's plain
    B4 then sums its dots in another order (scores within 1e-5)."""
    opts, qopts, b = W.ENGINE_MODES[mode]
    opts = {k: v for k, v in opts.items() if k not in ("shard_graph", "shard_queries")}
    index, graph = W.index_and_graph()
    engine = QueryEngine(index, graph, device="cpu", ell_max_degree=8, **opts)
    want = engine.query_batch(W.engine_queries(b), **W.query_kwargs(qopts))
    _assert_same_result(ranks[0]["engine"][mode], W.result_arrays(want),
                        exact=mode != "batch_mesh")


def test_graph_split_equals_graph_whole(ranks):
    got = ranks[0]["engine"]
    _same_bits(got["graph_split_depth2"], got["graph_whole_depth2"])


def test_int8_f32_rescore_is_ignored_as_in_jax(ranks, jax_mesh):
    """JAX's sharded engine builds no f32 rows in int8 mode, so with
    `int8_f32_rescore` it rescores from the bf16 rows, and still reports an
    f32 rescore bank.  The port keeps that: at 6,000 rows over 4 shards,
    8 queries, top_k = 10, its sharded engine equals JAX's and the unsharded engine
    without the flag, and differs from the unsharded engine with it."""
    got = ranks[0]["engine"]["quirk"]
    assert ranks[0]["engine"]["quirk_report"] == "f32"
    q = W.engine_queries(W.ENGINE_B)
    jidx, jg = _jax_index(W.QUIRK_ROWS)
    jax_engine = JaxSharded(jidx, jg, mesh=jax_mesh, ell_max_degree=8,
                            pallas_interpret=True, **W.QUIRK_OPTS)
    _assert_same_result(got, W.result_arrays(jax_engine.query_batch(q, top_k=10)))
    index, graph = W.index_and_graph(W.QUIRK_ROWS)
    no_flag = dict(W.QUIRK_OPTS, int8_f32_rescore=False)
    without = QueryEngine(index, graph, device="cpu", ell_max_degree=8, **no_flag)
    _assert_same_result(got, W.result_arrays(without.query_batch(q, top_k=10)), exact=True)
    with_flag = QueryEngine(index, graph, device="cpu", ell_max_degree=8, **W.QUIRK_OPTS)
    other = with_flag.query_batch(q, top_k=10)
    assert not np.array_equal(got["top_scores"], other.top_scores)
    assert not np.array_equal(got["top_indices"], other.top_indices)
