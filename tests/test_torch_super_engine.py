"""The PyTorch port's QueryEngine with supertiles (`pallas_super`) against
the JAX QueryEngine on its Pallas route (interpret mode), in every rescored
mode, on the same seeded synthetic index and graph (n=20,000, d=128, B=64,
top_k=10, depth 1, graph degree 4).

B=64 is the smallest batch that takes supertiles.  The float path groups
1024-row tiles 8 at a time (8192-row supertiles), the int8 path 2048-row
tiles 4 at a time; both banks are padded to 24,576 rows (three
supertiles).  Tolerances: indices and expansion exact; scores, relevance
and combined within 1e-5 (f32 sums in another order).  The Pallas kernels
can drop a row that shares a 128-row lane with better ones (the port keeps
the exact per-supertile top-k); these seeded inputs hit no such drop."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from __graft_entry__ import _synthetic_setup
from hcrag_tpu.core.types import QueryIntent as JaxIntent
from hcrag_tpu.query.engine import QueryEngine as JaxEngine
from hcrag_tpu_torch.core.types import QueryIntent
from hcrag_tpu_torch.query.engine import QueryEngine
from hcrag_tpu_torch.utils.synthetic import synthetic_setup

N, D, B, K = 20_000, 128, 64, 10
MODES = {
    "exact_rescore": dict(exact_rescore=32, pallas_super=8),
    "int8_f32_rescore": dict(quantize_int8=True, int8_rescore=32, int8_f32_rescore=True,
                             pallas_super=4),
    "int8_bf16_rescore": dict(quantize_int8=True, int8_rescore=32, pallas_super=4),
    "int8_residual": dict(quantize_int8=True, int8_residual=True, int8_rescore=32,
                          pallas_super=4),
}
KERNEL = {"exact_rescore": "float_packed_super_tile_topk_plain"}


@pytest.fixture(scope="module")
def setups():
    return _synthetic_setup(N, D, graph_degree=4), synthetic_setup(N, D, graph_degree=4)


def _engines(jax_setup, port_setup, opts):
    (jidx, jg), (tidx, tg) = jax_setup, port_setup
    use_pallas = {} if opts.get("quantize_int8") else dict(use_pallas=True)
    return (JaxEngine(jidx, jg, pallas_interpret=True, ell_max_degree=8, **use_pallas,
                      **opts),
            QueryEngine(tidx, tg, device="cpu", ell_max_degree=8, **opts))


def _step_inputs(b, seed=5):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, D)).astype(np.float32)
    ents = [[f"e{x}" for x in rng.integers(0, 128, size=3)] for _ in range(b)]
    ents[0] = []  # empty entity set: the 0.5 / 0.1 rule
    return (q, dict(entity_lists=ents, intents=[list(JaxIntent)[i % 5] for i in range(b)]),
            dict(entity_lists=ents, intents=[list(QueryIntent)[i % 5] for i in range(b)]))


def _assert_results_match(rt, rj):
    for field in ("top_indices", "expanded_nodes", "expanded_counts"):
        np.testing.assert_array_equal(getattr(rt, field), getattr(rj, field), err_msg=field)
    for field in ("top_scores", "relevance", "combined", "expanded_relevance"):
        np.testing.assert_allclose(getattr(rt, field), getattr(rj, field), atol=1e-5,
                                   rtol=0, err_msg=field)


@pytest.mark.parametrize("mode", list(MODES))
def test_super_mode_matches_jax_engine(setups, mode):
    je, te = _engines(*setups, MODES[mode])
    q, jkw, tkw = _step_inputs(B)
    rj = je.query_batch(q, top_k=K, expansion_depth=1, **jkw)
    rt = te.query_batch(q, top_k=K, expansion_depth=1, **tkw)
    _assert_results_match(rt, rj)
    # The retrieved set is the f32 brute-force top-k, but for a slot or
    # two (three from the bf16 copy, which cannot order f32 near-ties).
    emb = np.asarray(te.index.emb, np.float32)
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    brute = np.argsort(-(qn @ emb.T), axis=1, kind="stable")[:, :K]
    hits = sum(len(set(a) & set(b)) for a, b in zip(rt.top_indices.tolist(), brute.tolist()))
    assert hits >= B * K - (3 if mode == "int8_bf16_rescore" else 1)
    # What runs: the JAX report's tile and supertile factor, the port's
    # supertile kernel, 16 picks from each of 3 supertiles, the stable merge.
    jc, tc = je.resolved_kernel_config(B, K), te.resolved_kernel_config(B, K)
    for key in ("tile_n", "super_tiles", "merge_k", "rescore_oversample", "rescore_bank",
                "int8_residual"):
        assert tc[key] == jc[key], key
    assert tc["kernel"] == KERNEL.get(mode, "int8_super_tile_topk_plain")
    assert (tc["tile_k"], tc["merge"]) == (16, "stable_sort")
    # Bank shapes equal the JAX engine's (padded to whole supertiles).
    jb, tb = je._bank(), te._bank()
    assert set(jb) == set(tb)
    for key in tb:
        assert tuple(tb[key].shape) == tuple(jb[key].shape), key
    assert tb["type_ids"].shape[0] == N and (tb.get("emb_int8", tb.get("emb"))).shape[0] == 24_576


def test_small_batch_takes_no_supertiles(setups):
    """Below 64 queries the request is off: B5 over 2048-row tiles, over the
    bank still padded for supertiles, as in the JAX engine."""
    je, te = _engines(*setups, MODES["exact_rescore"])
    q, jkw, tkw = _step_inputs(8)
    _assert_results_match(te.query_batch(q, top_k=K, **tkw), je.query_batch(q, top_k=K, **jkw))
    c = te.resolved_kernel_config(8, K)
    assert (c["super_tiles"], c["tile_n"], c["kernel"]) == (1, 2048,
                                                            "float_packed_tile_topk_plain")
    assert je.resolved_kernel_config(8, K)["super_tiles"] == 1


def test_super_report_follows_the_kernel_on_a_small_index():
    """3,000 rows, `exact_rescore=32, pallas_super=4`: the bank is padded to
    4,096 rows, four 1024-row tiles, and the kernel runs one 4096-row
    supertile (16 picks raised to 32 to cover the rescore).  The JAX report
    clamps against the 3 tiles of the unpadded rows and says 2; the port's
    says what runs.  The results are equal."""
    n, opts = 3000, dict(exact_rescore=32, pallas_super=4)
    je, te = _engines(_synthetic_setup(n, D, graph_degree=4),
                      synthetic_setup(n, D, graph_degree=4), opts)
    q, jkw, tkw = _step_inputs(B, seed=6)
    _assert_results_match(te.query_batch(q, top_k=K, **tkw), je.query_batch(q, top_k=K, **jkw))
    assert je.resolved_kernel_config(B, K)["super_tiles"] == 2
    c = te.resolved_kernel_config(B, K)
    assert (c["super_tiles"], c["tile_n"], c["tile_k"]) == (4, 1024, 32)


def test_super_bf16_index_drops_the_rescore_keeps_the_padding(setups):
    """A bf16 host index has no f32 rescore source: `exact_rescore` drops to
    0 and B4 runs, over a bank padded for supertiles as the JAX engine's."""
    (jidx, jg), (tidx, tg) = setups
    emb16 = np.asarray(jnp.asarray(jidx.emb).astype(jnp.bfloat16))
    je, te = _engines((dataclasses.replace(jidx, emb=emb16), jg),
                      (dataclasses.replace(tidx, emb=emb16.copy()), tg),
                      MODES["exact_rescore"])
    q, jkw, tkw = _step_inputs(B, seed=7)
    _assert_results_match(te.query_batch(q, top_k=K, **tkw), je.query_batch(q, top_k=K, **jkw))
    assert te.exact_rescore == 0 and te.d_emb.shape[0] == 24_576
    assert te.resolved_kernel_config(B, K)["kernel"] == "float_tile_topk_plain"
