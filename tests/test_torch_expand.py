"""Expansion beyond one hop: the PyTorch port's `ops/expand.py` and the
query step at depth 2 and 3 against the JAX package, on the same seeded
synthetic graph (n=3000 nodes, degree 4, ELL tables of 8 neighbors: the
whitelisted table for the first hop, the ANNOTATION-only one after it).
Exact equality throughout; the step's scores within 1e-5 (f32 sums in
another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _synthetic_setup
from hcrag_tpu.core.types import EXPANSION_EDGE_TYPES
from hcrag_tpu.ops import expand as jexpand
from hcrag_tpu.query.engine import QueryEngine as JaxEngine
from hcrag_tpu_torch.ops import expand as texpand
from hcrag_tpu_torch.query.engine import QueryEngine
from hcrag_tpu_torch.utils.synthetic import synthetic_setup

N, D = 3000, 128


@pytest.fixture(scope="module")
def graphs():
    (_, jg), (_, tg) = _synthetic_setup(N, D, graph_degree=4), synthetic_setup(N, D, 4)
    nb = jg.to_ell(EXPANSION_EDGE_TYPES, 8).neighbors
    nb2 = jg.to_ell(("ANNOTATION",), 8).neighbors
    return jg, tg, nb, nb2


def _seeds(b, s, seed, sparse_row=False):
    rng = np.random.default_rng(seed)
    seeds = rng.integers(-1, N, size=(b, s)).astype(np.int32)
    if sparse_row:
        seeds[0, 1:] = -1  # one seed: 8 first-hop candidates, short of the cap
    return seeds


def _eq(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("depth,max_nodes,sparse_row", [
    (2, 20, False),   # every row reaches 20 at hop 1: the exit is taken
    (2, 20, True),    # row 0 holds at most 8 after hop 1: hop 2 runs
    (3, 20, True),
    (2, 100, False),  # 10 seeds x 8 = 80 < 100: no exit, hop 2 runs
    (3, 100, False),
    (3, 500, False),  # hop 3 runs too
])
def test_expand_batch_early_exit_deep_equal(graphs, depth, max_nodes, sparse_row):
    """Against JAX's early-exit expansion and the no-exit `expand_batch`."""
    _, _, nb, nb2 = graphs
    seeds = _seeds(6, 10, depth * max_nodes, sparse_row)
    args = dict(depth=depth, max_nodes=max_nodes)
    want = jexpand.expand_batch_early_exit(jnp.asarray(nb), jnp.asarray(seeds),
                                           hop2_neighbors=jnp.asarray(nb2), **args)
    got = texpand.expand_batch_early_exit(torch.from_numpy(nb), torch.from_numpy(seeds),
                                          hop2_neighbors=torch.from_numpy(nb2), **args)
    _eq(got, want)
    _eq(texpand.expand_batch(torch.from_numpy(nb), torch.from_numpy(seeds),
                             hop2_neighbors=torch.from_numpy(nb2), **args), want)
    if sparse_row:
        assert int(got[1][0]) > 8  # row 0 needed its second hop


@pytest.mark.parametrize("depth,exclude_seeds,hop2", [
    (1, False, True), (2, False, True), (3, True, True), (2, True, False),
])
def test_expand_k_hop_and_expand_batch_equal(graphs, depth, exclude_seeds, hop2):
    """One seed set through `expand_k_hop`, a batch through `expand_batch`
    (JAX: vmapped); with and without seed exclusion and the hop-2 table."""
    _, _, nb, nb2 = graphs
    seeds = _seeds(5, 12, depth + 10 * exclude_seeds)
    kw = dict(depth=depth, max_nodes=60, exclude_seeds=exclude_seeds)
    jt2 = jnp.asarray(nb2) if hop2 else None
    tt2 = torch.from_numpy(nb2) if hop2 else None
    want = jexpand.expand_k_hop(jnp.asarray(nb), jnp.asarray(seeds[0]),
                                hop2_neighbors=jt2, **kw)
    _eq(texpand.expand_k_hop(torch.from_numpy(nb), torch.from_numpy(seeds[0]),
                             hop2_neighbors=tt2, **kw), want)
    want = jexpand.expand_batch(jnp.asarray(nb), jnp.asarray(seeds), hop2_neighbors=jt2,
                                **kw)
    _eq(texpand.expand_batch(torch.from_numpy(nb), torch.from_numpy(seeds),
                             hop2_neighbors=tt2, **kw), want)


@pytest.mark.parametrize("b,c,exclude_seeds", [(64, 6000, False), (3, 58_400, True)])
def test_dedup_sort_lowering_equal(b, c, exclude_seeds):
    """Candidate lists past the pairwise budget (B * C^2 > 2^26) take the
    sort-based dedup: C=6000, and depth 3's C=58,400 at 100 seeds of
    degree 8, with seed exclusion.  Against JAX's sort-based lowering."""
    assert b * c * c > texpand.PAIRWISE_MAX_ELEMENTS
    rng = np.random.default_rng(c)
    num_nodes = c // 3  # many repeats
    cand = rng.integers(-1, num_nodes, size=(b, c)).astype(np.int32)
    seeds = rng.integers(-1, num_nodes, size=(b, 100)).astype(np.int32)
    want = jax.vmap(lambda x, s: jexpand.dedup_and_cap(x, num_nodes, 64, seeds=s,
                                                       exclude_seeds=exclude_seeds))(
        jnp.asarray(cand), jnp.asarray(seeds))
    got = texpand.dedup_and_cap(torch.from_numpy(cand), num_nodes, 64,
                                seeds=torch.from_numpy(seeds), exclude_seeds=exclude_seeds)
    _eq(got, want)
    # Both lowerings of the port agree on a slice small enough for either.
    small = torch.from_numpy(cand[:1, :2000])
    assert torch.equal(texpand._ordered_unique_mask(small, num_nodes),
                       texpand._ordered_unique_mask(small.expand(40, -1), num_nodes)[:1])


def test_neighbors_of_and_expansion_edges_host_equal(graphs):
    jg, tg, _, _ = graphs
    for node in (0, 17, N - 1):
        for a, b in zip(tg.neighbors_of(node), jg.neighbors_of(node)):
            np.testing.assert_array_equal(a, b)
    seeds = [5, -1, 300, 5, 2999, 1234]
    for whitelist, max_nodes in ((("ANNOTATION", "DESCRIBED_BY"), 20), (("ANNOTATION",), 3)):
        want = jexpand.expansion_edges_host(jg, seeds, whitelist=whitelist,
                                            max_nodes=max_nodes)
        got = texpand.expansion_edges_host(tg, seeds, whitelist=whitelist,
                                           max_nodes=max_nodes)
        assert got == want and len(got) > 0


# ---------------------------------------------------------------------------
# The step at depth 2 and 3
# ---------------------------------------------------------------------------
STEP_MODES = {
    "exact_rescore": dict(exact_rescore=32),
    "int8_f32_rescore": dict(quantize_int8=True, int8_rescore=32, int8_f32_rescore=True),
}


@pytest.mark.parametrize("mode,depth", [("exact_rescore", 2), ("int8_f32_rescore", 2),
                                        ("int8_f32_rescore", 3)])
def test_step_at_depth_matches_jax_engine(mode, depth):
    """top_k=10 seeds and max_expanded=100: every query needs its second
    hop (10 x 8 first-hop candidates < 100), over the ANNOTATION table."""
    opts = dict(ell_max_degree=8, **STEP_MODES[mode])
    jidx, jg = _synthetic_setup(N, D, graph_degree=4)
    tidx, tg = synthetic_setup(N, D, graph_degree=4)
    use_pallas = {} if opts.get("quantize_int8") else dict(use_pallas=True)
    je = JaxEngine(jidx, jg, pallas_interpret=True, **use_pallas, **opts)
    te = QueryEngine(tidx, tg, device="cpu", **opts)
    q = np.random.default_rng(depth).standard_normal((8, D)).astype(np.float32)
    kw = dict(top_k=10, expansion_depth=depth, max_expanded=100)
    rj, rt = je.query_batch(q, **kw), te.query_batch(q, **kw)
    for field in ("top_indices", "expanded_nodes", "expanded_counts"):
        np.testing.assert_array_equal(getattr(rt, field), getattr(rj, field), err_msg=field)
    for field in ("top_scores", "relevance", "combined", "expanded_relevance"):
        np.testing.assert_allclose(getattr(rt, field), getattr(rj, field), atol=1e-5,
                                   rtol=0, err_msg=field)
    assert (rt.expanded_counts > 80).all()
    one_hop = te.query_batch(q, top_k=10, expansion_depth=1, max_expanded=100)
    assert (one_hop.expanded_counts <= 80).all()
