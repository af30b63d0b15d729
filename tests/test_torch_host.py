"""Host-side parity of the PyTorch port with the JAX package: synthetic
data, graph lowering, quantization, the engine bank, and the plain tensor
helpers of the query step.  Inputs come from numpy seeds and go through both
packages; exact equality unless a tolerance is stated."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _synthetic_setup
from hcrag_tpu.core.dense_index import DenseIndex as JaxDenseIndex
from hcrag_tpu.core.types import EXPANSION_EDGE_TYPES
from hcrag_tpu.ops import expand as jexpand
from hcrag_tpu.ops.quantize import quantize_queries as jax_quantize_queries
from hcrag_tpu.ops.quantize import quantize_rows as jax_quantize_rows
from hcrag_tpu.ops.scoring import combine_metrics_dynamic as jax_dynamic
from hcrag_tpu.ops.scoring import popcount_words as jax_popcount
from hcrag_tpu.query.engine import QueryEngine as JaxEngine
from hcrag_tpu_torch.convert import bank_from_numpy
from hcrag_tpu_torch.core.dense_index import DenseIndex
from hcrag_tpu_torch.ops import expand as texpand
from hcrag_tpu_torch.ops.quantize import quantize_queries, quantize_rows
from hcrag_tpu_torch.ops.scoring import combine_metrics_dynamic, popcount_words
from hcrag_tpu_torch.ops.similarity import l2_normalize, top_k
from hcrag_tpu_torch.query.engine import QueryEngine
from hcrag_tpu_torch.utils.synthetic import synthetic_setup

N, D = 3000, 128
MODE = dict(quantize_int8=True, int8_rescore=32, int8_f32_rescore=True,
            ell_max_degree=8)


@pytest.fixture(scope="module")
def setups():
    return _synthetic_setup(N, D, graph_degree=4), synthetic_setup(N, D, graph_degree=4)


def _bytes_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.mark.parametrize(
    "field", ["emb", "type_ids", "entity_bits", "entity_counts", "graph_ids"]
)
def test_synthetic_index_byte_equal(setups, field):
    (jidx, _), (tidx, _) = setups
    assert _bytes_equal(getattr(jidx, field), getattr(tidx, field))


def test_synthetic_index_host_side_equal(setups):
    (jidx, _), (tidx, _) = setups
    assert jidx.metadata == tidx.metadata and jidx.texts == tidx.texts
    assert jidx.vocab.entity_to_id == tidx.vocab.entity_to_id
    assert (jidx.n, jidx.dim) == (tidx.n, tidx.dim)
    assert _bytes_equal(jidx.type_mask("database_table"),
                        tidx.type_mask("database_table"))


@pytest.mark.parametrize("field", ["row_ptr", "col_idx", "edge_type", "node_to_row"])
def test_synthetic_graph_byte_equal(setups, field):
    (_, jg), (_, tg) = setups
    assert _bytes_equal(getattr(jg, field), getattr(tg, field))
    assert jg.directed_counts == tg.directed_counts


@pytest.mark.parametrize(
    "whitelist,max_degree",
    [(EXPANSION_EDGE_TYPES, 8), (("ANNOTATION",), 8), (None, None), (("ANNOTATION",), 2)],
)
def test_ell_tables_byte_equal(setups, whitelist, max_degree):
    (_, jg), (_, tg) = setups
    je, te = jg.to_ell(whitelist, max_degree), tg.to_ell(whitelist, max_degree)
    for field in ("neighbors", "etypes", "degrees"):
        assert _bytes_equal(getattr(je, field), getattr(te, field)), field


def test_dense_index_build_equal():
    rng = np.random.default_rng(4)
    emb = rng.standard_normal((6, 32)).astype(np.float32)
    meta = [{"type": "database_table", "table_name": "Product"},
            {"type": "pdf_document"}, {"type": "json_table"},
            {"type": "database_table", "table_name": "ProductCategory"},
            {"type": "other"}, {"type": "database_table", "table_name": "Spec"}]
    texts = ["Red mountain bike frame", "brake manual", "xl helmet",
             "road bike", "nothing matches here", "blue chain and pedal"]
    j = JaxDenseIndex.build(emb, meta, texts)
    t = DenseIndex.build(emb, meta, texts)
    for field in ("emb", "type_ids", "entity_bits", "entity_counts", "graph_ids"):
        assert _bytes_equal(getattr(j, field), getattr(t, field)), field
    assert j.vocab.entity_to_id == t.vocab.entity_to_id


def test_quantize_rows_byte_equal(setups):
    (jidx, _), _ = setups
    emb = np.concatenate([np.asarray(jidx.emb), np.zeros((5, D), np.float32)])
    for a, b in zip(jax_quantize_rows(emb), quantize_rows(emb)):
        assert _bytes_equal(a, b)


def test_quantize_queries_bit_equal():
    """Against the JAX quantizer as its engine runs it, under jit (where the
    scale is absmax * (1/127), not absmax / 127)."""
    rng = np.random.default_rng(11)
    q = rng.standard_normal((16, 384)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q[3] = 0.0  # zero query: scale 0, all-zero codes
    jq, js = jax.jit(jax_quantize_queries)(jnp.asarray(q))
    tq, ts = quantize_queries(torch.from_numpy(q))
    assert _bytes_equal(np.asarray(jq), tq.numpy())
    assert _bytes_equal(np.asarray(js), ts.numpy())


@pytest.mark.parametrize("n,super_tiles,rows", [(N, 0, 4096), (10_000, 4, 16_384)])
def test_bank_from_numpy_equals_port_bank(setups, n, super_tiles, rows):
    """The same keys, the second-hop table included, and the same tensors.
    Without supertiles the banks are padded to whole 2048-row tiles (10,000
    rows would take 10,240); with them, to whole 8192-row supertiles."""
    (jidx, jg), (tidx, tg) = (
        setups if n == N else (_synthetic_setup(n, D), synthetic_setup(n, D))
    )
    je = JaxEngine(jidx, jg, pallas_interpret=True, pallas_super=super_tiles, **MODE)
    te = QueryEngine(tidx, tg, device="cpu", pallas_super=super_tiles, **MODE)
    converted = bank_from_numpy(
        {k: np.asarray(v) for k, v in je._bank().items()}, device="cpu"
    )
    own = te._bank()
    assert set(converted) == set(own)
    assert own["emb_int8"].shape[0] == rows
    for key in own:
        a, b = converted[key], own[key]
        assert a.dtype == b.dtype and a.shape == b.shape, key
        if a.dtype == torch.bfloat16:
            a, b = a.view(torch.int16), b.view(torch.int16)
        assert torch.equal(a, b), key


def test_popcount_words_equal():
    rng = np.random.default_rng(2)
    bits = rng.integers(0, 2**32, size=(7, 5, 4), dtype=np.uint64).astype(np.uint32)
    bits[0, 0] = 0xFFFFFFFF
    bits[0, 1] = 0x80000000
    want = np.asarray(jax_popcount(jnp.asarray(bits)))
    got = popcount_words(torch.from_numpy(bits.view(np.int32))).numpy()
    np.testing.assert_array_equal(got, want)


def test_combine_metrics_dynamic_close():
    """Same weighted average; the sum order may differ (atol 1e-6)."""
    rng = np.random.default_rng(3)
    metrics = rng.random((6, 10, 4)).astype(np.float32)
    w = rng.random((4, 5, 6)).astype(np.float32)
    intents = rng.integers(0, 5, size=6).astype(np.int32)
    tids = rng.integers(0, 6, size=(6, 10)).astype(np.int32)
    want = np.asarray(jax_dynamic(jnp.asarray(metrics), jnp.asarray(w),
                                  jnp.asarray(intents)[:, None], jnp.asarray(tids)))
    got = combine_metrics_dynamic(torch.from_numpy(metrics), torch.from_numpy(w),
                                  torch.from_numpy(intents)[:, None],
                                  torch.from_numpy(tids)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("c,num_nodes", [(80, 1000), (5000, 100)])
def test_dedup_and_cap_equal(c, num_nodes):
    """The port's dedup against both JAX lowerings: pairwise at C=80
    (depth 1's candidate count), sort-based at C=5000 (the port's
    lowerings give one result; which runs depends on B * C^2)."""
    rng = np.random.default_rng(c)
    cand = rng.integers(-1, num_nodes, size=(4, c)).astype(np.int32)
    out, cnt = jax.vmap(lambda x: jexpand.dedup_and_cap(x, num_nodes, 20))(
        jnp.asarray(cand)
    )
    tout, tcnt = texpand.dedup_and_cap(torch.from_numpy(cand), num_nodes, 20)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(out))
    np.testing.assert_array_equal(tcnt.numpy(), np.asarray(cnt))


@pytest.mark.parametrize("depth,max_nodes", [(1, 20), (0, 20), (1, 5)])
def test_expand_batch_early_exit_equal(setups, depth, max_nodes):
    """One hop (depth 0 expands one hop too); max_nodes=5 caps every row."""
    (_, jg), _ = setups
    nb = jg.to_ell(EXPANSION_EDGE_TYPES, 8).neighbors
    nb2 = jg.to_ell(("ANNOTATION",), 8).neighbors
    rng = np.random.default_rng(depth + max_nodes)
    seeds = rng.integers(-1, N, size=(5, 10)).astype(np.int32)
    out, cnt = jexpand.expand_batch_early_exit(
        jnp.asarray(nb), jnp.asarray(seeds), depth=depth, max_nodes=max_nodes,
        hop2_neighbors=jnp.asarray(nb2),
    )
    tout, tcnt = texpand.expand_batch_early_exit(
        torch.from_numpy(nb), torch.from_numpy(seeds), depth=depth,
        max_nodes=max_nodes, hop2_neighbors=torch.from_numpy(nb2),
    )
    np.testing.assert_array_equal(tout.numpy(), np.asarray(out))
    np.testing.assert_array_equal(tcnt.numpy(), np.asarray(cnt))


def test_stable_top_k_ties_to_lowest_index():
    vals = torch.tensor([[0.5, 1.0, 1.0, 0.5, 1.0], [0.0] * 5])
    v, i = top_k(vals, 3)
    assert i.tolist() == [[1, 2, 4], [0, 1, 2]]
    assert v.tolist() == [[1.0, 1.0, 1.0], [0.0, 0.0, 0.0]]
    jv, ji = jax.lax.top_k(jnp.asarray(vals.numpy()), 3)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))


def test_l2_normalize_zero_row():
    x = torch.tensor([[3.0, 4.0], [0.0, 0.0]])
    np.testing.assert_allclose(l2_normalize(x).numpy(), [[0.6, 0.8], [0.0, 0.0]])
