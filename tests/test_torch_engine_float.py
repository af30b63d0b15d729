"""The PyTorch port's float QueryEngine and its host API against the JAX
QueryEngine on its Pallas route (interpret mode), on the same seeded
synthetic index and graph (n=4096, d=128, B=8, top_k=10, depth 1, graph
degree 4).  Three residency modes:

  * f32: the default engine, kernel B4 over the f32 bank, no rescore;
  * rescore: `exact_rescore=32`, kernel B5 over a bf16 bank, then the f32
    rescore;
  * bf16: a bf16 host index, where `exact_rescore` drops to 0 and B4 runs
    over the bf16 bank.

Tolerances: indices and expansion are exact; scores, relevance and combined
agree to atol 1e-5 because the f32 dot products and metric sums are taken
in another order."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _synthetic_setup
from hcrag_tpu.core.dense_index import DenseIndex as JaxDenseIndex
from hcrag_tpu.core.types import QueryIntent as JaxIntent
from hcrag_tpu.core.types import ScorerType as JaxScorer
from hcrag_tpu.ingest.entities import infer_query_intent as jax_intent
from hcrag_tpu.models.embedder import HashingEmbedder as JaxHashingEmbedder
from hcrag_tpu.query.engine import QueryEngine as JaxEngine
from hcrag_tpu_torch.convert import bank_from_numpy
from hcrag_tpu_torch.core.dense_index import DenseIndex
from hcrag_tpu_torch.core.types import QueryIntent, ScorerType
from hcrag_tpu_torch.ingest.entities import infer_query_intent
from hcrag_tpu_torch.models.embedder import HashingEmbedder, embedder_from_index
from hcrag_tpu_torch.query.engine import QueryEngine
from hcrag_tpu_torch.utils.synthetic import synthetic_setup

N, D, B, K = 4096, 128, 8, 10
MODES = {
    "f32": dict(),
    "rescore": dict(exact_rescore=32),
    "bf16": dict(exact_rescore=32),
}


def _setups(mode):
    jidx, jg = _synthetic_setup(N, D, graph_degree=4)
    tidx, tg = synthetic_setup(N, D, graph_degree=4)
    if mode == "bf16":
        emb = np.asarray(jnp.asarray(jidx.emb).astype(jnp.bfloat16))
        jidx = dataclasses.replace(jidx, emb=emb)
        tidx = dataclasses.replace(tidx, emb=emb.copy())
    return (jidx, jg), (tidx, tg)


@pytest.fixture(scope="module")
def engines():
    out = {}
    for mode, opts in MODES.items():
        (jidx, jg), (tidx, tg) = _setups(mode)
        out[mode] = (
            JaxEngine(jidx, jg, use_pallas=True, pallas_interpret=True,
                      ell_max_degree=8, **opts),
            QueryEngine(tidx, tg, device="cpu", ell_max_degree=8, **opts),
        )
    return out


def _queries(seed=5):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, D)).astype(np.float32)
    ents = [[f"e{x}" for x in rng.integers(0, 128, size=3)] + ["not_in_vocab"]
            for _ in range(B)]
    ents[0] = []  # empty entity set: the 0.5 / 0.1 rule
    dyn = rng.random((4, 5, 6)).astype(np.float32)
    return q, ents, dyn


def _case(name):
    q, ents, dyn = _queries()
    if name == "plain":
        return q, {}, {}
    if name == "entities_intents":
        return (
            q,
            dict(entity_lists=ents, intents=[list(JaxIntent)[i % 5] for i in range(B)]),
            dict(entity_lists=ents, intents=[list(QueryIntent)[i % 5] for i in range(B)]),
        )
    if name == "dynamic_weights":
        return (
            q,
            dict(entity_lists=ents, dynamic_weight_tensor=dyn),
            dict(entity_lists=ents, dynamic_weight_tensor=dyn),
        )
    if name == "parallel_scorer":
        return q, dict(scorer_type=JaxScorer.PARALLEL), dict(scorer_type=ScorerType.PARALLEL)
    raise KeyError(name)


def _assert_results_equal(rt, rj):
    for field in ("top_indices", "expanded_nodes", "expanded_counts"):
        np.testing.assert_array_equal(getattr(rt, field), getattr(rj, field), err_msg=field)
    for field in ("top_scores", "relevance", "combined", "expanded_relevance"):
        np.testing.assert_allclose(
            getattr(rt, field), getattr(rj, field), atol=1e-5, rtol=0, err_msg=field
        )


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize(
    "case", ["plain", "entities_intents", "dynamic_weights", "parallel_scorer"]
)
def test_step_matches_jax_engine(engines, mode, case):
    je, te = engines[mode]
    q, jkw, tkw = _case(case)
    rj = je.query_batch(q, top_k=K, expansion_depth=1, **jkw)
    rt = te.query_batch(q, top_k=K, expansion_depth=1, **tkw)
    _assert_results_equal(rt, rj)
    # The retrieved set is the brute-force top-k of the bank's own values.
    emb = np.asarray(te.index.emb, np.float32)
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    if mode == "bf16":
        qn = np.asarray(jnp.asarray(qn).astype(jnp.bfloat16), np.float32)
    for b in range(B):
        brute = np.argsort(-(emb @ qn[b]), kind="stable")[:K]
        assert set(rt.top_indices[b].tolist()) == set(brute.tolist())


def test_modes_resolve_as_jax(engines):
    """The bf16 host index drops the rescore (no f32 source), as in JAX;
    the selection banks and kernels are the ones each mode names."""
    want = {
        "f32": ("float_tile_topk_plain", "float32", 0, False),
        "rescore": ("float_packed_tile_topk_plain", "bfloat16", 32, True),
        "bf16": ("float_tile_topk_plain", "bfloat16", 0, False),
    }
    for mode, (kernel, bank, m, packed) in want.items():
        je, te = engines[mode]
        c, cj = te.resolved_kernel_config(B, K), je.resolved_kernel_config(B, K)
        assert te.exact_rescore == je.exact_rescore == m, mode
        assert (c["kernel"], c["select_bank"], c["packed_select"]) == (kernel, bank, packed)
        for key in ("select_bank", "rescore_bank", "rescore_oversample", "merge_k",
                    "packed_select", "tile_n"):
            assert c[key] == cj[key], (mode, key)
        assert c["two_level"] is False and c["lane_t"] == 0
    # 2 tiles x 10 < 32: each tile picks 16, merged by the stable sort.
    c = engines["rescore"][1].resolved_kernel_config(B, K)
    assert c["tile_k"] == 16 and c["merge"] == "stable_sort"


def test_float_bank_carries_over_from_jax(engines):
    """`bank_from_numpy` takes the JAX engine's float banks (bf16 `emb` and
    f32 `emb_f32`) with the same bits as the port's own."""
    je, te = engines["rescore"]
    jb = {k: np.asarray(v) for k, v in je._bank().items()
          if k in ("emb", "emb_f32", "type_ids")}
    got = bank_from_numpy(jb, device="cpu")
    tb = te._bank()
    assert got["emb"].dtype == torch.bfloat16
    for key in jb:
        assert torch.equal(got[key].view(torch.int16) if key == "emb" else got[key],
                           tb[key].view(torch.int16) if key == "emb" else tb[key]), key


@pytest.mark.parametrize("mode", ["f32", "rescore"])
def test_category_filter_with_too_few_rows_matches_jax(engines, mode):
    """A filter that leaves 9 rows for top_k=10.  f32: the last slot is
    (-1e30, 0), the exact kernel's repeated pick of tile 0's first row;
    rescore: a packed filler (-1e30, -1).  Either way it equals JAX."""
    je, te = engines[mode]
    q, ents, _ = _queries(seed=9)
    types = [(m, m["type"]) for e in (je, te) for m in e.index.metadata]
    try:
        for e in (je, te):
            for r, m in enumerate(e.index.metadata):
                m["type"] = "json_table" if r % 500 == 0 else "database_table"
        rj = je.query_batch(q, top_k=K, category_filter="json_table", entity_lists=ents)
        rt = te.query_batch(q, top_k=K, category_filter="json_table", entity_lists=ents)
    finally:
        for m, t in types:
            m["type"] = t
    assert (rt.top_indices[:, :-1] % 500 == 0).all()
    assert (rt.top_indices[:, -1] == (0 if mode == "f32" else -1)).all()
    for field in ("top_indices", "expanded_nodes", "expanded_counts"):
        np.testing.assert_array_equal(getattr(rt, field), getattr(rj, field), err_msg=field)
    real = rt.top_scores > -1e29
    assert (real[:, :-1]).all() and not real[:, -1].any()
    for field in ("top_scores", "relevance", "combined"):
        a, b = getattr(rt, field), getattr(rj, field)
        np.testing.assert_allclose(a[real], b[real], atol=1e-5, rtol=0, err_msg=field)
        assert (a[~real] < -1e29).all() and (b[~real] < -1e29).all(), field
    np.testing.assert_allclose(rt.expanded_relevance, rj.expanded_relevance,
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("mode", ["f32", "rescore"])
def test_retrieve_batch_device_equals_step_top(engines, mode):
    _, te = engines[mode]
    q, _, _ = _queries(seed=12)
    v, i = te.retrieve_batch_device(q, top_k=K)
    res = te.query_batch(q, top_k=K)
    np.testing.assert_array_equal(i.numpy(), res.top_indices)
    np.testing.assert_array_equal(v.numpy(), res.top_scores)


# ---------------------------------------------------------------------------
# Host API over a small text index with a fitted hashing embedder
# ---------------------------------------------------------------------------
_WORDS = ("red", "black", "blue", "mountain", "road", "bike", "frame", "helmet",
          "wheel", "tire", "brake", "saddle", "manual", "guide", "large", "small")


def _corpus(n=50, seed=0):
    rng = np.random.default_rng(seed)
    texts = [" ".join(rng.choice(_WORDS, size=rng.integers(3, 8))) for _ in range(n)]
    metadata = [
        {"id": f"row_{i}", "type": ("pdf_document" if i % 4 == 0 else "database_table"),
         "table_name": "Product"}
        for i in range(n)
    ]
    return texts, metadata


@pytest.fixture(scope="module")
def text_engines():
    texts, metadata = _corpus()
    jemb = JaxHashingEmbedder(dim=D).fit(texts)
    temb = HashingEmbedder(dim=D).fit(texts)
    info = {"embedder_state": temb.state_dict()}
    jidx = JaxDenseIndex.build(jemb.encode(texts), metadata, texts,
                               generation_info={"embedder_state": jemb.state_dict()})
    tidx = DenseIndex.build(temb.encode(texts), metadata, texts, generation_info=info)
    return (JaxEngine(jidx, use_pallas=True, pallas_interpret=True),
            QueryEngine(tidx, device="cpu"))


QUERIES = ("red mountain bike", "find a black helmet", "road bike brake manual",
           "compare large wheel vs small tire")


def test_find_similar_content_matches_jax(text_engines):
    je, te = text_engines
    for text in QUERIES:
        emb = te.embedder.encode([text])[0]
        rj = je.find_similar_content(emb, top_k=5, similarity_threshold=0.2)
        rt = te.find_similar_content(emb, top_k=5, similarity_threshold=0.2)
        assert [(r["content"], r["metadata"]) for r in rt] == \
            [(r["content"], r["metadata"]) for r in rj]
        np.testing.assert_allclose([r["similarity_score"] for r in rt],
                                   [r["similarity_score"] for r in rj], atol=1e-6)


def test_process_query_matches_jax(text_engines):
    je, te = text_engines
    found = 0
    for text in QUERIES:
        oj, ot = je.process_query(text), te.process_query(text)
        assert set(ot) == set(oj) == {"parsed_query", "search_text", "results",
                                      "summary", "query_embedding"}
        for key in ("parsed_query", "search_text", "summary"):
            assert ot[key] == oj[key], key
        np.testing.assert_allclose(ot["query_embedding"], oj["query_embedding"], atol=1e-6)
        assert [r["content"] for r in ot["results"]] == [r["content"] for r in oj["results"]]
        found += len(ot["results"])
    assert found > 0


def test_search_by_category_matches_jax(text_engines):
    je, te = text_engines
    for text in QUERIES:
        for category in ("pdf_document", None, "json_table"):
            oj = je.search_by_category(text, category_filter=category, top_k=5)
            ot = te.search_by_category(text, category_filter=category, top_k=5)
            assert ot["summary"] == oj["summary"]
            assert [(r["rank"], r["content"], r["metadata"]) for r in ot["results"]] == \
                [(r["rank"], r["content"], r["metadata"]) for r in oj["results"]]
            np.testing.assert_allclose([r["similarity_score"] for r in ot["results"]],
                                       [r["similarity_score"] for r in oj["results"]],
                                       atol=1e-6)
            if category:
                assert all(r["metadata"]["type"] == category for r in ot["results"])


def test_create_query_input_and_intents(text_engines):
    je, te = text_engines
    for text in QUERIES + ("need help to fix", "spec details", "the user guide", "hello"):
        assert infer_query_intent(text).name == jax_intent(text).name
        qi, qj = te.create_query_input(text), je.create_query_input(text)
        assert (qi.text, qi.entities, qi.intent.name) == (qj.text, qj.entities, qj.intent.name)
        np.testing.assert_allclose(qi.embeddings, qj.embeddings, atol=1e-6)


def test_hashing_embedder_matches_jax():
    texts, _ = _corpus(seed=3)
    je, te = JaxHashingEmbedder(dim=D), HashingEmbedder(dim=D)
    np.testing.assert_allclose(te.encode(texts), je.encode(texts), atol=1e-6)
    je.fit(texts)
    te.fit(texts)
    np.testing.assert_array_equal(te.bucket_df, je.bucket_df)
    assert te.n_docs == je.n_docs
    np.testing.assert_allclose(te.encode(texts), je.encode(texts), atol=1e-6)
    back = HashingEmbedder.from_state(te.state_dict())
    assert back.state_dict() == te.state_dict() == je.state_dict()
    np.testing.assert_array_equal(back.encode(texts), te.encode(texts))


def test_embedder_from_index_refuses_minilm_and_confidence_raises():
    """Both once raised, before the MiniLM encoder and the encoder
    confidence were ported; now they answer as the JAX package does: an
    index of MiniLM vectors whose width the distilled encoder does not have
    gets the hashing embedder, and `with_confidence=True` adds the
    confidence of whatever embedder the engine has."""
    from hcrag_tpu.models.embedder import embedder_from_index as jax_embedder_from_index

    (jidx, jg), (index, graph) = _synthetic_setup(256, D), synthetic_setup(256, D)
    for idx in (jidx, index):
        idx.generation_info["model_name"] = "all-MiniLM-L6-v2"
    got = embedder_from_index(index, device="cpu")
    assert type(got).__name__ == type(jax_embedder_from_index(jidx)).__name__ \
        == "HashingEmbedder"
    engine = QueryEngine(index, graph, device="cpu", embedder=HashingEmbedder(D))
    jengine = JaxEngine(jidx, jg, use_pallas=True, pallas_interpret=True,
                        embedder=JaxHashingEmbedder(D))
    ot = engine.process_query("red bike", with_confidence=True)
    oj = jengine.process_query("red bike", with_confidence=True)
    assert ot["encoder_confidence"].keys() == oj["encoder_confidence"].keys()
    for k, v in oj["encoder_confidence"].items():
        assert abs(ot["encoder_confidence"][k] - v) <= 1e-6, k
    assert "encoder_confidence" not in engine.process_query("red bike")


# ---------------------------------------------------------------------------
# Robustness contracts of the default engine
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def small_default():
    index, graph = synthetic_setup(300, D)
    return QueryEngine(index, graph, device="cpu"), index


def test_zero_vector_query(small_default):
    engine, _ = small_default
    res = engine.query_batch(np.zeros(D, np.float32), top_k=3)
    assert res.top_indices[0].tolist() == [0, 1, 2]


def test_top_k_equal_to_index_returns_all_rows():
    index, graph = synthetic_setup(100, D)
    res = QueryEngine(index, graph, device="cpu").query_batch(
        np.asarray(index.emb[0], np.float32), top_k=100
    )
    assert sorted(res.top_indices[0].tolist()) == list(range(100))


def test_empty_entity_query(small_default):
    engine, index = small_default
    res = engine.query_batch(np.asarray(index.emb[0], np.float32), top_k=5,
                             entity_lists=[[]])
    assert res.top_indices.shape == (1, 5)


def test_top_k_above_128_raises(small_default):
    """top_k = 300 over 300 rows, which the kernels' per-tile lists cannot
    hold, no longer raises: it takes the JAX engine's route off the TPU
    (`masked_top_k`) and returns the JAX engine's answer (the reference
    contract, `tests/e2e/test_failure_injection.py:123-127`)."""
    engine, index = small_default
    jidx, jg = _synthetic_setup(300, D)
    q = np.asarray(index.emb[0], np.float32)
    rj = JaxEngine(jidx, jg).query_batch(q, top_k=300)
    rt = engine.query_batch(q, top_k=300)
    assert rt.top_indices.shape == (1, 300) and rt.top_indices[0, 0] == 0
    _assert_results_equal(rt, rj)
