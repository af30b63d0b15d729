"""The rest of the PyTorch port's host API against the JAX package:
`DenseIndex` persistence, construction from a pickle and incremental
updates, and `QueryEngine.refresh_index`, `get_content_statistics`,
`suggest_queries`, `query_similar_products`, `_parse_product_node_text` and
`hybrid_search`.

  * A directory saved by either package loads in the other, bit-equal.
  * `refresh_index` after `append`: the port's `query_batch` equals the JAX
    engine's (Pallas in interpret mode) with exact indices, in the default,
    int8 and supertile modes, across a tile and supertile boundary, and a
    query equal to an appended row finds that row first.
  * The graph lookups on a small product graph whose texts the test writes
    ("Name | Category: X | Price: $Y"), with SAME_CATEGORY edges.

Scores within 1e-5 where f32 sums are taken in another order (1e-6 for
the host API's similarity scores); all else exact.
"""

import json
import pickle

import numpy as np
import pytest

from __graft_entry__ import _synthetic_setup
from hcrag_tpu.core.dense_index import DenseIndex as JaxDenseIndex
from hcrag_tpu.core.graph import CsrGraph as JaxCsrGraph
from hcrag_tpu.models.embedder import HashingEmbedder as JaxHashingEmbedder
from hcrag_tpu.query.engine import QueryEngine as JaxEngine
from hcrag_tpu_torch.core.dense_index import DenseIndex
from hcrag_tpu_torch.core.graph import CsrGraph
from hcrag_tpu_torch.core.types import edge_type_id
from hcrag_tpu_torch.models.embedder import HashingEmbedder
from hcrag_tpu_torch.query.engine import QueryEngine
from hcrag_tpu_torch.utils.synthetic import synthetic_setup

ARRAYS = ("emb", "type_ids", "entity_bits", "entity_counts", "graph_ids")


def _corpus(n=40, seed=0):
    """Texts with entities the extractor finds, and metadata of three
    content types (some database rows without a table name)."""
    rng = np.random.default_rng(seed)
    words = ["red", "mountain", "bike", "frame", "helmet", "Shimano", "brake", "HL Road",
             "manual", "guide", "carbon", "wheel"]
    texts = [" ".join(rng.choice(words, size=rng.integers(3, 9))) for _ in range(n)]
    types = ["database_table", "pdf_document", "json_table"]
    metadata = [{"id": f"row_{i}", "type": types[i % 3], "row_index": i}
                for i in range(n)]
    for i in range(0, n, 3):
        if i % 2:
            metadata[i]["table_name"] = "Product" if i % 4 else "Customer"
    emb = rng.standard_normal((n, 64)).astype(np.float32)
    return emb, metadata, texts


def _equal_indexes(a, b):
    for f in ARRAYS:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert a.metadata == b.metadata and a.texts == b.texts
    assert a.vocab.entity_to_id == b.vocab.entity_to_id
    assert a.generation_info == b.generation_info


def test_dense_index_directories_load_in_either_package(tmp_path):
    emb, metadata, texts = _corpus()
    info = {"model_name": "hashing", "n": 40}
    jidx = JaxDenseIndex.build(emb, metadata, texts, generation_info=info,
                               graph_ids=np.arange(40) % 7 - 1)
    tidx = DenseIndex.build(emb, metadata, texts, generation_info=info,
                            graph_ids=np.arange(40) % 7 - 1)
    _equal_indexes(tidx, jidx)
    jidx.save(tmp_path / "jax")
    tidx.save(tmp_path / "port")
    _equal_indexes(DenseIndex.load(tmp_path / "jax"), jidx)
    _equal_indexes(JaxDenseIndex.load(tmp_path / "port"), tidx)
    with open(tmp_path / "jax" / "index_meta.json") as a, \
            open(tmp_path / "port" / "index_meta.json") as b:
        assert json.load(a) == json.load(b)
    with np.load(tmp_path / "jax" / "dense_index.npz") as a, \
            np.load(tmp_path / "port" / "dense_index.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


def test_append_delete_mask_and_statistics_equal():
    emb, metadata, texts = _corpus()
    jidx = JaxDenseIndex.build(emb[:30], metadata[:30], texts[:30])
    tidx = DenseIndex.build(emb[:30], metadata[:30], texts[:30])
    for key in ({"id": "row_4"}, {"id": "row_35"}, {"id": None}, {}):
        assert tidx.row_of_metadata(key) == jidx.row_of_metadata(key)
    new_texts = texts[30:] + ["an unknownentity Zyx bike"]
    new_meta = metadata[30:] + [{"id": "row_4", "type": "pdf_document"}]
    new_emb = np.concatenate([emb[30:], emb[:1] * 3])
    jidx.append(new_emb, new_meta, new_texts, graph_ids=np.arange(11, dtype=np.int32))
    tidx.append(new_emb, new_meta, new_texts, graph_ids=np.arange(11, dtype=np.int32))
    _equal_indexes(tidx, jidx)
    assert tidx.n == 41
    for key in ({"id": "row_4"}, {"id": "row_35"}, {"id": "row_99"}):
        assert tidx.row_of_metadata(key) == jidx.row_of_metadata(key)
    np.testing.assert_array_equal(tidx.delete_rows([0, 5, 40]), jidx.delete_rows([0, 5, 40]))
    np.testing.assert_array_equal(tidx.delete_rows([]), jidx.delete_rows([]))
    pred = lambda m: m.get("table_name") == "Product"  # noqa: E731
    np.testing.assert_array_equal(tidx.mask_where(pred), jidx.mask_where(pred))
    assert tidx.content_statistics() == jidx.content_statistics()
    assert tidx.content_statistics()["content_types"]["pdf_document"] == 14
    with pytest.raises(ValueError, match="one entry per row"):
        tidx.append(new_emb, new_meta[:2], new_texts)


def test_from_reference_pickle_equals_jax(tmp_path):
    emb, metadata, texts = _corpus(seed=4)
    path = tmp_path / "embeddings.pkl"
    with open(path, "wb") as f:
        pickle.dump({"embeddings": [list(map(float, r)) for r in emb], "metadata": metadata,
                     "texts": texts, "generation_info": {"model_name": "all-MiniLM-L6-v2",
                                                         "dimension": 64}}, f)
    got = DenseIndex.from_reference_pickle(path, graph_ids=np.arange(40))
    _equal_indexes(got, JaxDenseIndex.from_reference_pickle(path, graph_ids=np.arange(40)))
    np.testing.assert_allclose(np.linalg.norm(got.emb, axis=1), 1.0, atol=1e-6)


# ---------------------------------------------------------------------------
# refresh_index
# ---------------------------------------------------------------------------
N0, N_NEW, D, B = 3000, 1500, 128, 64
REFRESH_MODES = {
    "f32": dict(),
    "int8_f32_rescore": dict(quantize_int8=True, int8_rescore=32, int8_f32_rescore=True),
    "super": dict(exact_rescore=32, pallas_super=4),
}


def _append_rows(index, rng_seed=9):
    rng = np.random.default_rng(rng_seed)
    emb = rng.standard_normal((N_NEW, D)).astype(np.float32)
    metadata = [{"id": f"new_{i}", "type": "database_table", "table_name": "Synthetic",
                 "row_index": N0 + i} for i in range(N_NEW)]
    texts = [f"appended row {i} e{i % 100}" for i in range(N_NEW)]
    index.append(emb, metadata, texts)
    return emb


@pytest.mark.parametrize("mode", list(REFRESH_MODES))
def test_refresh_index_after_append_equals_jax(mode):
    """The bank grows from 3000 to 4500 rows: past a 2048-row tile (4096 ->
    6144 padded rows) and, with supertiles, past the 4096-row supertile the
    small index resolved.  The engines answer before the append, then both
    append the same rows and refresh."""
    opts = dict(REFRESH_MODES[mode], ell_max_degree=8)
    (jidx, jg), (tidx, tg) = _synthetic_setup(N0, D), synthetic_setup(N0, D)
    use_pallas = {} if opts.get("quantize_int8") else dict(use_pallas=True)
    je = JaxEngine(jidx, jg, pallas_interpret=True, **use_pallas, **opts)
    te = QueryEngine(tidx, tg, device="cpu", **opts)
    rng = np.random.default_rng(3)
    q = rng.standard_normal((B, D)).astype(np.float32)
    before = te.query_batch(q, top_k=10)
    np.testing.assert_array_equal(before.top_indices, je.query_batch(q, top_k=10).top_indices)
    pad_before = te._n_bank

    new = _append_rows(jidx)
    assert np.array_equal(_append_rows(tidx), new)
    je.refresh_index()
    te.refresh_index()
    assert te._n_rows == N0 + N_NEW and te._n_bank % 2048 == 0 and te._n_bank > pad_before
    q[:8] = new[[0, 7, 100, 499, 500, 1000, 1234, 1499]]
    rj, rt = je.query_batch(q, top_k=10), te.query_batch(q, top_k=10)
    np.testing.assert_array_equal(rt.top_indices, rj.top_indices)
    np.testing.assert_array_equal(rt.expanded_nodes, rj.expanded_nodes)
    for f in ("top_scores", "relevance", "combined", "expanded_relevance"):
        np.testing.assert_allclose(getattr(rt, f), getattr(rj, f), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(rt.top_indices[:8, 0],
                                  N0 + np.array([0, 7, 100, 499, 500, 1000, 1234, 1499]))
    assert te.get_content_statistics() == je.get_content_statistics()


# ---------------------------------------------------------------------------
# Graph-enriched lookups
# ---------------------------------------------------------------------------
def _product_setup(graph_cls, index_cls):
    """24 products in 4 categories (SAME_CATEGORY among each category's
    products, SIMILAR_PRICE between neighbours in id, COMPLEMENTARY_PRODUCT
    to its category's node), 3 documents (DESCRIBED_BY from every fourth
    product), and an index of the products' rows (every fifth
    without an entity id, product 23's row without a graph record) and the
    documents' rows."""
    cats = ["Mountain Bikes", "Road Bikes", "Helmets", "Gloves"]
    prices = [round(49.99 + 37.5 * ((7 * i) % 24), 2) for i in range(24)]
    labels, keys, texts = [], [], []
    for i in range(24):
        labels.append("Product")
        keys.append(700 + i)
        texts.append(f"Model {i} | Category: {cats[i % 4]} | Price: ${prices[i]} | Color: red")
    texts[5] = "Model 5 | Category: Road Bikes | Price: $n/a"
    for c in cats:
        labels.append("Category"), keys.append(c), texts.append(c)
    for name in ("Fork Manual", "Brake Guide", "Warranty"):
        labels.append("Document"), keys.append(name), texts.append(name)
    src, dst, ety = [], [], []
    for i in range(24):
        for j in range(i + 1, 24):
            if i % 4 == j % 4:
                src.append(i), dst.append(j), ety.append(edge_type_id("SAME_CATEGORY"))
        src.append(i), dst.append(24 + i % 4), ety.append(edge_type_id("COMPLEMENTARY_PRODUCT"))
        if i + 1 < 24:
            src.append(i), dst.append(i + 1), ety.append(edge_type_id("SIMILAR_PRICE"))
        if i % 4 == 0:
            src.append(i), dst.append(28 + i % 3), ety.append(edge_type_id("DESCRIBED_BY"))
    n_nodes = len(labels)
    node_to_row = np.full(n_nodes, -1, np.int32)
    node_to_row[:23] = np.arange(23)
    graph = graph_cls.from_edges(n_nodes, np.array(src), np.array(dst), np.array(ety),
                                 node_labels=labels, node_keys=keys, node_texts=texts,
                                 node_to_row=node_to_row)
    rows = texts[:24] + texts[28:]
    metadata = [{"id": f"p{i}", "type": "database_table", "table_name": "Product",
                 **({} if i % 5 == 0 else {"entity_id": str(700 + i)})} for i in range(24)]
    metadata += [{"id": f"d{i}", "type": "pdf_document"} for i in range(3)]
    graph_ids = np.array(list(range(23)) + [-1] + [28, 29, 30], np.int32)
    return graph, rows, metadata, graph_ids


@pytest.fixture(scope="module")
def product_engines():
    jg, rows, metadata, graph_ids = _product_setup(JaxCsrGraph, JaxDenseIndex)
    tg, _, _, _ = _product_setup(CsrGraph, DenseIndex)
    jemb, temb = JaxHashingEmbedder(dim=D).fit(rows), HashingEmbedder(dim=D).fit(rows)
    jidx = JaxDenseIndex.build(jemb.encode(rows), metadata, rows, graph_ids=graph_ids)
    tidx = DenseIndex.build(temb.encode(rows), metadata, rows, graph_ids=graph_ids)
    return (JaxEngine(jidx, jg, use_pallas=True, pallas_interpret=True, embedder=jemb),
            QueryEngine(tidx, tg, device="cpu", embedder=temb))


def test_suggest_queries_and_statistics_equal_jax(product_engines):
    je, te = product_engines
    for limit in (2, 5, 8, 20):
        assert te.suggest_queries(limit) == je.suggest_queries(limit)
    assert te.suggest_queries()[0] == "Find products similar to Model 0"
    assert te.get_content_statistics() == je.get_content_statistics()
    (jidx, _), (tidx, _) = _synthetic_setup(100, D), synthetic_setup(100, D)
    assert QueryEngine(tidx, device="cpu").suggest_queries() == \
        JaxEngine(jidx, use_pallas=True, pallas_interpret=True).suggest_queries()


def test_query_similar_products_equals_jax(product_engines):
    je, te = product_engines
    for pid in (700, "703", 705, 722, 9999, "Mountain Bikes"):
        for limit in (3, 10):
            got = te.query_similar_products(pid, limit=limit)
            assert got == je.query_similar_products(pid, limit=limit), pid
    assert [r["price"] for r in te.query_similar_products(701, limit=10)] == sorted(
        r["price"] for r in te.query_similar_products(701, limit=10))
    assert te.query_similar_products(701)[0]["relationship_type"] == "SAME_CATEGORY"


def test_parse_product_node_text_equals_jax(product_engines):
    je, te = product_engines
    for text in ("Model 1 | Category: Road Bikes | Price: $12.5 | Color: red",
                 "Model 5 | Category: Road Bikes | Price: $n/a", "Bare name",
                 "X | Price: $3"):
        assert te._parse_product_node_text(text) == je._parse_product_node_text(text)


def _without_scores(items):
    return [{k: v for k, v in r.items() if k != "similarity_score"} for r in items]


def test_hybrid_search_equals_jax(product_engines):
    je, te = product_engines
    seen = 0
    for term in ("Model 4 Mountain Bikes", "road bikes red", "Helmets price", "Warranty"):
        for limit in (2, 5):
            got, want = te.hybrid_search(term, limit=limit), je.hybrid_search(term, limit=limit)
            assert _without_scores(got) == _without_scores(want), term
            np.testing.assert_allclose([r["similarity_score"] for r in got],
                                       [r["similarity_score"] for r in want], atol=1e-6)
            seen += sum(bool(r["related_products"]) for r in got)
    assert seen > 0
