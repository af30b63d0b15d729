"""The property graph and path extraction of the port against the JAX
package's, and the six small gaps of the already-ported modules.

Over a seeded AdventureWorks-shaped corpus: each extractor's triples per
row, every extraction mode's store (nodes, triples, statistics), the
store's `to_csr`, `build_graph_index` (index arrays bit for bit, CSR
arrays equal) and an engine over it; `PropertyGraphStore` and `CsrGraph`
directories saved by either package load in the other.  Then
`EllAdjacency.max_degree`, `edge_type_mask`, `EntityVocab.entities`,
`synthetic_ell` and the `TextEmbedder` protocol against JAX's."""

import numpy as np
import pytest

from hcrag_tpu.core import graph as jgraph
from hcrag_tpu.core import property_graph as jpg
from hcrag_tpu.core import types as jtypes
from hcrag_tpu.core import vocab as jvocab
from hcrag_tpu.ingest import adventureworks as jaw
from hcrag_tpu.ingest import path_extract as jpe
from hcrag_tpu.models import embedder as jemb
from hcrag_tpu.query.engine import QueryEngine as JaxEngine
from hcrag_tpu.utils import synthetic as jsyn
from hcrag_tpu_torch.core import graph as tgraph
from hcrag_tpu_torch.core import property_graph as tpg
from hcrag_tpu_torch.core import types as ttypes
from hcrag_tpu_torch.core import vocab as tvocab
from hcrag_tpu_torch.ingest import adventureworks as taw
from hcrag_tpu_torch.ingest import path_extract as tpe
from hcrag_tpu_torch.models import embedder as temb
from hcrag_tpu_torch.query.engine import QueryEngine
from hcrag_tpu_torch.testing import write_adventureworks_corpus
from hcrag_tpu_torch.utils import synthetic as tsyn

MODES = ["auto", "simple", "dynamic", "implicit", "nonsense"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_adventureworks_corpus(tmp_path_factory.mktemp("pg") / "data", seed=2)


@pytest.fixture(scope="module")
def rows(corpus):
    return taw.process_corpus(corpus)


def _triples(ts):
    return [(t.subject, t.predicate, t.object, t.subject_type, t.object_type, t.source_id)
            for t in ts]


def _store(store):
    return ([(n.name, n.label, n.properties) for n in store.nodes()], store.triples(),
            store.statistics(), store.relation_types())


@pytest.mark.parametrize("kind", ["simple", "implicit"])
def test_extractor_triples_equal_jax(rows, kind):
    texts, meta = rows
    mine = tpe.SimplePathExtractor() if kind == "simple" else tpe.ImplicitPathExtractor()
    theirs = jpe.SimplePathExtractor() if kind == "simple" else jpe.ImplicitPathExtractor()
    for text, m in zip(texts, meta):
        assert _triples(mine.extract(text, m)) == _triples(theirs.extract(text, m))


def test_dynamic_schema_equals_jax(rows):
    texts, meta = rows
    mine, theirs = tpe.DynamicPathExtractor(), jpe.DynamicPathExtractor()
    assert mine.discover_schema(texts, meta) == theirs.discover_schema(texts, meta)
    for text, m in zip(texts[:80], meta[:80]):
        assert _triples(mine.extract(text, m)) == _triples(theirs.extract(text, m))


@pytest.mark.parametrize("mode", MODES)
def test_create_extractors_equals_jax(mode):
    names = lambda xs: [type(x).__name__ for x in xs]  # noqa: E731
    assert names(tpe.create_extractors(mode)) == names(jpe.create_extractors(mode))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("link", [False, True])
def test_builder_store_equals_jax(corpus, mode, link):
    mine = tpe.PropertyGraphBuilder(mode, link_sources=link)
    theirs = jpe.PropertyGraphBuilder(mode, link_sources=link)
    assert mine.extraction_mode == theirs.extraction_mode
    assert _store(mine.build(corpus)) == _store(theirs.build(corpus))


@pytest.mark.parametrize("exts", [["csv"], [".pdf", "json"]])
def test_builder_extension_filter_equals_jax(corpus, exts):
    mine = tpe.PropertyGraphBuilder("simple").build(corpus, file_extensions=exts)
    assert _store(mine) == _store(jpe.PropertyGraphBuilder("simple").build(
        corpus, file_extensions=exts))
    with pytest.raises(ValueError, match="No documents"):
        tpe.PropertyGraphBuilder("simple").build(corpus, file_extensions=["docx"])


def test_llm_response_models_have_jaxs_schemas():
    for name in ("ExtractedTriple", "TriplesResponse", "SchemaResponse"):
        assert getattr(tpe, name).model_json_schema() == getattr(jpe, name).model_json_schema()
    r = tpe.TriplesResponse.model_validate(
        {"triples": [{"subject": "a", "predicate": "has", "object": "b"}]})
    assert r.triples[0].object_type == "entity"
    with pytest.raises(ValueError):
        tpe.TriplesResponse.model_validate({"triples": [{"subject": "a"}]})


def _csr_equal(a, b):
    for f in ("row_ptr", "col_idx", "edge_type", "node_to_row"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert a.node_labels == b.node_labels and a.node_texts == b.node_texts
    assert [str(k) for k in a.node_keys] == [str(k) for k in b.node_keys]
    assert a.directed_counts == b.directed_counts
    assert a.edge_type_vocab == b.edge_type_vocab


@pytest.mark.parametrize("mode", ["auto", "implicit"])
def test_to_csr_equals_jax(corpus, mode):
    mine = tpe.PropertyGraphBuilder(mode).build(corpus)
    theirs = jpe.PropertyGraphBuilder(mode).build(corpus)
    (mc, mn), (tc, tn) = mine.to_csr(), theirs.to_csr()
    assert mn == tn
    _csr_equal(mc, tc)


def test_store_edge_cases_equal_jax():
    for pkg in (tpg, jpg):
        store = pkg.PropertyGraphStore()
        assert store.to_csr()[1] == ["RELATED_TO"]
        with pytest.raises(ValueError):
            store.upsert_node("   ")
    mine, theirs = tpg.PropertyGraphStore(), jpg.PropertyGraphStore()
    for s in (mine, theirs):
        s.upsert_node("Bike", "entity", {"a": 1})
        s.upsert_node("bike ", "product", {"a": 2, "b": 3})
        for i in range(130):  # past the relation cap: the tail collapses
            s.upsert_triple(_triple(s, f"n{i}", f"rel {i} x", "Bike"))
        s.upsert_triple(_triple(s, "a", "same", "A"))  # a self-loop is refused
    assert _store(mine) == _store(theirs)
    (mc, mn), (tc, tn) = mine.to_csr(), theirs.to_csr()
    assert mn == tn and "RELATED_TO" in mn
    _csr_equal(mc, tc)


def _triple(store, s, p, o):
    pkg = tpg if isinstance(store, tpg.PropertyGraphStore) else jpg
    return pkg.Triple(subject=s, predicate=p, object=o)


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_store_json_loads_across_packages(corpus, tmp_path, direction):
    src, dst = (tpg, jpg) if direction == "port_to_jax" else (jpg, tpg)
    pe = tpe if src is tpg else jpe
    store = pe.PropertyGraphBuilder("auto", link_sources=True).build(corpus)
    store.save(tmp_path / "pg" / "property_graph.json")
    loaded = dst.PropertyGraphStore.load(tmp_path / "pg" / "property_graph.json")
    assert _store(loaded) == _store(store)


def test_build_graph_index_equals_jax(corpus):
    mine = tpe.build_graph_index(tpe.PropertyGraphBuilder("auto").build(corpus))
    theirs = jpe.build_graph_index(jpe.PropertyGraphBuilder("auto").build(corpus))
    (mi, mc, mn), (ti, tc, tn) = mine, theirs
    assert mn == tn and mi.texts == ti.texts and mi.metadata == ti.metadata
    for f in ("emb", "entity_bits", "type_ids", "graph_ids"):
        assert np.array_equal(np.asarray(getattr(mi, f)), np.asarray(getattr(ti, f))), f
    _csr_equal(mc, tc)


def test_engine_over_extracted_graph_equals_jax(corpus):
    mi, mc, _ = tpe.build_graph_index(tpe.PropertyGraphBuilder("auto").build(corpus))
    ti, tc, _ = jpe.build_graph_index(jpe.PropertyGraphBuilder("auto").build(corpus))
    rows = np.random.default_rng(0).choice(mi.n, size=16, replace=False)
    q = np.asarray(mi.emb, np.float32)[rows]
    got = QueryEngine(mi, mc, device="cpu").query_batch(q, top_k=5, expansion_depth=2)
    want = JaxEngine(ti, tc).query_batch(q, top_k=5, expansion_depth=2)
    for f in ("top_indices", "expanded_nodes", "expanded_counts"):
        np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(want, f)), err_msg=f)
    for f in ("top_scores", "relevance", "combined", "expanded_relevance"):
        np.testing.assert_allclose(getattr(got, f), np.asarray(getattr(want, f)),
                                   atol=1e-5, rtol=0, err_msg=f)
    assert got.expanded_counts.any()


# --- the six gaps -------------------------------------------------------------

@pytest.fixture(scope="module")
def aw_graphs(corpus):
    return (jaw.build_graph(jaw.load_csv_data(corpus), jaw.analyze_ingested_documents(corpus)),
            taw.build_graph(taw.load_csv_data(corpus), taw.analyze_ingested_documents(corpus)))


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_csr_graph_directory_loads_across_packages(aw_graphs, tmp_path, direction):
    jg, tg = aw_graphs
    src, dst = (tg, jgraph.CsrGraph) if direction == "port_to_jax" else (jg, tgraph.CsrGraph)
    src.save(tmp_path)
    assert {p.name for p in tmp_path.iterdir()} == {"graph.npz", "graph_meta.json"}
    _csr_equal(dst.load(tmp_path), src)


def test_csr_graph_with_vocab_round_trips(corpus, tmp_path):
    csr, _ = tpe.PropertyGraphBuilder("implicit").build(corpus).to_csr()
    csr.save(tmp_path)
    _csr_equal(jgraph.CsrGraph.load(tmp_path), csr)
    _csr_equal(tgraph.CsrGraph.load(tmp_path), csr)


@pytest.mark.parametrize("whitelist,cap", [(None, None), (("ANNOTATION", "DESCRIBED_BY"), 8),
                                           (("SAME_CATEGORY",), 3)])
def test_ell_max_degree_equals_jax(aw_graphs, whitelist, cap):
    jg, tg = aw_graphs
    je, te = jg.to_ell(whitelist, max_degree=cap), tg.to_ell(whitelist, max_degree=cap)
    assert te.max_degree == je.max_degree
    assert np.array_equal(te.neighbors, je.neighbors)


@pytest.mark.parametrize("names", [(), ("ANNOTATION",), ("ANNOTATION", "DESCRIBED_BY"),
                                   tuple(jtypes.EDGE_TYPES)])
def test_edge_type_mask_equals_jax(names):
    assert ttypes.edge_type_mask(names) == jtypes.edge_type_mask(names)


def test_edge_type_mask_refuses_unknown_names():
    with pytest.raises(KeyError):
        ttypes.edge_type_mask(["NOT_A_TYPE"])


@pytest.mark.parametrize("seed", [0, 1])
def test_vocab_entities_equal_jax(seed):
    rng = np.random.default_rng(seed)
    lists = [[f"e{int(x)}" for x in rng.integers(0, 50, size=4)] for _ in range(30)]
    assert tvocab.EntityVocab.build(lists).entities() == \
        jvocab.EntityVocab.build(lists).entities()


@pytest.mark.parametrize("n,deg,seed", [(100, 4, 1), (7, 3, 5), (1000, 8, 0)])
def test_synthetic_ell_equals_jax(n, deg, seed):
    got = tsyn.synthetic_ell(n, deg, seed)
    assert got.dtype == np.int32
    assert np.array_equal(got, jsyn.synthetic_ell(n, deg, seed))
    assert not (got == np.arange(n)[:, None]).any()


def test_text_embedder_protocol_matches_jax():
    assert temb.TextEmbedder.__annotations__ == jemb.TextEmbedder.__annotations__
    assert "encode" in vars(temb.TextEmbedder)
    e = temb.default_embedder(32)
    assert e.dim == 32 and e.encode(["a b"]).shape == (1, 32)
