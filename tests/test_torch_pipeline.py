"""The port's pipelines and query surfaces against the JAX package's, on the
CPU.

One synthetic index (300 rows, d = 128, a degree-4 graph) serves both
packages' default f32 engines (JAX with Pallas in interpret mode), each with
a `RowLookupEmbedder`: a row's own text encodes to the row's embedding, so
a question names the rows it should find.  The LLM client is offline and
`random_seed` fixed.

  * `RetrievalAgent`: step by step (state keys, sampled ids, semantic and
    final scores within 1e-5, decisions), then whole runs (node trace,
    answer, revision history).
  * `ImprovedRetrievalAgent`: its journal equal to JAX's, persisted and
    read back by a fresh `MemorySaver` (the resume), preferences, the
    review hook and streaming.
  * `EnhancedRAG`: the response (shape, context, scores within 1e-5) and its
    token budgeting; `GraphRelevanceScorer`; every `QueryInterface` mode and
    its failure shape; `graph_query`; `QueryParser`; the response models
    against pydantic's; `call_stream` against a local SSE endpoint.
  * `scorer_designs`: the JAX package's scorer-design and dynamic-weight
    cases, and the canonical dynamic weights through both engines.
  * `config`: the JAX defaults, setters and reset.
"""

import dataclasses
import http.server
import json
import random
import threading

import numpy as np
import pytest

from __graft_entry__ import _synthetic_setup
from hcrag_tpu import config as jcfg
from hcrag_tpu.core.types import QueryIntent as JaxIntent
from hcrag_tpu.core.types import ScorerType as JaxScorer
from hcrag_tpu.pipeline import agent as jagent
from hcrag_tpu.pipeline import enhanced as jenh
from hcrag_tpu.pipeline import improved_agent as jimp
from hcrag_tpu.pipeline import integration as jint
from hcrag_tpu.pipeline import llm as jllm
from hcrag_tpu.pipeline import parser as jparser
from hcrag_tpu.pipeline import scorer_designs as jsd
from hcrag_tpu.query import graph_query as jgq
from hcrag_tpu.query import interface as jiface
from hcrag_tpu.query.engine import QueryEngine as JaxEngine
from hcrag_tpu.testing import create_sample_nodes as jax_nodes
from hcrag_tpu.testing import create_sample_query as jax_query
from hcrag_tpu_torch import config as tcfg
from hcrag_tpu_torch.core.graph import CsrGraph
from hcrag_tpu_torch.core.types import QueryIntent, ScorerType, edge_type_id
from hcrag_tpu_torch.pipeline import agent as tagent
from hcrag_tpu_torch.pipeline import enhanced as tenh
from hcrag_tpu_torch.pipeline import improved_agent as timp
from hcrag_tpu_torch.pipeline import integration as tint
from hcrag_tpu_torch.pipeline import llm as tllm
from hcrag_tpu_torch.pipeline import parser as tparser
from hcrag_tpu_torch.pipeline import scorer_designs as tsd
from hcrag_tpu_torch.query import graph_query as tgq
from hcrag_tpu_torch.query import interface as tiface
from hcrag_tpu_torch.query.engine import QueryEngine
from hcrag_tpu_torch.testing import RowLookupEmbedder, create_sample_nodes, create_sample_query
from hcrag_tpu_torch.utils.synthetic import synthetic_setup

N, D = 300, 128  # the JAX float kernel takes d % 128 == 0
SEED = 42
TOL = dict(atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def engines():
    jidx, jg = _synthetic_setup(N, D, graph_degree=4)
    tidx, tg = synthetic_setup(N, D, graph_degree=4)
    return (JaxEngine(jidx, jg, use_pallas=True, pallas_interpret=True, ell_max_degree=8,
                      embedder=RowLookupEmbedder(jidx)),
            QueryEngine(tidx, tg, device="cpu", ell_max_degree=8,
                        embedder=RowLookupEmbedder(tidx)))


def _configs():
    jc, tc = jcfg.RuntimeConfig(), tcfg.RuntimeConfig()
    for c in (jc, tc):
        c.random_seed, c.llm_base_url = SEED, ""
    return jc, tc


def _agents(engines, cls_j=jagent.RetrievalAgent, cls_t=tagent.RetrievalAgent, **kw):
    jc, tc = _configs()
    je, te = engines
    return (cls_j(je, client=jllm.LLMClient(jc), config=jc, **kw.get("j", {})),
            cls_t(te, client=tllm.LLMClient(tc), config=tc, **kw.get("t", {})))


def _sampled(seed=SEED, n=N):
    rng = random.Random(seed)
    return [rng.randint(0, n - 1) for _ in range(20)]


def _questions():
    """Questions naming sampled rows (each passes the semantic gate on its
    own node), and one naming none."""
    ids = _sampled()
    return [f"synthetic row {ids[0]}", f"synthetic row {ids[7]}",
            "completely absurd query zzzxqwy"]


def _same_nodes(tn, jn):
    assert [n.text for n in tn] == [n.text for n in jn]
    assert [n.node_type for n in tn] == [n.node_type for n in jn]
    assert [n.entities for n in tn] == [n.entities for n in jn]
    assert [n.graph_relations for n in tn] == [n.graph_relations for n in jn]
    np.testing.assert_allclose([n.score for n in tn], [n.score for n in jn], **TOL)


# --- agents ------------------------------------------------------------------


@pytest.mark.parametrize("qi", range(3))
def test_agent_step_by_step(engines, qi):
    ja, ta = _agents(engines)
    question = _questions()[qi]
    js = {"question": question, "revision_history": []}
    ts = {"question": question, "revision_history": []}
    for step in ("analyze_query", "sample_nodes", "score_semantic_similarity",
                 "expand_subgraph", "score_all_nodes", "evaluate_context",
                 "generate_answer"):
        jd, td = getattr(ja, step)(js), getattr(ta, step)(ts)
        assert sorted(td) == sorted(jd), step
        js.update(jd)
        ts.update(td)
    jq, tq = js["query_input"], ts["query_input"]
    assert (tq.text, tq.entities, tq.intent.value) == (jq.text, jq.entities, jq.intent.value)
    np.testing.assert_allclose(tq.embeddings, jq.embeddings, atol=1e-7, rtol=0)
    assert ts["sampled_nodes"] == js["sampled_nodes"] == _sampled()
    for key in ("semantic_scored_nodes", "expanded_scored_nodes", "final_relevant_nodes"):
        _same_nodes(ts[key], js[key])
    assert ts["expanded_nodes"] == js["expanded_nodes"]
    assert ts["expanded_subgraph"] == js["expanded_subgraph"]
    assert ts["decision"] == js["decision"] == "sufficient"
    assert ts["final_answer"] == js["final_answer"]
    if qi < 2:  # the question's own node passed the gate and was scored
        assert ts["semantic_scored_nodes"] and ts["expanded_scored_nodes"]
        assert ts["final_relevant_nodes"][0].score > 0.4


def test_agent_runs_equal_jax(engines):
    ja, ta = _agents(engines)
    for question in _questions():
        rj, rt = ja.run(question), ta.run(question)
        assert rt.node_trace == rj.node_trace
        assert rt.node_trace[-1] == "generate_answer"
        assert (rt.question, rt.decision, rt.revision_history, rt.final_answer) == \
            (rj.question, rj.decision, rj.revision_history, rj.final_answer)
        _same_nodes(rt.final_relevant_nodes, rj.final_relevant_nodes)
        assert rt.expanded_nodes == rj.expanded_nodes and rt.encoder_confidence is None
    assert ta.client.offline and ta.client.failure_count == ja.client.failure_count
    assert ta.sample_nodes({}) == ta.sample_nodes({})  # seeded


def test_agent_scoring_failure_falls_back_to_semantic(engines, monkeypatch):
    """The reference's fallback when scoring fails: the top-5 semantic
    nodes, nothing expanded (kept from JAX)."""
    _, ta = _agents(engines)
    state = {"question": _questions()[0], "revision_history": []}
    for step in ("analyze_query", "sample_nodes", "score_semantic_similarity",
                 "expand_subgraph"):
        state.update(getattr(ta, step)(state))

    def boom(*a, **k):
        raise RuntimeError("scoring failed")

    monkeypatch.setattr(tagent, "batch_isRelevant", boom)
    out = ta.score_all_nodes(state)
    assert out["expanded_scored_nodes"] == []
    assert out["final_relevant_nodes"] == state["semantic_scored_nodes"][:5]


def test_improved_agent_journal_and_resume(engines, tmp_path):
    jsave = jimp.MemorySaver(persist_dir=str(tmp_path / "jax"))
    tsave = timp.MemorySaver(persist_dir=str(tmp_path / "port"))
    chunks = []
    ja, ta = _agents(engines, jimp.ImprovedRetrievalAgent, timp.ImprovedRetrievalAgent,
                     j=dict(checkpointer=jsave),
                     t=dict(checkpointer=tsave, stream_callback=chunks.append))
    question = _questions()[1]
    rj = ja.run(question, thread_id="t-1", user_id="u-1")
    rt = ta.run(question, thread_id="t-1", user_id="u-1")
    assert (rt.thread_id, rt.retries, rt.final_answer) == ("t-1", 0, rj.final_answer)
    assert rt.confidence == pytest.approx(rj.confidence, abs=1e-5)
    assert rt.needs_human_review == rj.needs_human_review
    assert "".join(chunks).strip() == rt.final_answer and len(chunks) > 5

    def strip(entries):
        return [{k: v for k, v in e.items() if k != "time"} for e in entries]

    assert strip(tsave.get("t-1")) == strip(jsave.get("t-1"))
    assert tsave.get("t-1")[0]["node"] == "analyze_query" and len(tsave.get("t-1")) == 7
    fresh = timp.MemorySaver(persist_dir=str(tmp_path / "port"))
    assert fresh.get("t-1") == tsave.get("t-1")
    assert fresh.latest("t-1")["node"] == "generate_answer"
    ta.run(question, thread_id="t-1")  # a second run appends to the journal
    assert len(timp.MemorySaver(persist_dir=str(tmp_path / "port")).get("t-1")) == 14
    assert ta.load_user_preferences("u-1") == ja.load_user_preferences("u-1")
    assert ta.load_user_preferences("u-1")["interactions"] == 1


def test_improved_agent_review_and_compression(engines):
    reviewed = {}

    def reject(payload):
        reviewed.update(payload)
        return False

    _, ta = _agents(engines, jimp.ImprovedRetrievalAgent, timp.ImprovedRetrievalAgent,
                    t=dict(review_handler=reject))
    r = ta.run(_questions()[2])
    assert r.needs_human_review and "flagged for review" in r.final_answer
    assert reviewed["confidence"] == r.confidence
    long = [f"msg {i}" for i in range(20)]
    assert timp.compress_history(long) == jimp.compress_history(long)
    assert timp.compress_history(long[:5]) == long[:5]


# --- EnhancedRAG, GraphRelevanceScorer ---------------------------------------


def test_enhanced_rag_equals_jax(engines):
    je, te = engines
    jr, tr = jenh.EnhancedRAG(je), tenh.EnhancedRAG(te)
    for q, kw in ((_questions()[0], dict(top_k=5, similarity_threshold=0.0)),
                  ("synthetic row 12", dict(top_k=10, include_debug=True)),
                  ("anything at all", dict(similarity_threshold=1.6))):
        a, b = jr.query(q, **kw), tr.query(q, **kw)
        assert isinstance(b, tenh.RAGResponse) and b.processing_time > 0
        assert (b.query, b.answer) == (a.query, a.answer)
        assert [c["content"] for c in b.context_used] == [c["content"] for c in a.context_used]
        np.testing.assert_allclose(b.relevance_scores, a.relevance_scores, **TOL)
        assert set(b.metadata) == set(a.metadata)
        for key in b.metadata:
            if key not in ("top_relevance_score", "debug"):
                assert b.metadata[key] == a.metadata[key], key
    assert "couldn't find any relevant information" in b.answer
    assert "error" not in tr.query(_questions()[0], top_k=5).metadata


def test_enhanced_rag_budgeting(engines):
    rag = tenh.EnhancedRAG(engines[1], max_context_tokens=600)
    scored = [{"content": c * 400, "metadata": {}, "combined_score": s}
              for c, s in (("x", 0.9), ("y", 0.8), ("z", 0.7))]
    assert len(rag.optimize_context(scored, None)) == 1  # 100 tokens = 400 chars


def test_graph_relevance_scorer_equals_jax(engines):
    je, te = engines
    jg, tg = jint.GraphRelevanceScorer(je), tint.GraphRelevanceScorer(te)
    kinds = ["COMPOSITE", "ROUTER_TWO_ENT_TYPE", "PARALLEL"]
    a = jg.score_query_against_graph("synthetic row 5", top_k=5, similarity_threshold=0.0,
                                     scorer_types=[JaxScorer[k] for k in kinds])
    b = tg.score_query_against_graph("synthetic row 5", top_k=5, similarity_threshold=0.0,
                                     scorer_types=[ScorerType[k] for k in kinds])
    assert b["nodes_found"] == a["nodes_found"] > 5
    assert list(b["results"]) == list(a["results"])
    for name, scored in b["results"].items():
        want = a["results"][name]
        np.testing.assert_allclose([s["relevance_score"] for s in scored],
                                   [s["relevance_score"] for s in want], **TOL)
        assert [s["content_preview"] for s in scored] == [s["content_preview"] for s in want]
        assert any(s["is_connected"] and s["similarity_score"] == 0.0 for s in scored)
    ca, cb = jg.compare_scorer_performance("synthetic row 9", top_k=4), \
        tg.compare_scorer_performance("synthetic row 9", top_k=4)
    assert list(cb["scorers"]) == list(ca["scorers"]) and len(cb["scorers"]) == 10
    for name, stats in cb["scorers"].items():
        for key in ("top_score", "mean_score", "std_score"):
            assert stats[key] == pytest.approx(ca["scorers"][name][key], abs=1e-5)


# --- QueryInterface, graph queries, the parser --------------------------------


@pytest.mark.parametrize("mode", ["vector", "keyword", "context", "default", "auto", "bogus"])
def test_query_interface_modes_equal_jax(engines, mode):
    je, te = engines
    ji, ti = jiface.QueryInterface(je), tiface.QueryInterface(te)
    for question in ("synthetic row 17", "find synthetic row 3", "how is row 9 related"):
        a, b = ji.query(question, mode=mode), ti.query(question, mode=mode)
        assert set(b) == {"question", "answer", "mode", "source_nodes", "metadata"}
        assert (b["mode"], b["source_nodes"], b["answer"]) == \
            (a["mode"], a["source_nodes"], a["answer"])
        hits_a, hits_b = a["metadata"]["results"], b["metadata"]["results"]
        assert [h["content"] for h in hits_b] == [h["content"] for h in hits_a]
        np.testing.assert_allclose([h["similarity_score"] for h in hits_b],
                                   [h["similarity_score"] for h in hits_a], **TOL)
        assert not b["answer"].startswith("Query failed")
    assert tiface.select_best_mode("compare two bikes") == "vector"


def test_query_interface_failure_shape_and_explore(engines):
    _, te = engines
    ti = tiface.QueryInterface(te)

    class Broken:
        index, graph = te.index, te.graph

        def find_similar_content(self, *a, **k):
            raise RuntimeError("engine down")

        embedder = te.embedder

    ti.engine = Broken()
    out = ti.query("synthetic row 1", mode="vector")
    assert out == {"question": "synthetic row 1", "answer": "Query failed: engine down",
                   "mode": "vector", "source_nodes": 0, "metadata": {}}
    je = engines[0]
    jx, tx = jiface.QueryInterface(je).explore_graph(), tiface.QueryInterface(te).explore_graph()
    assert tx == jx and tx["total_nodes"] == N
    assert tiface.QueryInterface(te).suggest_queries() == \
        jiface.QueryInterface(je).suggest_queries()


def _product_graph():
    """Six nodes of four labels with typed edges (symmetrized)."""
    labels = ["Product", "Product", "Document", "Category", "Annotation", "Product"]
    texts = ["Red mountain bike", "Blue road bike", "Mountain bike manual",
             "Bikes category", "Figure 3 of the manual", "Bike helmet"]
    src = np.array([0, 0, 0, 2, 1, 5])
    dst = np.array([1, 2, 3, 4, 3, 0])
    names = ["SAME_CATEGORY", "DESCRIBED_BY", "SAME_CATEGORY", "ANNOTATION",
             "SAME_CATEGORY", "COMPLEMENTARY_PRODUCT"]
    ety = np.array([edge_type_id(n) for n in names])
    kw = dict(node_labels=labels, node_keys=[f"k{i}" for i in range(6)], node_texts=texts,
              node_to_row=np.full(6, -1, np.int32))
    from hcrag_tpu.core.graph import CsrGraph as JaxCsrGraph

    return (JaxCsrGraph.from_edges(6, src, dst, ety, **kw),
            CsrGraph.from_edges(6, src, dst, ety, **kw))


@pytest.mark.parametrize("question", [
    "Show the manual for the mountain bike", "products in the same category",
    "accessories that goes with a bike", "figure of the manual", "categories",
    "what is compatible with the road bike?", "products at a similar price"])
def test_graph_queries_equal_jax(question):
    jgraph, tgraph = _product_graph()
    a, b = jgq.answer_graph_question(jgraph, question), tgq.answer_graph_question(tgraph, question)
    assert b == a
    gq = tgq.GraphQuery(label="Product", edge_type="SAME_CATEGORY", limit=2)
    assert tgq.execute_graph_query(tgraph, gq) == jgq.execute_graph_query(
        jgraph, jgq.GraphQuery(**gq.model_dump()))
    assert tgraph.statistics() == jgraph.statistics()
    assert tgraph.num_edges == jgraph.num_edges


def test_parser_offline_and_models_equal_pydantic():
    tp = tparser.QueryParser(tllm.LLMClient(tcfg.RuntimeConfig(llm_base_url="")))
    jp = jparser.QueryParser(jllm.LLMClient(jcfg.RuntimeConfig(llm_base_url="")))
    assert tp.parse_query("Find red mountain bikes") == jp.parse_query("Find red mountain bikes")
    assert tp.parse_queries_batch(["a", "b"]) == jp.parse_queries_batch(["a", "b"])
    pairs = [(tparser.QueryEntities, jparser.QueryEntities),
             (tgq.GraphQuery, jgq.GraphQuery),
             (tllm.QueryIntentResponse, jllm.QueryIntentResponse),
             (tllm.EntityExtractionResponse, jllm.EntityExtractionResponse),
             (tllm.Decision, jllm.Decision)]
    payloads = [
        '{"product": {"name": "bike", "features": ["red"]}, "document": {"type": "manual"}}',
        '{}', '{"label": "Product", "limit": "5", "edge_type": null}',
        '{"intent": "document_request", "confidence": "0.75", "reasoning": "r"}',
        '{"entities": ["bike", "red"], "reasoning": "r"}',
        '{"decision": "revision", "reasoning": "thin"}',
        '{"limit": 2.5}', '{"product": {"features": "red"}}', '[1]',
    ]
    for tm, jm in pairs:
        assert tm.model_json_schema() == jm.model_json_schema()
        for text in payloads:
            try:
                want = jm.model_validate_json(text).model_dump()
            except ValueError:  # pydantic's ValidationError is a ValueError
                with pytest.raises(ValueError):
                    tm.model_validate_json(text)
                continue
            assert tm.model_validate_json(text).model_dump() == want, (tm, text)


def test_llm_fallbacks_equal_jax():
    tc = tllm.LLMClient(tcfg.RuntimeConfig(llm_base_url=""))
    out = tc.call("s", "u", tllm.QueryIntentResponse)
    assert (out.intent, out.confidence, out.reasoning) == \
        ("product_search", 0.5, "Fallback due to LLM timeout")
    assert tagent.analyze_query_intent("the manual for my bike", tc) == \
        QueryIntent.DOCUMENT_REQUEST
    assert tagent.extract_entities_from_query("red mountain bike frame", tc) == \
        jagent.extract_entities_from_query("red mountain bike frame", jllm.LLMClient(
            jcfg.RuntimeConfig(llm_base_url="")))
    assert QueryIntent.from_string(" Technical_Support ") == QueryIntent.TECHNICAL_SUPPORT
    assert QueryIntent.from_string("nonsense") == QueryIntent.PRODUCT_SEARCH
    seen = []
    assert tc.call_stream("s", "u", seen.append, fallback="alpha beta gamma") == \
        "alpha beta gamma"
    assert seen == ["alpha ", "beta ", "gamma"] and tc.failure_count == 2


def test_call_stream_from_local_endpoint():
    """Chunks of an SSE stream reach `on_token` before `call_stream`
    returns their concatenation; malformed events are skipped."""
    tokens = ["The ", "Mountain-100 ", "is ", "in ", "stock."]
    seen_body = {}

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_POST(self):  # noqa: N802
            seen_body.update(json.loads(self.rfile.read(int(self.headers["Content-Length"]))))
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.end_headers()
            self.wfile.write(b"data: not json\n\n")
            for t in tokens:
                event = {"choices": [{"delta": {"content": t}}]}
                self.wfile.write(f"data: {json.dumps(event)}\n\n".encode())
            self.wfile.write(b"data: [DONE]\n\n")

        def log_message(self, *a):
            pass

    server = http.server.HTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}/v1"
        client = tllm.LLMClient(tcfg.RuntimeConfig(llm_base_url=url, llm_timeout_s=10))
        seen, returned = [], []

        def on_token(chunk):
            assert not returned
            seen.append(chunk)

        answer = client.call_stream("sys", "user", on_token, max_tokens=5)
        returned.append(answer)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()
    assert seen == tokens and answer == "".join(tokens)
    assert seen_body["stream"] is True and seen_body["max_tokens"] == 5
    assert (client.call_count, client.failure_count) == (1, 0)


# --- scorer designs, dynamic weights, config ----------------------------------


def test_scorer_designs_equal_jax():
    jq, tq = jax_query(), create_sample_query()
    jn, tn = jax_nodes(), create_sample_nodes()
    for n in jn + tn:
        n.graph_relations["degree"] = 25
    a = jsd.CompositeScorer().score_batch(jq, jn)
    b = tsd.CompositeScorer(device="cpu").score_batch(tq, tn)
    assert len(b) == 18 and all(0 <= s <= 1 for s in b)
    np.testing.assert_allclose(b, a, **TOL)
    ta, tb = jsd.CompositeScorer().explain(jq, jn[:2]), \
        tsd.CompositeScorer(device="cpu").explain(tq, tn[:2])
    assert set(tb[0]) == set(ta[0]) and tb[0]["graph_centrality"] == pytest.approx(0.5)
    for x, y in zip(ta, tb):
        for key in x:
            assert y[key] == pytest.approx(x[key], abs=1e-5)
    da = jsd.DynamicWeightScorer().explain(jq, jn)
    db = tsd.DynamicWeightScorer(device="cpu").explain(tq, tn)
    for x, y in zip(da, db):
        assert set(x) == set(y)
        for key in x:
            assert y[key] == pytest.approx(x[key], abs=1e-5)
    np.testing.assert_allclose(tsd.DynamicWeightScorer(device="cpu").score_batch(tq, tn),
                               jsd.DynamicWeightScorer().score_batch(jq, jn), **TOL)
    np.testing.assert_array_equal(tsd.v0_weight_tensor(), jsd.v0_weight_tensor())
    np.testing.assert_array_equal(tsd.canonical_dynamic_weight_tensor(),
                                  jsd.canonical_dynamic_weight_tensor())
    v0a = jsd.V0SemanticSimilarityMetric().score_batch(jq, jn)
    v0b = tsd.V0SemanticSimilarityMetric().score_batch(tq, tn)
    np.testing.assert_allclose(v0b, v0a, **TOL)
    for length in (0, 101):
        for quality in (0.0, 0.9):
            assert tsd.v0_content_boost(length, quality) == jsd.v0_content_boost(length, quality)


def test_scorer_designs_custom_metric_and_validation():
    class ConstantMetric(tsd.RelevanceMetric):
        name = "constant"

        def score_batch(self, query, nodes):
            return [0.42] * len(nodes)

    scorer = tsd.CompositeScorer(
        metrics=[tsd.SemanticSimilarityMetric("cpu"), ConstantMetric()],
        weights={"semantic_similarity": 0.5, "constant": 0.5},
    )
    assert len(scorer.score_batch(create_sample_query(), create_sample_nodes()[:3])) == 3
    with pytest.raises(ValueError):
        tsd.CompositeScorer(weights={"semantic_similarity": 0.4}, device="cpu")
    rel = [{"incoming": list(range(10)), "relationship_weights": {"a": 0.9, "b": 0.3}},
           {"neighbors": list(range(10))}, {}]
    nodes = [dataclasses.replace(create_sample_nodes()[0], graph_relations=r) for r in rel]
    assert tsd.GraphCentralityMetric().score_batch(None, nodes) == pytest.approx(
        [(0.2 + 0.6) / 2, 0.2, 0.0])
    assert tsd.DynamicWeightScorer(device="cpu").score_batch(create_sample_query(), []) == []


def test_canonical_dynamic_weights_through_both_engines(engines):
    je, te = engines
    q = np.random.default_rng(6).standard_normal((8, D)).astype(np.float32)
    picks = [0, 1, 2, 3, 4, 0, 1, 2]
    rj = je.query_batch(q, top_k=5, intents=[list(JaxIntent)[p] for p in picks],
                        dynamic_weight_tensor=jsd.canonical_dynamic_weight_tensor())
    rt = te.query_batch(q, top_k=5, intents=[list(QueryIntent)[p] for p in picks],
                        dynamic_weight_tensor=tsd.canonical_dynamic_weight_tensor())
    np.testing.assert_array_equal(rt.top_indices, rj.top_indices)
    np.testing.assert_allclose(rt.relevance, rj.relevance, **TOL)
    np.testing.assert_allclose(rt.expanded_relevance, rj.expanded_relevance, **TOL)


def test_config_equals_jax(monkeypatch):
    jc, tc = jcfg.RuntimeConfig(), tcfg.RuntimeConfig()
    assert tc.scorer_type.value == jc.scorer_type.value
    assert tc.composite_weights.to_dict() == jc.composite_weights.to_dict()
    assert (tc.random_seed, tc.batch_size, tc.llm_timeout_s) == \
        (jc.random_seed, jc.batch_size, jc.llm_timeout_s)
    for name in ("SEMANTIC_GATE", "HIGH_RELEVANCE", "FINAL_TOP_K", "SAMPLE_LIMIT",
                 "EXPANSION_NEIGHBOR_LIMIT", "MAX_REVISIONS", "RECURSION_LIMIT",
                 "MAX_CONTEXT_TOKENS", "CONTEXT_TOKEN_RESERVE", "CHARS_PER_TOKEN",
                 "MAX_QUERY_ENTITIES", "ENCODER_CONFIDENCE_THRESHOLD", "DEFAULT_TOP_K"):
        assert getattr(tcfg, name) == getattr(jcfg, name), name
    try:
        tcfg.set_scorer_type(ScorerType.PARALLEL)
        tcfg.set_random_seed(7)
        tcfg.set_batch_size(3)
        tcfg.set_composite_weights(tcfg.CompositeWeights.create_balanced())
        g = tcfg.GLOBAL_CONFIG
        assert (g.scorer_type, g.random_seed, g.batch_size) == (ScorerType.PARALLEL, 7, 3)
        assert g.composite_weights.to_dict() == {k: 0.25 for k in g.composite_weights.to_dict()}
        monkeypatch.setenv("HCRAG_LLM_MODEL", "m-1")
        tcfg.reset_global_config()  # the endpoint fields read the environment again
        assert (g.scorer_type, g.random_seed, g.batch_size, g.llm_model) == \
            (ScorerType.COMPOSITE, None, 10, "m-1")
    finally:
        monkeypatch.delenv("HCRAG_LLM_MODEL")
        tcfg.reset_global_config()
