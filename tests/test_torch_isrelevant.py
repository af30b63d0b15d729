"""Relevance scoring of the PyTorch port against the JAX package.

  * Kernel B6's plain version against `pallas_batch_relevance` in interpret
    mode (both reductions, with and without an llm column, the empty-entity
    rules); the wrapper runs the plain version for CPU tensors.
  * `ops/scoring.py`'s metrics and their fusion against JAX's.
  * `pipeline/isrelevant.py` (`_fused_device_scores`, `batch_isRelevant`
    for all ten strategies, `isRelevant`) against JAX's, with an offline
    LLM client, and the client's own contracts: the response schema, the
    fallback on a refused connection, a structured answer from a local
    endpoint.

Tolerance 1e-5 where f32 sums are taken in another order (the dots, the
4-term reduction); exact elsewhere.
"""

import http.server
import json
import socket
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hcrag_tpu.config import RuntimeConfig as JaxRuntimeConfig
from hcrag_tpu.core import types as jtypes
from hcrag_tpu.ops import scoring as jscoring
from hcrag_tpu.ops.scoring_pallas import pallas_batch_relevance
from hcrag_tpu.pipeline import isrelevant as jisrel
from hcrag_tpu.pipeline.llm import BatchRelevanceScore as JaxBatchRelevanceScore
from hcrag_tpu.pipeline.llm import LLMClient as JaxLLMClient
from hcrag_tpu.pipeline.llm import RelevanceScore as JaxRelevanceScore
from hcrag_tpu_torch.config import RuntimeConfig
from hcrag_tpu_torch.core import types as ttypes
from hcrag_tpu_torch.ops import scoring as tscoring
from hcrag_tpu_torch.ops.scoring_cuda import batch_relevance
from hcrag_tpu_torch.pipeline import isrelevant as tisrel
from hcrag_tpu_torch.pipeline.llm import BatchRelevanceScore, LLMClient, RelevanceScore

TOL = dict(atol=1e-5, rtol=0)


def _popcounts(words):
    return np.array(
        [bin(int.from_bytes(r.tobytes(), "little")).count("1") for r in words], np.int32
    )


def _kernel_bank(b=4, n=700, d=128, w=8, seed=0):
    """The JAX kernel test's bank: query row 1 (if any) and node 5 have no
    entities."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    e = rng.standard_normal((n, d)).astype(np.float32)
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    qb = rng.integers(0, 2**32, (b, w), dtype=np.uint32) & rng.integers(
        0, 2**32, (b, w), dtype=np.uint32)
    nb = (rng.integers(0, 2**32, (n, w), dtype=np.uint32)
          & rng.integers(0, 2**32, (n, w), dtype=np.uint32)
          & rng.integers(0, 2**32, (n, w), dtype=np.uint32))
    qb[1:2] = 0
    nb[5] = 0
    tids = rng.integers(0, 6, n).astype(np.int32)
    intents = rng.integers(0, 5, b).astype(np.int32)
    llm = rng.uniform(0, 1, (b, n)).astype(np.float32)
    return q, e, qb, nb, _popcounts(qb), _popcounts(nb), tids, intents, llm


def _t(a):
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


@pytest.mark.parametrize("scorer", ["COMPOSITE", "PARALLEL", "ROUTER_TWO_ENT_TYPE",
                                    "ROUTER_SINGLE_ENT"])
@pytest.mark.parametrize("with_llm", [True, False])
def test_b6_plain_equals_pallas(scorer, with_llm):
    q, e, qb, nb, qc, nc, tids, intents, llm = _kernel_bank(seed=len(scorer))
    w, red = jtypes.scorer_spec(jtypes.ScorerType[scorer],
                                jtypes.CompositeWeights(0.4, 0.2, 0.3, 0.1))
    want = np.asarray(pallas_batch_relevance(
        *(jnp.asarray(a) for a in (q, qb, qc, intents, e, nb, nc, tids, w)),
        jnp.asarray(llm) if with_llm else None, reduction=red, tile=256,
        interpret=True,
    ))
    got = batch_relevance(
        *(_t(a) for a in (q, qb, qc, intents, e, nb, nc, tids, w)),
        torch.from_numpy(jtypes.PRIORITY_MATRIX),
        _t(llm) if with_llm else None, reduction=red,
    )
    assert got.shape == (4, 700) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    if scorer == "ROUTER_SINGLE_ENT":
        # Query 1 has no entities: 0.5 for the entity-less node, else 0.1.
        assert got[1, 5] == pytest.approx(0.5) and got[1, 0] == pytest.approx(0.1)


def test_b6_out_of_table_ids_score_zero_priority():
    q, e, qb, nb, qc, nc, tids, intents, _ = _kernel_bank(n=260, seed=9)
    tids[:3] = [6, -1, 99]
    intents[0] = 7
    w, red = jtypes.scorer_spec(jtypes.ScorerType.ROUTER_SINGLE_TYPE)
    want = np.asarray(pallas_batch_relevance(
        *(jnp.asarray(a) for a in (q, qb, qc, intents, e, nb, nc, tids, w)),
        reduction=red, tile=256, interpret=True,
    ))
    got = batch_relevance(*(_t(a) for a in (q, qb, qc, intents, e, nb, nc, tids, w)),
                          torch.from_numpy(jtypes.PRIORITY_MATRIX), reduction=red)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[0] == 0).all() and (got[:, :3] == 0).all()


def test_b6_bounds():
    """Path R's one query over 8192 nodes is bound by bytes; the kernel
    phase's 256 queries by f32 operations (`utils/bounds.py`)."""
    from hcrag_tpu_torch.utils.bounds import table

    b6 = [r for r in table() if r["id"] == "B6"]
    assert [(round(r["bound_ms"], 5), r["bound_by"]) for r in b6] == [
        (0.00387, "bytes"), (0.02404, "operations")]


def test_b6_wrapper_refuses_other_devices():
    meta = torch.zeros((1, 4), device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        batch_relevance(*(meta,) * 10)


# ---------------------------------------------------------------------------
# ops/scoring.py
# ---------------------------------------------------------------------------
def test_scoring_ops_match_jax():
    rng = np.random.default_rng(3)
    q = rng.standard_normal((3, 64)).astype(np.float32) * 3
    e = rng.standard_normal((50, 64)).astype(np.float32) * 2
    e[4] = 0.0  # a zero row normalizes to zero
    for qq in (q, q[0]):
        np.testing.assert_allclose(
            tscoring.semantic_similarity_scores(_t(qq), _t(e)).numpy(),
            np.asarray(jscoring.semantic_similarity_scores(jnp.asarray(qq), jnp.asarray(e))),
            **TOL)
    qb = rng.integers(0, 2**32, (3, 2), dtype=np.uint32) & rng.integers(
        0, 2**32, (3, 2), dtype=np.uint32)
    nb = rng.integers(0, 2**32, (50, 2), dtype=np.uint32) & rng.integers(
        0, 2**32, (50, 2), dtype=np.uint32)
    qb[1] = 0
    nb[[3, 7]] = 0
    for args in ((qb, nb, None, None), (qb, nb, _popcounts(nb), np.array([2, 0, 1], np.int32)),
                 (qb[1], nb, None, 0), (qb[0], nb, None, 3)):
        want = np.asarray(jscoring.entity_match_scores(
            *(None if a is None else jnp.asarray(a) for a in args)))
        got = tscoring.entity_match_scores(
            _t(args[0]), _t(args[1]), None if args[2] is None else _t(args[2]),
            None if args[3] is None else (args[3] if np.ndim(args[3]) == 0 else _t(args[3])))
        np.testing.assert_array_equal(got.numpy(), want)
    tids = rng.integers(0, 6, 50).astype(np.int32)
    for intent in (2, np.array([0, 4, 1], np.int32)):
        np.testing.assert_array_equal(
            tscoring.node_type_priority_scores(
                intent if np.ndim(intent) == 0 else _t(intent), _t(tids)).numpy(),
            np.asarray(jscoring.node_type_priority_scores(jnp.asarray(intent),
                                                          jnp.asarray(tids))))
    metrics = rng.random((7, 5, 4)).astype(np.float32)
    w = np.array([0.3, 0.45, 0.15, 0.1], np.float32)
    for red in (jtypes.REDUCE_WEIGHTED_SUM, jtypes.REDUCE_MAX):
        np.testing.assert_allclose(
            tscoring.combine_metrics(_t(metrics), _t(w), red).numpy(),
            np.asarray(jscoring.combine_metrics(jnp.asarray(metrics), jnp.asarray(w), red)),
            **TOL)
    deg = rng.integers(0, 120, 30).astype(np.int32)
    np.testing.assert_array_equal(
        tscoring.graph_centrality_scores(_t(deg)).numpy(),
        np.asarray(jscoring.graph_centrality_scores(jnp.asarray(deg))))


@pytest.mark.parametrize("scorer", list(jtypes.ScorerType))
def test_scoring_batch_relevance_matches_jax(scorer):
    q, e, qb, nb, qc, nc, tids, intents, llm = _kernel_bank(b=1, n=300, seed=4)
    kw = dict(query_emb=q[0], query_bits=qb[0], intent_id=3, node_emb=e,
              node_bits=nb, node_type_ids=tids, llm_scores=llm[0], query_oov=1)
    want = np.asarray(jscoring.batch_relevance(
        **{k: jnp.asarray(v) for k, v in kw.items()}, scorer_type=scorer))
    got = tscoring.batch_relevance(
        **{k: (v if np.ndim(v) == 0 else _t(v)) for k, v in kw.items()},
        scorer_type=ttypes.ScorerType(scorer.value))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# ---------------------------------------------------------------------------
# pipeline/isrelevant.py
# ---------------------------------------------------------------------------
ENTS = ["bike", "red", "frame", "manual", "helmet", "chain", "brake"]
TYPES = ["product", "document", "unknown", "Specification", "category", "annotation"]


def _nodes(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        ents = [ENTS[j] for j in rng.choice(len(ENTS), size=i % 3, replace=False)]
        out.append(dict(
            text=" ".join(rng.choice(["red", "bike", "frame", "road", "the", "manual"],
                                     size=4)),
            embeddings=rng.standard_normal(96).astype(np.float32),
            graph_relations={}, node_type=TYPES[i % len(TYPES)], entities=ents))
    return [jtypes.NodeInput(**d) for d in out], [ttypes.NodeInput(**d) for d in out]


def _query(entities, seed=1):
    emb = np.random.default_rng(seed).standard_normal(96).astype(np.float32)
    kw = dict(text="red road bike", embeddings=emb, entities=entities)
    return (jtypes.QueryInput(intent=jtypes.QueryIntent.COMPARISON_REQUEST, **kw),
            ttypes.QueryInput(intent=ttypes.QueryIntent.COMPARISON_REQUEST, **kw))


@pytest.mark.parametrize("entities", [["red", "bike", "carbon"], []])
@pytest.mark.parametrize("scorer", ["COMPOSITE", "PARALLEL", "ROUTER_TWO_ENT_TYPE"])
def test_fused_device_scores_match_jax(scorer, entities):
    """The fused route on the CPU (plain B6) against JAX's in interpret
    mode.  With an entity-less query both read each node's OOV count (0) as
    its entity count, so every node scores the 0.5 empty-set rule."""
    jn, tn = _nodes(300, seed=2)
    jq, tq = _query(entities)
    w = jtypes.CompositeWeights(0.35, 0.25, 0.25, 0.15)
    tw = ttypes.CompositeWeights(0.35, 0.25, 0.25, 0.15)
    llm = jisrel.overlap_fallback_scores(jq, jn)
    want = jisrel._fused_device_scores(jq, jn, jtypes.ScorerType[scorer], w, llm=llm,
                                       interpret=True)
    got = tisrel._fused_device_scores(tq, tn, ttypes.ScorerType[scorer], tw, llm=llm,
                                      device="cpu")
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("n_nodes", [16, 2100])
@pytest.mark.parametrize("scorer", [s.name for s in jtypes.ScorerType])
def test_batch_isrelevant_matches_jax(scorer, n_nodes):
    """All ten strategies with an offline client, on both sides of the
    fused route's node count (on the CPU both packages take the unfused
    metric stack)."""
    jn, tn = _nodes(n_nodes, seed=n_nodes)
    jq, tq = _query(["red", "bike", "carbon"])
    jc, tc = JaxLLMClient(JaxRuntimeConfig(llm_base_url="")), LLMClient(RuntimeConfig(llm_base_url=""))
    want = jisrel.batch_isRelevant(jq, jn, jtypes.ScorerType[scorer], client=jc)
    got = tisrel.batch_isRelevant(tq, tn, ttypes.ScorerType[scorer], client=tc, device="cpu")
    assert len(got) == n_nodes and all(isinstance(x, float) for x in got)
    np.testing.assert_allclose(got, want, **TOL)
    assert tisrel.batch_isRelevant(tq, [], ttypes.ScorerType[scorer], device="cpu") == []
    one = tisrel.isRelevant(tq, tn[3], ttypes.ScorerType[scorer], client=tc, device="cpu")
    assert one == pytest.approx(
        jisrel.isRelevant(jq, jn[3], jtypes.ScorerType[scorer], client=jc), abs=1e-5)


def test_overlap_fallback_exact():
    jn, tn = _nodes(40, seed=5)
    jq, tq = _query([])
    assert tisrel.overlap_fallback_scores(tq, tn) == jisrel.overlap_fallback_scores(jq, jn)


def test_response_schemas_equal_pydantic():
    assert BatchRelevanceScore.model_json_schema() == JaxBatchRelevanceScore.model_json_schema()
    assert RelevanceScore.model_json_schema() == JaxRelevanceScore.model_json_schema()
    for text in ('{"scores": [1, 0.5, "0.25", true]}', '{"scores": []}'):
        assert BatchRelevanceScore.model_validate_json(text).scores == \
            JaxBatchRelevanceScore.model_validate_json(text).scores
    with pytest.raises(ValueError):
        BatchRelevanceScore.model_validate({"scores": "x"})


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_refused_endpoint_falls_back_like_jax():
    url = f"http://127.0.0.1:{_free_port()}/v1"
    jn, tn = _nodes(12, seed=6)
    jq, tq = _query(["red"])
    jc = JaxLLMClient(JaxRuntimeConfig(llm_base_url=url, llm_timeout_s=5))
    tc = LLMClient(RuntimeConfig(llm_base_url=url, llm_timeout_s=5))
    assert not tc.offline
    want = jisrel.batch_llm_judge(jq, jn, jc)
    got = tisrel.batch_llm_judge(tq, tn, tc)
    assert got == want == tisrel.overlap_fallback_scores(tq, tn)
    assert (tc.call_count, tc.failure_count) == (jc.call_count, jc.failure_count) == (1, 1)
    assert tc.call("sys", "user") == "I apologize, but I'm having trouble processing " \
        "your request due to a technical issue. Please try again."


def test_structured_answer_from_local_endpoint():
    """A chat-completions endpoint on localhost answers with a short score
    list inside prose: the client parses the JSON object, and the judge
    pads it with 0.5."""
    seen = {}

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_POST(self):  # noqa: N802
            seen["body"] = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
            seen["auth"] = self.headers["Authorization"]
            content = 'Scores: {"scores": [0.2, 0.9]} done'
            body = json.dumps({"choices": [{"message": {"content": content}}]}).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    server = http.server.HTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}/v1/"
        tc = LLMClient(RuntimeConfig(llm_base_url=url, llm_api_key="k", llm_model="m",
                                     llm_timeout_s=10))
        _, tn = _nodes(3, seed=7)
        _, tq = _query(["red"])
        assert tisrel.batch_llm_judge(tq, tn, tc) == [0.2, 0.9, 0.5]
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()
    assert (tc.call_count, tc.failure_count) == (1, 0)
    assert seen["auth"] == "Bearer k" and seen["body"]["model"] == "m"
    fmt = seen["body"]["response_format"]["json_schema"]
    assert fmt["name"] == "BatchRelevanceScore"
    assert fmt["schema"] == JaxBatchRelevanceScore.model_json_schema()
