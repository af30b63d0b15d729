"""Text queries through the port's MiniLM encoder on the normal path, on
the CPU at a small size (2 layers, hidden 64, 4 heads, vocab 512, max_len
32), on seeded random weights under the published BertModel names:

  * the encoder against the plain reference (`models/minilm_plain.py`,
    the published forward in float64), within `TOL`; the same forward
    with its weights rounded to bf16 fails `TOL`;
  * `load_bert_state` / `bert_state` round trip over the published names;
  * `QueryEngine.query_text_batch_device` equals `query_batch_device` on
    the same embeddings, output for output, and records one `engine.step`
    with `engine.tokenize` and `engine.encode` inside it and the token
    counters;
  * `process_query` and `search_by_category` through an attached device
    encoder return what the host vector gave them before.
"""

import numpy as np
import pytest
import torch

from hcrag_tpu_torch.core.dense_index import DenseIndex
from hcrag_tpu_torch.core.graph import CsrGraph
from hcrag_tpu_torch.core.types import edge_type_id
from hcrag_tpu_torch.core.vocab import EntityVocab
from hcrag_tpu_torch.models import minilm, minilm_plain
from hcrag_tpu_torch.query.engine import QueryEngine
from hcrag_tpu_torch.utils import timing

CFG = minilm.MiniLMConfig(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
                          intermediate_size=256, max_position=32)
MAX_LEN = 32
#: |port - published forward in float64| on unit embeddings of width 64:
#: float32's unit roundoff (6e-8) grown over two layers' sums of 64-256
#: terms, the attention's softmax and the one-pass variance, measured at
#: 6-7e-8 here; weights rounded to bf16 (2^-9 relative) move it to 1.7e-3.
#: 1e-5 leaves two decades of room on each side.
TOL = 1e-5
TEXTS = ["red road bike frame", "helmet", "a long manual for the touring bike and its parts " * 3,
         "chain stay 42", "mountain bike with silver frame", "x"]


def bert_weights(cfg, seed):
    """Published-name weights drawn from `seed`: matrices and embeddings
    N(0, 0.05^2), biases N(0, 0.02^2), LayerNorm weights 1 + N(0, 0.1^2),
    so that no weight is left at its initial value."""
    g = torch.Generator().manual_seed(seed)
    model = minilm.MiniLMEncoder(cfg, generator=g)
    out = {}
    for name, t in minilm.bert_state(model).items():
        r = torch.randn(t.shape, generator=g)
        if "LayerNorm.weight" in name:
            out[name] = 1.0 + 0.1 * r
        elif name.endswith("bias"):
            out[name] = 0.02 * r
        else:
            out[name] = 0.05 * r
    return out


def embedder(state, seed=0):
    emb = minilm.MiniLMEmbedder(CFG, max_len=MAX_LEN, seed=seed, device="cpu")
    emb.load_bert_state(state)
    return emb


def plain(state, texts, dtype=torch.float64):
    ids, mask = minilm.SimpleTokenizer(CFG.vocab_size, MAX_LEN).encode_batch(texts)
    return minilm_plain.encode(state, torch.from_numpy(ids), torch.from_numpy(mask),
                               num_heads=CFG.num_heads, dtype=dtype)


@pytest.mark.parametrize("seed", [3, 4])
def test_encoder_equals_the_plain_reference(seed):
    state = bert_weights(CFG, seed)
    got = embedder(state).encode_device(TEXTS).to(torch.float64)
    want = plain(state, TEXTS)
    err = float((got - want).abs().max())
    assert err <= TOL, err
    torch.testing.assert_close(got.norm(dim=1), torch.ones(len(TEXTS), dtype=torch.float64),
                               rtol=0, atol=1e-6)
    # the plain forward in float32 sits as close to its own float64
    assert float((plain(state, TEXTS, torch.float32).double() - want).abs().max()) <= TOL


def test_bf16_weights_fail_the_tolerance():
    state = bert_weights(CFG, 3)
    low = {k: v.to(torch.bfloat16).to(torch.float32) for k, v in state.items()}
    err = float((embedder(low).encode_device(TEXTS).double() - plain(state, TEXTS)).abs().max())
    assert err > 10 * TOL, err


def test_bert_state_round_trips_over_the_published_names():
    state = bert_weights(CFG, 5)
    emb = embedder(state)
    back = minilm.bert_state(emb.model)
    assert set(back) == set(state)
    for name in state:
        assert torch.equal(back[name], state[name]), name
    assert "encoder.layer.1.attention.self.query.weight" in state
    assert "encoder.layer.1.output.LayerNorm.bias" in state
    assert state["encoder.layer.0.intermediate.dense.weight"].shape == (256, 64)
    # a "bert." prefix, the pooler and the position ids buffer load too
    other = embedder(bert_weights(CFG, 6))
    other.load_bert_state({**{"bert." + k: v for k, v in state.items()},
                           "pooler.dense.weight": torch.zeros(64, 64),
                           "embeddings.position_ids": torch.arange(32)[None]})
    np.testing.assert_array_equal(other.encode(TEXTS), emb.encode(TEXTS))
    with pytest.raises(KeyError, match="encoder.layer.2"):
        emb.load_bert_state({**state, "encoder.layer.2.output.dense.bias": torch.zeros(64)})


def test_encode_is_encode_device_on_the_host():
    emb = embedder(bert_weights(CFG, 7))
    np.testing.assert_array_equal(emb.encode(TEXTS), emb.encode_device(TEXTS).numpy())


def _engine(n=300, seed=11):
    rng = np.random.default_rng(seed)
    rows = rng.standard_normal((n, CFG.hidden_size)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    ids = np.arange(n, dtype=np.int32)
    index = DenseIndex(
        emb=rows, type_ids=rng.integers(0, 6, n).astype(np.int32),
        entity_bits=np.zeros((n, 4), np.uint32), entity_counts=np.zeros(n, np.int32),
        graph_ids=ids, metadata=[{"row": i} for i in range(n)],
        texts=[f"row {i}" for i in range(n)],
        vocab=EntityVocab({f"e{i}": i for i in range(128)}))
    src = np.repeat(ids, 4)
    dst = rng.integers(0, n, n * 4)
    etype = np.array([edge_type_id(t) for t in ("DESCRIBED_BY", "ANNOTATION")],
                     np.int8)[rng.integers(0, 2, n * 4)]
    graph = CsrGraph.from_edges(n, src, dst, etype, node_labels=["Product"] * n,
                                node_keys=range(n), node_texts=[""] * n, node_to_row=ids)
    engine = QueryEngine(index, graph, ell_max_degree=4, device="cpu")
    engine.attach_device_encoder(embedder(bert_weights(CFG, seed)))
    return engine


STEP = dict(top_k=5, expansion_depth=2, max_expanded=24)


def test_text_step_equals_the_vector_step():
    engine = _engine()
    out = engine.query_text_batch_device(TEXTS, **STEP)
    assert len(out) == 8
    emb = out[7]
    torch.testing.assert_close(emb, engine.embedder.encode_device(TEXTS), rtol=0, atol=0)
    want = engine.query_batch_device(emb, **STEP)
    for name, a, b in zip(("scores", "indices", "relevance", "combined", "nodes", "counts",
                           "expanded relevance"), out, want):
        assert torch.equal(a, b), name


def test_max_len_caps_the_padded_length():
    engine = _engine()
    short = engine.query_text_batch_device(TEXTS[:2], max_len=8, **STEP)[7]
    want = engine.embedder.encode_device(TEXTS[:2], max_len=8)
    torch.testing.assert_close(short, want, rtol=0, atol=0)


def test_a_text_step_records_one_step_with_its_spans_and_counters():
    engine = _engine()
    ids, mask = engine.embedder.tokenizer.encode_batch(TEXTS)
    timing.reset()
    try:
        with timing.recording():
            engine.query_text_batch_device(TEXTS, **STEP)
        recs = timing.records()
        counters = timing.summary()["counters"]
    finally:
        timing.reset()
    steps = [r for r in recs if r["name"] == "engine.step"]
    assert len(steps) == 1
    step = steps[0]
    assert step["attrs"]["batch"] == len(TEXTS)
    for name in ("engine.tokenize", "engine.encode"):
        [r] = [r for r in recs if r["name"] == name]
        assert r["step"] == step["id"] and r["parent"] == step["id"], name
        assert step["start_ns"] <= r["start_ns"] <= r["end_ns"] <= step["end_ns"]
    tok = next(r for r in recs if r["name"] == "engine.tokenize")
    enc = next(r for r in recs if r["name"] == "engine.encode")
    sel = next(r for r in recs if r["name"] == "engine.select")
    assert tok["end_ns"] <= enc["start_ns"] and enc["end_ns"] <= sel["start_ns"]
    assert counters["encode.tokens"] == int(mask.sum())
    assert counters["encode.padded_tokens"] == len(TEXTS) * MAX_LEN == ids.size


def test_the_vector_step_records_no_encoder_span():
    engine = _engine()
    q = engine.embedder.encode_device(TEXTS)
    timing.reset()
    try:
        with timing.recording():
            engine.query_batch_device(q, **STEP)
        names = [r["name"] for r in timing.records()]
        counters = timing.summary()["counters"]
    finally:
        timing.reset()
    assert names.count("engine.step") == 1
    assert not {"engine.tokenize", "engine.encode"} & set(names)
    assert not {"encode.tokens", "encode.padded_tokens"} & set(counters)


def test_a_text_step_needs_a_device_encoder():
    engine = _engine()

    class HostOnly:
        def encode(self, texts):
            return np.ones((len(texts), CFG.hidden_size), np.float32)

    engine.attach_device_encoder(HostOnly())
    with pytest.raises(TypeError, match="device encoder"):
        engine.query_text_batch_device(TEXTS, **STEP)
    # the host API still takes the host vector
    assert engine.process_query("red bike", with_confidence=False)["results"] is not None


def test_host_api_through_the_device_encoder_returns_what_it_did(monkeypatch):
    engine = _engine()
    calls = []
    real = QueryEngine.query_text_batch_device

    def spy(self, texts, **kw):
        calls.append(list(texts))
        return real(self, texts, **kw)

    monkeypatch.setattr(QueryEngine, "query_text_batch_device", spy)
    for text in TEXTS[:3]:
        q = engine.embedder.encode([text])[0]
        before = engine.find_similar_content(q, top_k=8, similarity_threshold=-1.0)
        got = engine.process_query(text, top_k=8, similarity_threshold=-1.0,
                                   with_confidence=False)
        np.testing.assert_array_equal(got["query_embedding"], q)
        assert [r["content"] for r in got["results"]] == [r["content"] for r in before]
        np.testing.assert_allclose([r["similarity_score"] for r in got["results"]],
                                   [r["similarity_score"] for r in before], rtol=0, atol=1e-6)
        by_cat = engine.search_by_category(text, top_k=6)
        res = engine.query_batch(q, top_k=6)
        assert [r["content"] for r in by_cat["results"]] == \
            [engine.index.texts[int(i)] for i in res.top_indices[0]]
    assert calls == [[t] for t in TEXTS[:3] for _ in range(2)]
