"""The PyTorch port's MiniLM encoder, its tokenizers and the encoder
confidence against the JAX package, on the committed distilled weights
(`tools/minilm_distilled*`: vocab 3777, hidden 384, 6 layers, 12 heads).

  * WordPiece and hash-tokenizer ids equal;
  * the torch forward against the Flax forward on the same ids, at max_len
    64 and 192: max |diff| <= 1e-5 on the normalized embeddings (f32 sums
    in another order);
  * `save_params` / `load_params` across the two packages;
  * `encoder_confidence` within 1e-6, and `process_query(with_confidence=
    True)` and the MiniLM branch of `embedder_from_index` equal to JAX's.

Everything runs on the CPU; the card holds its forward against the CPU's
in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from hcrag_tpu.core.dense_index import DenseIndex as JaxDenseIndex
from hcrag_tpu.models import confidence as jconf
from hcrag_tpu.models import minilm as jminilm
from hcrag_tpu.models.embedder import embedder_from_index as jax_embedder_from_index
from hcrag_tpu.query.engine import QueryEngine as JaxEngine
from hcrag_tpu_torch.core.dense_index import DenseIndex
from hcrag_tpu_torch.models import confidence as tconf
from hcrag_tpu_torch.models import minilm as tminilm
from hcrag_tpu_torch.models.embedder import embedder_from_index
from hcrag_tpu_torch.query.engine import QueryEngine

TOL = 1e-5


@pytest.fixture(scope="module")
def embedders():
    je = jminilm.load_distilled_embedder()
    te = tminilm.load_distilled_embedder(device="cpu")
    assert je is not None and te is not None
    return je, te


def _texts(n=16, seed=0):
    """Texts of the committed vocabulary's whole words, 2 to 150 words
    long (past 64 and near 192 tokens), with punctuation and a word the
    vocabulary splits or does not hold."""
    words = [w for w in open(tminilm.__file__.replace(
        "hcrag_tpu_torch/models/minilm.py", "tools/minilm_distilled_vocab.txt"),
        encoding="utf-8").read().split("\n")
        if w and not w.startswith("##") and not w.startswith("[")]
    rng = np.random.default_rng(seed)
    lengths = [2, 5, 9, 14, 20, 31, 40, 55, 63, 70, 90, 120, 150, 3, 11, 26][:n]
    out = [" ".join(rng.choice(words, size=k)) for k in lengths]
    out[1] += ", with Unknownzzqx parts!"
    out[3] = out[3].upper() + " 42."
    return out


@pytest.mark.parametrize("max_len", [64, 192])
def test_wordpiece_ids_equal_jax(embedders, max_len):
    je, te = embedders
    texts = _texts()
    ids_j, mask_j = je.tokenizer.encode_batch(texts, max_len=max_len)
    ids_t, mask_t = te.tokenizer.encode_batch(texts, max_len=max_len)
    np.testing.assert_array_equal(ids_t, ids_j)
    np.testing.assert_array_equal(mask_t, mask_j)
    np.testing.assert_array_equal(
        ids_t, je.tokenizer._encode_batch_py(texts, max_len)[0])
    if max_len == 64:
        assert mask_t.sum(axis=1).max() == 64  # some texts are cut
    else:
        assert 64 < mask_t.sum(axis=1).max() <= 192


def test_simple_tokenizer_equals_jax():
    texts = _texts(seed=1)
    for vocab, max_len in ((30522, 128), (3777, 32)):
        jt = jminilm.SimpleTokenizer(vocab, max_len=max_len)
        tt = tminilm.SimpleTokenizer(vocab, max_len=max_len)
        for a, b in zip(tt.encode_batch(texts), jt.encode_batch(texts)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(tt.encode_batch(texts, 16), jt.encode_batch(texts, 16)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("max_len", [64, 192])
def test_minilm_forward_equals_flax(embedders, max_len):
    je, te = embedders
    ids, mask = je.tokenizer.encode_batch(_texts(), max_len=max_len)
    want = np.asarray(je._apply(je.params, ids, mask))
    with torch.no_grad():
        got = te.model(torch.from_numpy(ids).long(), torch.from_numpy(mask)).numpy()
    assert got.shape == want.shape == (16, 384)
    assert float(np.abs(got - want).max()) <= TOL
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-6)


def test_embedder_encode_equals_jax(embedders):
    je, te = embedders
    texts = _texts(seed=2)
    for max_len in (0, 64):
        got, want = te.encode(texts, max_len=max_len), je.encode(texts, max_len=max_len)
        assert got.dtype == np.float32 and got.shape == (16, 384)
        assert float(np.abs(got - want).max()) <= TOL


def test_transformer_layer_equals_flax(embedders):
    """One layer of the distilled encoder on random activations and a
    ragged mask (padded keys), against the Flax layer."""
    je, te = embedders
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 20, 384)).astype(np.float32)
    mask = np.ones((3, 20), np.int32)
    mask[1, 7:] = 0
    mask[2, 1:] = 0
    layer = jminilm.TransformerLayer(je.cfg)
    params = {"params": je.params["params"]["TransformerLayer_2"]}
    want = np.asarray(layer.apply(params, x, mask[:, None, None, :].astype(bool)))
    with torch.no_grad():
        got = te.model.layers[2](torch.from_numpy(x), torch.from_numpy(mask).bool()).numpy()
    assert float(np.abs(got - want).max()) <= 1e-4


def test_params_round_trip_across_packages(embedders, tmp_path):
    je, te = embedders
    ids, mask = je.tokenizer.encode_batch(_texts(seed=4), max_len=64)
    # The port writes; the port and JAX read.
    te.save_params(str(tmp_path / "port.npz"))
    back = tminilm.MiniLMEmbedder(te.cfg, tokenizer=te.tokenizer, device="cpu", seed=7)
    back.load_params(str(tmp_path / "port.npz"))
    for k, v in te.model.state_dict().items():
        assert torch.equal(back.model.state_dict()[k], v), k
    jback = jminilm.FlaxMiniLMEmbedder(je.cfg, tokenizer=je.tokenizer, max_len=192)
    jback.load_params(str(tmp_path / "port.npz"))
    np.testing.assert_array_equal(np.asarray(jback._apply(jback.params, ids, mask)),
                                  np.asarray(je._apply(je.params, ids, mask)))
    # JAX writes; the port reads.
    je.save_params(str(tmp_path / "jax.npz"))
    with np.load(tmp_path / "jax.npz") as a, np.load(tmp_path / "port.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    again = tminilm.MiniLMEmbedder(te.cfg, tokenizer=te.tokenizer, device="cpu", seed=8)
    again.load_params(str(tmp_path / "jax.npz"))
    np.testing.assert_array_equal(again.encode(["red bike"]), te.encode(["red bike"]))


def _bank(embedder, n=120, seed=5):
    texts = _texts(seed=seed) * (n // 16 + 1)
    rng = np.random.default_rng(seed)
    texts = [" ".join(rng.permutation(t.split())[:12]) for t in texts[:n]]
    emb = embedder.encode(texts, max_len=64)
    return texts, emb / np.linalg.norm(emb, axis=1, keepdims=True)


def test_encoder_confidence_equals_jax(embedders):
    je, te = embedders
    texts, bank = _bank(te)
    assert tconf.DEFAULT_CALIBRATION == jconf.DEFAULT_CALIBRATION
    assert tconf.load_calibration() == jconf.load_calibration()
    for query in ("red road bike frame", texts[3], "what is the meaning of this"):
        assert tconf.confidence_variants(query) == jconf.confidence_variants(query)
        got = tconf.encoder_confidence(te, bank, query)
        want = jconf.encoder_confidence(je, bank, query)
        assert got.keys() == want.keys()
        for k in got:
            assert abs(got[k] - want[k]) <= 1e-6, (query, k)
    f_t = tconf.confidence_features(te, bank, texts[:4], top_k=5)
    f_j = jconf.confidence_features(je, bank, texts[:4], top_k=5)
    for k in f_t:
        np.testing.assert_allclose(f_t[k], f_j[k], atol=1e-6)
    np.testing.assert_allclose(tconf.confidence_scores(f_t), jconf.confidence_scores(f_j),
                               atol=1e-6)
    x = np.random.default_rng(0).random((40, 2))
    y = (x.sum(axis=1) > 1).astype(float)
    np.testing.assert_array_equal(tconf.fit_logistic(x, y), jconf.fit_logistic(x, y))
    s = np.random.default_rng(1).random(30)
    assert tconf.auc_score(s, s > 0.5) == jconf.auc_score(s, s > 0.5)


@pytest.fixture(scope="module")
def minilm_engines(embedders):
    """A 120-row index of the encoder's own vectors in both packages, with
    the distilled encoders attached."""
    je, te = embedders
    texts, bank = _bank(te)
    metadata = [{"id": f"row_{i}", "type": "database_table", "table_name": "Product"}
                for i in range(len(texts))]
    info = {"model_name": "all-MiniLM-L6-v2"}
    jeng = JaxEngine(JaxDenseIndex.build(bank, metadata, texts, generation_info=info),
                     use_pallas=True, pallas_interpret=True)
    teng = QueryEngine(DenseIndex.build(bank, metadata, texts, generation_info=info),
                       device="cpu")
    jeng.attach_device_encoder(je)
    teng.attach_device_encoder(te)
    return jeng, teng, texts


def test_process_query_with_confidence_equals_jax(minilm_engines):
    jeng, teng, texts = minilm_engines
    for query in ("red road bike frame", texts[7]):
        for flag in (True, None):  # None: the auto rule, on for <= 100k rows
            oj = jeng.process_query(query, top_k=5, with_confidence=flag)
            ot = teng.process_query(query, top_k=5, with_confidence=flag)
            assert set(ot) == set(oj) and "encoder_confidence" in ot
            assert [r["content"] for r in ot["results"]] == \
                [r["content"] for r in oj["results"]]
            assert ot["summary"] == oj["summary"]
            np.testing.assert_allclose(ot["query_embedding"], oj["query_embedding"], atol=TOL)
            for k, v in oj["encoder_confidence"].items():
                assert abs(ot["encoder_confidence"][k] - v) <= 1e-6, k
    off = teng.process_query("red bike", with_confidence=False)
    assert "encoder_confidence" not in off


def test_embedder_from_index_minilm_branch_equals_jax(minilm_engines):
    jeng, teng, _ = minilm_engines
    got = embedder_from_index(teng.index, device="cpu")
    want = jax_embedder_from_index(jeng.index)
    assert isinstance(got, tminilm.MiniLMEmbedder)
    assert isinstance(want, jminilm.FlaxMiniLMEmbedder)
    texts = ["red bike", "helmet manual guide"]
    assert float(np.abs(got.encode(texts) - want.encode(texts)).max()) <= TOL
    # A width the distilled encoder does not have falls back to hashing.
    small = DenseIndex.build(np.eye(8, 64, dtype=np.float32), [{}] * 8, ["x"] * 8,
                             generation_info={"model_name": "all-MiniLM-L6-v2"})
    assert type(embedder_from_index(small, device="cpu")).__name__ == "HashingEmbedder"


def test_embedder_runs_on_cuda_unless_told_otherwise():
    if torch.cuda.is_available():
        assert tminilm.MiniLMEmbedder(tminilm.MiniLMConfig(num_layers=1)).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        tminilm.MiniLMEmbedder(tminilm.MiniLMConfig(num_layers=1))
    with pytest.raises(RuntimeError, match="CUDA"):
        tminilm.load_distilled_embedder()


def test_forward_refuses_tf32():
    emb = tminilm.MiniLMEmbedder(tminilm.MiniLMConfig(vocab_size=64, num_layers=1),
                                 device="cpu")
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="TF32"):
            emb.encode(["a b"])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def test_embedding_gradients_equal_jax_grad():
    """The encoder adds its segment row by broadcast where Flax looks it
    up at every position: over 4,096 tokens (some padded) the gradients of
    the three embedding tables, the segment's two rows among them, equal
    `jax.grad` of the Flax encoder within 1e-5 of the largest entry."""
    import flax.traverse_util as tu
    import jax
    import jax.numpy as jnp

    cfg = dict(vocab_size=512, hidden_size=64, num_layers=1, num_heads=4,
               intermediate_size=128, max_position=64)
    model = jminilm.MiniLMEncoder(jminilm.MiniLMConfig(**cfg))
    rng = np.random.default_rng(3)
    ids = rng.integers(3, cfg["vocab_size"], size=(64, 64)).astype(np.int32)
    mask = (np.arange(64)[None, :] < rng.integers(8, 65, size=(64, 1))).astype(np.int32)
    g = rng.standard_normal((64, cfg["hidden_size"])).astype(np.float32)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(ids[:1]), jnp.asarray(mask[:1]))
    grads = jax.grad(lambda p: jnp.sum(model.apply(p, ids, mask) * g))(params)
    want = {f"params/Embed_{i}/embedding": np.asarray(grads["params"][f"Embed_{i}"]["embedding"])
            for i in range(3)}
    flat = {"/".join(k): np.array(v) for k, v in tu.flatten_dict(params).items()}
    port = tminilm.MiniLMEncoder(tminilm.MiniLMConfig(**cfg))
    port.load_state_dict(tminilm.flax_to_state(flat, port.cfg))
    (port(torch.from_numpy(ids).long(), torch.from_numpy(mask)) * torch.from_numpy(g)).sum() \
        .backward()
    got = tminilm.flax_from_state({n: p.grad for n, p in port.named_parameters()}, port.cfg)
    scale = max(np.abs(v).max() for v in want.values())
    for k, v in want.items():
        assert got[k].shape == v.shape
        assert np.abs(got[k] - v).max() <= 1e-5 * scale, k
    assert not got["params/Embed_2/embedding"][1].any()
