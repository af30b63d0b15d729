"""The port's native host libraries (`hcrag_tpu_torch/native`: the same
`fasthash.cpp` and `wordpiece.cpp` as the JAX package's, built by g++ into
the port's build directory) against the JAX package's native route and
the Python routes.

`embed_batch` equals JAX's native route bit for bit (the same source and
compiler) and the Python `encode_one` within 1e-6 (the C++ loop adds the
bigram features in another order); `bucket_df` equals both as integers;
the native WordPiece ids equal the Python tokenizer's on ASCII text, and a
batch with non-ASCII rows sends those rows to Python, as JAX does."""

import os

import numpy as np
import pytest

from hcrag_tpu import native as jnative
from hcrag_tpu.models.embedder import HashingEmbedder as JaxHashing
from hcrag_tpu.models.minilm import WordPieceTokenizer as JaxWordPiece
from hcrag_tpu_torch import native
from hcrag_tpu_torch.models.embedder import HashingEmbedder
from hcrag_tpu_torch.models.minilm import WordPieceTokenizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = os.path.join(ROOT, "tools", "minilm_distilled_vocab.txt")


def _texts(seed: int, n: int = 60):
    rng = np.random.default_rng(seed)
    words = ["Table:", "Product.", "Name:", "HL", "Road", "Frame", "-", "Black,", "58",
             "ListPrice:", "1431,50", "mountain", "bike", "rowguid:",
             "5A82F422-DB82-402A", "Jersey", "Handlebars", "0x47494638"]
    return [" ".join(rng.choice(words, size=int(rng.integers(0, 30)))) for _ in range(n)]


@pytest.fixture(scope="module")
def corpus():
    return _texts(0, 200)


def test_the_library_builds_here():
    assert native.available()
    assert native.library_path("fasthash").exists()
    assert native.library_path("fasthash").parent.name == "_kernels_build"


def test_sources_are_the_jax_packages():
    for name in native.SOURCES:
        mine = (native.SRC_DIR / f"{name}.cpp").read_bytes()
        theirs = open(os.path.join(ROOT, "hcrag_tpu", "native", f"{name}.cpp"), "rb").read()
        assert mine == theirs


@pytest.mark.parametrize("dim", [64, 384])
@pytest.mark.parametrize("bigrams", [True, False])
@pytest.mark.parametrize("fitted", [True, False])
def test_embed_batch_equals_jax_native_and_python(corpus, dim, bigrams, fitted):
    mine = HashingEmbedder(dim, use_bigrams=bigrams)
    theirs = JaxHashing(dim, use_bigrams=bigrams)
    if fitted:
        mine.fit(corpus)
        theirs.fit(corpus)
    texts = _texts(1) + ["", "Ünïcode Straße 42", "a"]
    got = mine.encode(texts)
    assert got.dtype == np.float32 and got.shape == (len(texts), dim)
    assert np.array_equal(got, jnative.embed_batch(
        texts, dim, use_bigrams=bigrams, idf=theirs._idf_weights()))
    assert np.array_equal(got, theirs.encode(texts))
    py = np.stack([mine.encode_one(t) for t in texts])
    np.testing.assert_allclose(got, py, atol=1e-6, rtol=0)


@pytest.mark.parametrize("dim", [64, 384, 1000])
@pytest.mark.parametrize("bigrams", [True, False])
def test_bucket_df_equals_jax_and_python(corpus, dim, bigrams):
    got = native.bucket_df(corpus, dim, use_bigrams=bigrams)
    assert got.dtype == np.int64
    assert np.array_equal(got, jnative.bucket_df(corpus, dim, use_bigrams=bigrams))
    py = HashingEmbedder(dim, use_bigrams=bigrams)
    want = np.zeros(dim, np.int64)
    for text in corpus:
        for b in {hash_ % dim for hash_ in map(_hash, py._features(text))}:
            want[b] += 1
    assert np.array_equal(got, want)


def _hash(feature):
    from hcrag_tpu_torch.models.embedder import _stable_hash

    return _stable_hash(feature)


def test_python_route_without_the_library(corpus, monkeypatch):
    """Where g++ is missing the functions return None and the embedder
    takes its Python path, with the same document frequencies."""
    want = HashingEmbedder(64).fit(corpus)
    monkeypatch.setitem(native._libs, "fasthash", None)
    assert not native.available() and native.embed_batch(["a"], 8) is None
    mine = HashingEmbedder(64).fit(corpus)
    assert np.array_equal(mine.bucket_df, want.bucket_df)
    np.testing.assert_allclose(mine.encode(corpus[:5]), want.encode(corpus[:5]),
                               atol=1e-6, rtol=0)


TOKEN_TEXTS = [
    "red mountain bike frame", "HL Road Frame - Black, 58", "unbelievably durable",
    "", "Sport-100 Helmet, Red; size: M/L (2008)", "zzzqxv ##weird tokens",
]
MIXED_TEXTS = ["Café Straße naïve", "ÉCLAIR bike", "plain ascii row", "日本 bike"]


@pytest.mark.parametrize("texts", [TOKEN_TEXTS, TOKEN_TEXTS + MIXED_TEXTS, MIXED_TEXTS])
@pytest.mark.parametrize("max_len", [8, 64])
def test_wordpiece_native_equals_python_and_jax(texts, max_len):
    tok = WordPieceTokenizer(VOCAB, max_len=128)
    assert tok._native_tokenizer() is not None
    ids, mask = tok.encode_batch(texts, max_len=max_len)
    py_ids, py_mask = tok._encode_batch_py(texts, max_len)
    assert np.array_equal(ids, py_ids) and np.array_equal(mask, py_mask)
    j_ids, j_mask = JaxWordPiece(VOCAB, max_len=128).encode_batch(texts, max_len=max_len)
    assert np.array_equal(ids, j_ids) and np.array_equal(mask, j_mask)


def test_native_wordpiece_ids_on_ascii():
    tok = WordPieceTokenizer(VOCAB)
    handle = native.NativeWordPiece.create(
        [w for w, _ in sorted(tok.vocab.items(), key=lambda kv: kv[1])])
    ids, mask = handle.encode_batch(TOKEN_TEXTS, 32, lowercase=True, cls_id=tok.cls_id,
                                    sep_id=tok.sep_id, unk_id=tok.unk_id)
    py_ids, py_mask = tok._encode_batch_py(TOKEN_TEXTS, 32)
    assert np.array_equal(ids, py_ids) and np.array_equal(mask, py_mask)


def test_build_is_cached_by_source_hash(tmp_path, monkeypatch):
    path = native.library_path("wordpiece")
    assert native.build(["wordpiece"]) == {"wordpiece": True}
    stamp = path.stat().st_mtime_ns
    assert native.build(["wordpiece"]) == {"wordpiece": True}
    assert path.stat().st_mtime_ns == stamp  # present: not rebuilt
    source = (native.SRC_DIR / "wordpiece.cpp").read_bytes()
    monkeypatch.setattr(native, "SRC_DIR", tmp_path)
    (tmp_path / "wordpiece.cpp").write_bytes(source + b"\n// edited\n")
    assert native.library_path("wordpiece") != path
