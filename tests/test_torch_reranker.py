"""The learned re-ranker and its checkpoints: the PyTorch port against the
JAX package, on the CPU.

  * `RerankerMLP` on parameters converted from Flax gives the JAX scores
    within 1e-5.
  * Training: the same batches through both packages' `train_step` give
    losses within 1e-5 (relative).  The weight matrices and the first
    layer's bias stay within 1e-4.  The two later biases are held through
    the scores instead: the listwise loss does not change when every logit
    of a query shifts by the same amount, so the output bias's gradient,
    and a hidden bias's where its unit is active on every candidate, is
    zero up to rounding, and AdamW (eps 1e-8) turns that rounding into
    steps of up to the learning rate, different in each package.  Those
    shifts leave the scores centred per query (what the loss and any order
    read) within 1e-4, and each such bias within the steps' bound.
  * Checkpoints: the same `.npz` layout, restoring across the packages
    both ways (scores within 1e-6, optimizer state equal), bit-exact resume
    inside the port, and the drift errors.
  * The engine side: `engine_candidate_features`, `rerank_result` /
    `query_batch(rerank=True)` (the same order) and `distill_judge_aware`,
    over the same synthetic index (JAX with Pallas in interpret mode).
"""

import jax
import numpy as np
import pytest

from __graft_entry__ import _synthetic_setup
from hcrag_tpu.core.types import QueryIntent as JaxIntent
from hcrag_tpu.models import reranker as jrr
from hcrag_tpu.query.engine import QueryEngine as JaxEngine
from hcrag_tpu.utils.train_checkpoint import save_train_state as jax_save
from hcrag_tpu_torch.core.types import QueryIntent
from hcrag_tpu_torch.models import reranker as trr
from hcrag_tpu_torch.query.engine import QueryEngine
from hcrag_tpu_torch.utils.synthetic import synthetic_setup
from hcrag_tpu_torch.utils.train_checkpoint import (
    restore_train_state,
    save_train_state,
)

N, D, B = 300, 64, 24
ENGINE_OPTS = dict(quantize_int8=True, int8_rescore=32, int8_f32_rescore=True)


def _pair(hidden=64, seed=0, lr=1e-3):
    """A JAX Reranker and a port Reranker holding the same parameters."""
    j = jrr.Reranker(hidden=hidden, learning_rate=lr, seed=seed)
    t = trr.Reranker(hidden=hidden, learning_rate=lr, seed=seed, device="cpu")
    t.load_flax_params(jax.tree_util.tree_map(np.asarray, j.state.params))
    return j, t


def _batches(seed=0, n=20, b=8, k=12):
    rng = np.random.default_rng(seed)
    return [
        (rng.uniform(size=(b, k, trr.NUM_FEATURES)).astype(np.float32),
         (10 * rng.uniform(size=(b, k))).astype(np.float32),
         rng.uniform(size=(b, k)) > 0.15)
        for _ in range(n)
    ]


def _jax_leaves(j):
    return ([np.asarray(x) for x in jax.tree_util.tree_leaves(j.state.params)],
            [np.asarray(x) for x in jax.tree_util.tree_leaves(j.state.opt_state)])


def _centred(s):
    return s - s.mean(axis=-1, keepdims=True)


@pytest.mark.parametrize("hidden,seed", [(64, 0), (64, 5), (16, 2)])
def test_mlp_forward_on_converted_params(hidden, seed):
    j, t = _pair(hidden, seed)
    feats = np.random.default_rng(seed).standard_normal((6, 9, 5)).astype(np.float32)
    np.testing.assert_allclose(t.score(feats), j.score(feats), atol=1e-5, rtol=0)
    assert t.model.layers[0].weight.shape == (hidden, 5)  # Linear: [out, in]
    back = t.flax_params()["params"]
    for name, layer in j.state.params["params"].items():
        for leaf in ("kernel", "bias"):
            np.testing.assert_array_equal(back[name][leaf], np.asarray(layer[leaf]))


def test_init_follows_flax():
    """LeCun normal kernels (truncated at 2 sigma, variance 1/fan_in) and
    zero biases; the same seed gives the same parameters."""
    a = trr.Reranker(seed=4, device="cpu").flax_params()["params"]
    b = trr.Reranker(seed=4, device="cpu").flax_params()["params"]
    for name, fan_in in (("Dense_0", 5), ("Dense_1", 64)):
        k = a[name]["kernel"]
        np.testing.assert_array_equal(k, b[name]["kernel"])
        assert np.abs(k).max() <= 2.0 / 0.87962566103423978 / np.sqrt(fan_in) + 1e-6
        assert abs(k.var() * fan_in - 1.0) < 0.35
        assert not a[name]["bias"].any()
    opt = trr.Reranker(device="cpu").optimizer.defaults
    assert (opt["betas"], opt["eps"], opt["weight_decay"]) == ((0.9, 0.999), 1e-8, 1e-4)


def test_train_steps_match_jax():
    lr, steps = 1e-3, 20
    j, t = _pair(seed=3, lr=lr)
    for feats, labels, mask in _batches(seed=1, n=steps):
        lj = j.train_step(feats, labels, mask)
        lt = t.train_step(feats, labels, mask)
        assert abs(lt - lj) <= 1e-5 * abs(lj)
    jp, jo = _jax_leaves(j)
    tp, to = t.train_state()
    names = ["Dense_0/bias", "Dense_0/kernel", "Dense_1/bias", "Dense_1/kernel",
             "Dense_2/bias", "Dense_2/kernel"]
    for name, a, b in zip(names, jp, tp):
        if name in ("Dense_1/bias", "Dense_2/bias"):
            # The shift-invariant directions: bounded by the AdamW steps.
            assert np.abs(a - b).max() <= 2 * steps * lr, name
        else:
            np.testing.assert_allclose(b, a, atol=1e-4, rtol=0, err_msg=name)
    assert int(to[0]) == int(jo[0]) == steps
    feats = _batches(seed=9, n=1)[0][0]
    np.testing.assert_allclose(_centred(t.score(feats)), _centred(j.score(feats)),
                               atol=1e-4, rtol=0)


def test_fit_distill_losses_match_jax():
    j, t = _pair(hidden=32, seed=1, lr=5e-3)
    rng = np.random.default_rng(2)
    feats = rng.uniform(size=(40, 10, 5)).astype(np.float32)
    labels = 10 * feats[..., 4]
    lj = j.fit_distill(feats, labels, epochs=4, batch_size=16, seed=3)
    lt = t.fit_distill(feats, labels, epochs=4, batch_size=16, seed=3)
    np.testing.assert_allclose(lt, lj, rtol=1e-5, atol=0)
    assert lt[-1] < lt[0]


def test_resume_is_bit_exact(tmp_path):
    batches = _batches(seed=4, n=6)
    full = trr.Reranker(seed=1, device="cpu")
    for f, l, m in batches:
        full.train_step(f, l, m)
    first = trr.Reranker(seed=1, device="cpu")
    for f, l, m in batches[:3]:
        first.train_step(f, l, m)
    first.save(tmp_path / "reranker", step=3)  # no suffix: .npz is added
    resumed = trr.Reranker(seed=999, device="cpu")
    assert resumed.restore(tmp_path / "reranker.npz") == 3
    for f, l, m in batches[3:]:
        resumed.train_step(f, l, m)
    for a, b in zip(sum(full.train_state(), []), sum(resumed.train_state(), [])):
        np.testing.assert_array_equal(a, b)


def test_checkpoints_cross_load(tmp_path):
    """A checkpoint of either package restores in the other: the same
    leaves in the same order (optimizer count and moments included), and
    scores within 1e-6; training then goes on alike in both."""
    j, t = _pair(seed=6)
    for f, l, m in _batches(seed=5, n=3):
        j.train_step(f, l, m)
    j.save(tmp_path / "from_jax.npz", step=3)
    port = trr.Reranker(seed=7, device="cpu")
    assert port.restore(tmp_path / "from_jax.npz") == 3
    feats = _batches(seed=8, n=1)[0][0]
    np.testing.assert_allclose(port.score(feats), j.score(feats), atol=1e-6, rtol=0)
    jp, jo = _jax_leaves(j)
    tp, to = port.train_state()
    assert len(to) == len(jo) == 13 and to[0].dtype == np.int32
    for a, b in zip(jp + jo, tp + to):
        np.testing.assert_array_equal(a, b)
    f, l, m = _batches(seed=10, n=1)[0]
    assert port.train_step(f, l, m) == pytest.approx(j.train_step(f, l, m), rel=1e-6)

    for f, l, m in _batches(seed=11, n=2):
        port.train_step(f, l, m)
    port.save(tmp_path / "from_port.npz", step=6)
    back = jrr.Reranker(seed=12)
    assert back.restore(tmp_path / "from_port.npz") == 6
    np.testing.assert_allclose(back.score(feats), port.score(feats), atol=1e-6, rtol=0)
    for a, b in zip(sum(_jax_leaves(back), []), sum(port.train_state(), [])):
        np.testing.assert_array_equal(a, b)
    with np.load(tmp_path / "from_port.npz") as data:
        assert sorted(data.files) == sorted(
            ["__step__"] + [f"p/leaf_{i:05d}" for i in range(6)]
            + [f"o/leaf_{i:05d}" for i in range(13)])


def test_fresh_checkpoint_has_zero_optimizer_state(tmp_path):
    """Before its first step the port saves what a fresh optax state
    holds: count 0 and zero moments."""
    j = jrr.Reranker(seed=0)
    t = trr.Reranker(seed=0, device="cpu")
    t.save(tmp_path / "c.npz")
    _, jo = _jax_leaves(j)
    _, to = t.train_state()
    for a, b in zip(jo, to):
        assert a.shape == b.shape and a.dtype == b.dtype and not b.any()
    assert j.restore(tmp_path / "c.npz") == 0


def test_drift_errors(tmp_path):
    trr.Reranker(hidden=64, device="cpu").save(tmp_path / "c64.npz")
    with pytest.raises(ValueError, match="shape"):
        trr.Reranker(hidden=32, device="cpu").restore(tmp_path / "c64.npz")
    params = [np.zeros((2, 2), np.float32)]
    save_train_state(tmp_path / "few.npz", params, [np.zeros((2, 2), np.float32)], 1)
    with pytest.raises(ValueError, match="leaves"):
        restore_train_state(tmp_path / "few.npz", params,
                            [np.zeros((), np.int32)] + [np.zeros((2, 2), np.float32)] * 2)
    # A JAX checkpoint of another optimizer (plain SGD: no state leaves).
    import optax

    tree = {"w": np.zeros((2, 2), np.float32)}
    jax_save(tmp_path / "sgd.npz", tree, optax.sgd(0.1).init(tree), 41)
    with pytest.raises(ValueError, match="leaves"):
        trr.Reranker(device="cpu").restore(tmp_path / "sgd.npz")
    _, _, step = restore_train_state(tmp_path / "sgd.npz", params, [])
    assert step == 41


def test_ndcg_matches_jax():
    rng = np.random.default_rng(3)
    scores = rng.uniform(size=(7, 12))
    order = np.argsort(-rng.uniform(size=(7, 12)), axis=1)
    for k in (1, 5, 10, 20):
        assert trr.ndcg_at_k(order, scores, k) == jrr.ndcg_at_k(order, scores, k)


@pytest.fixture(scope="module")
def engines():
    jidx, jg = _synthetic_setup(N, D, graph_degree=4)
    tidx, tg = synthetic_setup(N, D, graph_degree=4)
    return (JaxEngine(jidx, jg, use_pallas=True, pallas_interpret=True,
                      ell_max_degree=8, **ENGINE_OPTS),
            QueryEngine(tidx, tg, device="cpu", ell_max_degree=8, **ENGINE_OPTS))


def _queries():
    rng = np.random.default_rng(21)
    q = rng.standard_normal((B, D)).astype(np.float32)
    ents = [[f"e{x}" for x in rng.integers(0, 128, size=2)] for _ in range(B)]
    ents[0] = []
    picks = rng.integers(0, 5, size=B)
    return q, ents, picks


def test_candidate_features_and_rerank_order(engines):
    je, te = engines
    q, ents, picks = _queries()
    ji = [list(JaxIntent)[p] for p in picks]
    ti = [list(QueryIntent)[p] for p in picks]
    rj = je.query_batch(q, top_k=10, intents=ji, entity_lists=ents)
    rt = te.query_batch(q, top_k=10, intents=ti, entity_lists=ents)
    np.testing.assert_array_equal(rt.top_indices, rj.top_indices)
    fj = jrr.engine_candidate_features(je, rj, intents=ji, entity_lists=ents)
    ft = trr.engine_candidate_features(te, rt, intents=ti, entity_lists=ents)
    np.testing.assert_allclose(ft, fj, atol=1e-6, rtol=0)
    assert ft.shape == (B, 10, 5) and not ft[..., 1].any()

    j, t = _pair(seed=2)
    for f, l, m in _batches(seed=3, n=5, k=10):  # a trained, not a fresh, model
        j.train_step(f, l, m)
    t.load_flax_params(jax.tree_util.tree_map(np.asarray, j.state.params))
    je.set_reranker(j)
    te.set_reranker(t)
    try:
        rj = je.query_batch(q, top_k=10, intents=ji, entity_lists=ents, rerank=True)
        rt = te.query_batch(q, top_k=10, intents=ti, entity_lists=ents, rerank=True)
    finally:
        je.set_reranker(None)
        te.set_reranker(None)
    np.testing.assert_array_equal(rt.top_indices, rj.top_indices)
    np.testing.assert_allclose(rt.rerank_scores, rj.rerank_scores, atol=1e-5, rtol=0)
    for f in ("top_scores", "relevance", "combined"):
        np.testing.assert_allclose(getattr(rt, f), getattr(rj, f), atol=1e-5, rtol=0)
    assert (np.diff(rt.rerank_scores, axis=1) <= 0).all()
    # Without a re-ranker the result comes back as it is.
    plain = te.query_batch(q, top_k=10, intents=ti, entity_lists=ents)
    assert te.rerank_result(plain) is plain


def test_rerank_keeps_invalid_slots_last(engines):
    _, te = engines
    res = te.query_batch(np.random.default_rng(4).standard_normal((3, D)), top_k=6)
    res.top_indices[:, 0] = -1
    res.top_scores[1, 1] = -1e30
    t = trr.Reranker(seed=0, device="cpu")
    te.set_reranker(t)
    try:
        out = te.rerank_result(res)
    finally:
        te.set_reranker(None)
    invalid = (out.top_indices < 0) | (out.top_scores <= -1e29)
    np.testing.assert_array_equal(invalid.sum(axis=1), [1, 2, 1])
    for row in invalid:  # the invalid slots are the last ones
        assert not row[: len(row) - row.sum()].any()
    np.testing.assert_array_equal(np.isneginf(out.rerank_scores), invalid)


def test_distill_judge_aware_matches_jax(engines):
    je, te = engines
    q, _, _ = _queries()
    texts = [f"synthetic row {i}" for i in range(B)]
    j, t = _pair(hidden=32, seed=5)
    oj = jrr.distill_judge_aware(je, j, texts, q, top_m=12, epochs=3, seed=1)
    ot = trr.distill_judge_aware(te, t, texts, q, top_m=12, epochs=3, seed=1)
    np.testing.assert_allclose(ot["features"], oj["features"], atol=1e-6, rtol=0)
    np.testing.assert_allclose(ot["labels"], oj["labels"], atol=1e-6, rtol=0)
    np.testing.assert_allclose(ot["losses"], oj["losses"], rtol=1e-5, atol=0)
