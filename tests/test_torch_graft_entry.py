"""The port's driver entry points (`hcrag_tpu_torch/graft_entry.py`) against
the JAX package's (`__graft_entry__.py`), on the CPU.

  * `entry()`: the port's step on its eight operands against JAX's
    `entry()`: indices, expanded nodes and counts exactly, the floats
    within 1e-5.
  * `dryrun_multichip` on 2 and 4 gloo ranks spawned once each
    (`tests/torch_sharded_workers.dryrun_cases`; a (1, 2) and a (2, 2)
    mesh), and on one rank in this process.  Its own checks pass on every
    rank, and its pieces equal JAX's, computed once here over the same
    rows: the forward at depth 2 and the four residency modes against
    JAX's unsharded engines (Pallas interpreted), the 1,024 served rows
    against JAX's unsharded `exact_rescore=32` engine (indices and
    expansion exactly, scores within 1e-5), the agent's fingerprint
    against JAX's `RetrievalAgent` over that engine (on every rank).
    JAX's own `dryrun_multichip` is not run: it is slow.
  * The contrastive step from JAX's `model.init(PRNGKey(0))` weights: the
    losses within 1e-5 of JAX's single-device loss and `optax.adamw(1e-3)`
    steps, step 1's averaged gradients within 1e-5 of `jax.grad`,
    relative (a gradient summed over the ranks instead of averaged would be
    off by the rank count), and the trained weights within Adam's steps
    (the rule of `tests/test_torch_distill.py`).
  * Without CUDA, both entry points raise when no device is given.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import __graft_entry__ as jentry
from hcrag_tpu_torch import graft_entry as G
from hcrag_tpu_torch.parallel.launch import run_ranks
from tests import torch_sharded_workers as W

SPAWN_S = 300
WORLDS = (2, 4)
STEPS, LR = 3, 1e-3
SEQ = 16


def _jax_flat(tree):
    import flax.traverse_util as tu

    return {"/".join(k): np.array(v) for k, v in tu.flatten_dict(tree).items()}


def jax_contrastive(world):
    """JAX's contrastive step on one device over the same global batch
    (one pair a rank, drawn as `__graft_entry__` draws them): (initial
    weights, losses, step 1's gradient, trained weights), flattened."""
    import jax
    import jax.numpy as jnp
    import optax

    from hcrag_tpu.models.minilm import MiniLMConfig, MiniLMEncoder

    cfg = MiniLMConfig(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
                       intermediate_size=256, max_position=32)
    model = MiniLMEncoder(cfg)
    rng = np.random.default_rng(0)
    d_ids = rng.integers(3, cfg.vocab_size, size=(world, SEQ)).astype(np.int32)
    corrupt = rng.random((world, SEQ)) < 0.3
    q_ids = np.where(corrupt, rng.integers(3, cfg.vocab_size, size=(world, SEQ)),
                     d_ids).astype(np.int32)
    mask = jnp.ones((world, SEQ), jnp.int32)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(d_ids[:1]),
                        jnp.ones((1, SEQ), jnp.int32))
    init = _jax_flat(params)
    tx = optax.adamw(LR)
    opt = tx.init(params)

    def loss_fn(p):
        q = model.apply(p, jnp.asarray(q_ids), mask)
        d = model.apply(p, jnp.asarray(d_ids), mask)
        logits = q @ d.T / 0.05
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.arange(world)).mean()

    @jax.jit
    def train_step(params, opt):
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt = tx.update(grads, opt, params)
        return optax.apply_updates(params, updates), opt, loss, grads

    losses, grad0 = [], None
    for i in range(STEPS):
        params, opt, loss, grads = train_step(params, opt)
        if i == 0:
            grad0 = _jax_flat(grads)
        losses.append(float(loss))
    pairs = G.contrastive_pairs(world, SEQ, cfg.vocab_size)
    assert np.array_equal(pairs[0], q_ids) and np.array_equal(pairs[1], d_ids)
    return init, losses, grad0, _jax_flat(params)


@pytest.fixture(scope="module")
def jax_side():
    """JAX's pieces over the dry run's rows, computed once."""
    from hcrag_tpu.config import RuntimeConfig
    from hcrag_tpu.pipeline.agent import RetrievalAgent
    from hcrag_tpu.query.engine import QueryEngine

    n, dim, b, k = G.DRYRUN_ROWS, G.DRYRUN_DIM, G.DRYRUN_BATCH, G.DRYRUN_K
    index, graph = jentry._synthetic_setup(n, dim)
    rng = np.random.default_rng(1)
    q = rng.standard_normal((b, dim)).astype(np.float32)
    sq = rng.standard_normal((G.DRYRUN_REQUESTS, dim)).astype(np.float32)
    sq /= np.linalg.norm(sq, axis=1, keepdims=True)
    depth2 = dict(top_k=k, expansion_depth=2, max_expanded=10)
    out = {"forward": W.result_arrays(QueryEngine(
        index, graph, ell_max_degree=8, pallas_interpret=True).query_batch(q, **depth2))}
    out["modes"] = {name: W.result_arrays(QueryEngine(
        index, graph, pallas_interpret=True, **opts).query_batch(q, **depth2))
        for name, opts, _ in G.DRYRUN_MODES}
    ref = QueryEngine(index, graph, exact_rescore=32, pallas_interpret=True)
    out["served"] = W.result_arrays(ref.query_batch(sq, top_k=k))
    r = RetrievalAgent(ref, graph, config=RuntimeConfig(random_seed=7)).run(G.AGENT_QUESTION)
    out["agent"] = (r.node_trace,
                    [n_.graph_relations.get("node_id") for n_ in r.final_relevant_nodes],
                    [round(float(n_.score), 6) for n_ in r.final_relevant_nodes],
                    r.decision)
    out["contrastive"] = {w: jax_contrastive(w) for w in WORLDS}
    return out


@pytest.fixture(scope="module")
def ranks(jax_side):
    """world -> each rank's `dryrun_cases` result."""
    return {w: run_ranks(W.dryrun_cases, w, args=(jax_side["contrastive"][w][0],),
                         timeout_s=SPAWN_S)
            for w in WORLDS}


def _same(got, want, label):
    np.testing.assert_array_equal(got["top_indices"], want["top_indices"], err_msg=label)
    np.testing.assert_allclose(got["top_scores"], want["top_scores"], atol=1e-5, err_msg=label)
    if "expanded_nodes" in want and "expanded_nodes" in got:
        np.testing.assert_array_equal(got["expanded_nodes"], want["expanded_nodes"],
                                      err_msg=label)
        np.testing.assert_array_equal(got["expanded_counts"], want["expanded_counts"],
                                      err_msg=label)


def test_entry_equals_jax():
    fn, args = jentry.entry()
    want = [np.asarray(o) for o in fn(*args)]
    step, targs = G.entry("cpu")
    assert len(targs) == 8 and all(t.device.type == "cpu" for t in targs[:7])
    assert targs[1].dtype == torch.int32 and targs[5].dtype == torch.bool
    got = [o.numpy() for o in step(*targs)]
    assert [g.shape for g in got] == [w.shape for w in want]
    for i in (1, 4, 5):  # top indices, expanded nodes, their counts
        np.testing.assert_array_equal(got[i], want[i])
    for i in (0, 2, 3, 6):  # scores, relevance, combined, expanded relevance
        np.testing.assert_allclose(got[i], want[i], atol=1e-5)


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        G.entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        G.dryrun_multichip(2)


@pytest.mark.parametrize("world", WORLDS)
def test_dryrun_passes_on_every_rank(ranks, world):
    outs = ranks[world]
    assert len(outs) == world
    mesh = {"batch": 2, "rows": world // 2} if world > 2 else {"batch": 1, "rows": world}
    for rank, out in enumerate(outs):
        assert out["mesh"] == mesh
        assert out["status"].startswith(f"dryrun_multichip ok: mesh={mesh}")
        assert (out["served"] is None) == (rank > 0)
        assert out["agent"] == outs[0]["agent"]
        assert out["batches"] == outs[0]["batches"] > 0


@pytest.mark.parametrize("world", WORLDS)
def test_dryrun_forward_equals_jax(ranks, jax_side, world):
    for out in ranks[world]:
        _same(out["forward"], jax_side["forward"], "forward")


@pytest.mark.parametrize("mode", [m[0] for m in G.DRYRUN_MODES])
@pytest.mark.parametrize("world", WORLDS)
def test_dryrun_modes_equal_jax(ranks, jax_side, world, mode):
    for out in ranks[world]:
        sharded, single = out["modes"][mode]
        _same(sharded, jax_side["modes"][mode], f"sharded {mode}")
        _same(single, jax_side["modes"][mode], f"unsharded {mode}")


@pytest.mark.parametrize("world", WORLDS)
def test_dryrun_served_rows_equal_jax(ranks, jax_side, world):
    served = ranks[world][0]["served"]
    assert served["top_indices"].shape == (G.DRYRUN_REQUESTS, G.DRYRUN_K)
    _same(served, jax_side["served"], "served")


@pytest.mark.parametrize("world", WORLDS)
def test_dryrun_agent_equals_jax(ranks, jax_side, world):
    for out in ranks[world]:
        assert out["agent"] == jax_side["agent"]
    assert jax_side["agent"][0][-1] == "generate_answer" and jax_side["agent"][1]


@pytest.mark.parametrize("world", WORLDS)
def test_contrastive_losses_match_jax(ranks, jax_side, world):
    want = jax_side["contrastive"][world][1]
    for out in ranks[world]:
        got = out["from_jax"]["losses"]
        np.testing.assert_allclose(got, want, atol=1e-5)
        assert got[-1] < got[0]
        # The dry run's own run, from the port's seeded weights.
        assert out["contrastive"]["losses"][-1] < out["contrastive"]["losses"][0]


@pytest.mark.parametrize("world", WORLDS)
def test_contrastive_gradients_match_jax_grad(ranks, jax_side, world):
    """Step 1's averaged gradient against `jax.grad` of the global loss,
    each leaf within 1e-5 of the largest gradient entry (a leaf that
    softmax's shift invariance leaves at zero up to rounding, the key
    biases, has no scale of its own), and within 1e-5 of its own norm where
    that is not below 1e-3 of the largest leaf norm."""
    want = jax_side["contrastive"][world][2]
    scale = max(np.abs(v).max() for v in want.values())
    norm = max(np.linalg.norm(v) for v in want.values())
    for out in ranks[world]:
        got = out["from_jax"]["grads"]
        assert sorted(got) == sorted(want) and len(got) == 37
        for k in want:
            err = np.abs(got[k] - want[k]).max()
            assert err <= 1e-5 * scale, (k, err, scale)
            own = np.linalg.norm(want[k])
            if own >= 1e-3 * norm:
                assert np.linalg.norm(got[k] - want[k]) <= 1e-5 * own, k


@pytest.mark.parametrize("world", WORLDS)
def test_contrastive_weights_within_adam_steps_of_jax(ranks, jax_side, world):
    init, want = jax_side["contrastive"][world][0], jax_side["contrastive"][world][3]
    for out in ranks[world]:
        got = out["from_jax"]["params"]
        assert sorted(got) == sorted(want)
        diffs = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
        assert diffs.max() <= 2 * STEPS * LR
        rel = {k: np.linalg.norm(got[k] - want[k])
               / max(np.linalg.norm(want[k] - init[k]), 1e-30)
               for k in want if not k.endswith("/key/bias")}
        worst = max(rel, key=rel.get)
        assert rel[worst] <= 1e-3, (worst, rel[worst])


def test_dryrun_on_one_rank_in_process():
    """One rank in this process: its default group is made for the run and
    destroyed after it; two pairs, since one pair has no negative."""
    torch.set_num_threads(2)
    assert not dist.is_initialized()
    out = G.dryrun_multichip(1, device="cpu")
    assert not dist.is_initialized()
    assert out["mesh"] == {"batch": 1, "rows": 1}
    assert out["served"]["top_indices"].shape == (G.DRYRUN_REQUESTS, G.DRYRUN_K)
    losses = out["contrastive"]["losses"]
    assert len(losses) == STEPS and losses[-1] < losses[0] and losses[0] > 0
