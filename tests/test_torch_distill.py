"""The port's MiniLM distillation (`hcrag_tpu_torch/tools/distill_minilm.py`)
against the JAX tool (`tools/distill_minilm.py`), both on the CPU.

The golden set: 32 texts of the seeded AdventureWorks corpus
(`testing.write_adventureworks_corpus`, `process_corpus`), each paired with
the committed distilled encoder's vector (the teacher; `load_distilled_
embedder`, max_len 192).  Both tools train the full-width encoder (their
`main` fixes it) at batch 4, max_len 16, 4 steps in chunks of 2.  The JAX
tool runs unmodified: its `PICKLE` and `REPO` constants point into a
temporary directory, so its held-out mode writes nothing of the repo.

  * the vocabulary files are byte-equal; the schedule equals optax's at
    every count; the fresh encoder initializes as Flax's does in
    distribution;
  * from the JAX tool's initial weights the port's per-chunk reports lie
    within 1e-4 of JAX's, its output embeddings within 1e-4, and its
    parameters within 2 x steps x lr (Adam's step: a gradient that is zero
    up to rounding, as the attention key biases' is, still moves its
    parameter by up to lr a step), every other leaf within 1e-3 of the
    distance JAX's run moved it;
  * checkpoints resume across the packages both ways, and a resumed port
    run is bit-identical to an uninterrupted one;
  * the held-out report's keys equal JAX's and its numbers lie within 1e-4;
    the artifacts load in both packages.
"""

import ast
import contextlib
import hashlib
import io
import json
import os
import shutil

import numpy as np
import pytest
import torch

import tools.distill_minilm as jdistill
from hcrag_tpu.models import minilm as jminilm
from hcrag_tpu_torch.ingest.adventureworks import process_corpus
from hcrag_tpu_torch.models import minilm as tminilm
from hcrag_tpu_torch.testing import write_adventureworks_corpus, write_golden_pairs
from hcrag_tpu_torch.tools import distill_minilm as tdistill

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS, CHUNK, BATCH, MAX_LEN, LR = 4, 2, 4, 16, 4e-4
ARGS = ["--steps", str(STEPS), "--scan-chunk", str(CHUNK), "--batch", str(BATCH),
        "--max-len", str(MAX_LEN), "--lr", str(LR)]
HOLDOUT = ["--holdout-frac", "0.2", "--augment", "1"]
TOL = 1e-4


def _repo_files():
    """Digests of every file under the repo's tools/ and benchmarks/."""
    out = {}
    for top in ("tools", "benchmarks"):
        for d, _, files in os.walk(os.path.join(ROOT, top)):
            for f in files:
                if "__pycache__" not in d:
                    p = os.path.join(d, f)
                    out[p] = hashlib.sha256(open(p, "rb").read()).hexdigest()
    return out


def golden_set(tmp, n):
    """A pickle of n (corpus text, teacher vector) pairs under `tmp`, with
    the tools/ and benchmarks/ directories the JAX tool writes into."""
    for sub in ("tools", "benchmarks"):
        os.makedirs(os.path.join(tmp, sub), exist_ok=True)
    texts, _ = process_corpus(write_adventureworks_corpus(os.path.join(tmp, "aw"), seed=0))
    texts = [texts[i] for i in np.random.default_rng(3).choice(len(texts), n, replace=False)]
    teacher = tminilm.load_distilled_embedder(device="cpu")
    return write_golden_pairs(os.path.join(tmp, "pairs.pkl"), texts, teacher.encode(texts))


def run_jax(monkeypatch_ctx, tmp, pickle_path, argv):
    """The JAX tool's `main(argv)` with its constants in `tmp`; returns its
    per-chunk reports (parsed from what it prints)."""
    monkeypatch_ctx.setattr(jdistill, "PICKLE", pickle_path)
    monkeypatch_ctx.setattr(jdistill, "REPO", tmp)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jdistill.main(argv)
    return [ast.literal_eval(line) for line in buf.getvalue().splitlines()
            if line.startswith("{'step'")]


def jax_init(vocab_path):
    """The JAX tool's initial weights, built as its `main` builds them."""
    import flax.traverse_util as tu

    tok = jminilm.WordPieceTokenizer(vocab_path, max_len=MAX_LEN)
    cfg = jminilm.MiniLMConfig(vocab_size=tok.vocab_size, max_position=MAX_LEN)
    params = jminilm.FlaxMiniLMEmbedder(cfg, tokenizer=tok, max_len=MAX_LEN).params
    return {"/".join(k): np.array(v) for k, v in tu.flatten_dict(params).items()}


def _keep_checkpoints(monkeypatch_ctx, module, name):
    """Copy every checkpoint `module.<name>` writes to <path>.step<k>.npz."""
    real = getattr(module, name)

    def save(path, params, opt_state, step):
        real(path, params, opt_state, step)
        src = str(path) if str(path).endswith(".npz") else str(path) + ".npz"
        shutil.copy(src, src[:-4] + f".step{step}.npz")

    monkeypatch_ctx.setattr(module, name, save)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX runs (plain, with checkpoints; held-out) and the port's runs
    from JAX's initial weights."""
    before = _repo_files()
    tmp = str(tmp_path_factory.mktemp("distill"))
    pk = golden_set(tmp, 32)
    out = {"tmp": tmp, "pickle": pk, "before": before}
    with pytest.MonkeyPatch.context() as mp:
        import hcrag_tpu.utils.train_checkpoint as jckpt

        _keep_checkpoints(mp, jckpt, "save_train_state")
        out["jax"] = run_jax(mp, tmp, pk, ARGS + ["--out", f"{tmp}/jax", "--resume",
                                                   f"{tmp}/jax_ckpt.npz"])
    with pytest.MonkeyPatch.context() as mp:
        out["jax_holdout"] = run_jax(mp, tmp, pk, ARGS + HOLDOUT + ["--out", f"{tmp}/jax"])
    init = jax_init(f"{tmp}/jax_vocab.txt")
    out["init"] = init
    with pytest.MonkeyPatch.context() as mp:
        _keep_checkpoints(mp, tdistill, "save_train_state")
        out["port"] = tdistill.main(
            ARGS + ["--pickle", pk, "--out", f"{tmp}/port", "--device", "cpu",
                    "--resume", f"{tmp}/port_ckpt.npz"], init=init)
    out["port_holdout"] = tdistill.main(
        ARGS + HOLDOUT + ["--pickle", pk, "--out", f"{tmp}/port", "--device", "cpu"],
        init=jax_init(f"{tmp}/jax_holdout_vocab.txt"))
    return out


@pytest.mark.parametrize("suffix", ["_vocab.txt", "_holdout_vocab.txt"])
def test_vocab_file_is_byte_equal(runs, suffix):
    tmp = runs["tmp"]
    jax_bytes = open(f"{tmp}/jax{suffix}", "rb").read()
    assert open(f"{tmp}/port{suffix}", "rb").read() == jax_bytes
    texts = tdistill.load_pairs(runs["pickle"])[0]
    jdistill.build_corpus_vocab(texts, f"{tmp}/again_jax.txt")
    tdistill.build_corpus_vocab(texts, f"{tmp}/again_port.txt")
    assert open(f"{tmp}/again_port.txt", "rb").read() == open(f"{tmp}/again_jax.txt", "rb").read()


@pytest.mark.parametrize("steps,lr", [(1, 1e-3), (3, 4e-4), (4, 4e-4), (8, 1e-3),
                                      (50, 4e-4), (803, 2e-4), (12000, 4e-4)])
def test_schedule_equals_optax(steps, lr):
    """At every count of the run and past its end, within float32 rounding
    of optax's values both eager and jitted (the two differ in the last
    bit): 4e-7 relative, or 1e-7 of the peak rate (float32's cosine near
    -1), and exactly 0 at count 0 when there is a warmup."""
    import jax
    import jax.numpy as jnp
    import optax

    sched = optax.warmup_cosine_decay_schedule(
        0.0, lr, warmup_steps=min(200, steps // 4), decay_steps=steps, end_value=lr * 0.02)
    counts = np.arange(steps + 3)
    eager = np.asarray(sched(jnp.asarray(counts, jnp.int32)))
    jitted = np.asarray(jax.jit(jax.vmap(sched))(jnp.asarray(counts, jnp.int32)))
    got = np.array([tdistill.learning_rate(int(c), lr, steps) for c in counts])
    for want in (eager, jitted):
        np.testing.assert_allclose(got, want, rtol=4e-7, atol=1e-7 * lr)
    if steps >= 4:
        assert got[0] == 0.0  # optax's first update takes lr 0


def test_optimizer_takes_the_schedule_before_each_step(runs):
    """In a short run each AdamW step runs at optax's rate for the count
    before it, and the first (lr 0) moves no parameter."""
    import jax.numpy as jnp
    import optax

    steps, lr = 8, 1e-3
    sched = optax.warmup_cosine_decay_schedule(0.0, lr, 2, steps, lr * 0.02)
    texts, targets = tdistill.load_pairs(runs["pickle"])
    tok = tminilm.WordPieceTokenizer(f"{runs['tmp']}/port_vocab.txt", max_len=8)
    ids, mask = tok.encode_batch(texts)
    cfg = tminilm.MiniLMConfig(vocab_size=tok.vocab_size, max_position=8, num_layers=1)
    trainer = tdistill.Distiller(tminilm.MiniLMEncoder(cfg), ids, mask, targets, lr=lr,
                                 steps=steps)
    first = [p.detach().clone() for p in trainer.model.parameters()]
    for count in range(steps):
        trainer.step(torch.arange(4))
        assert trainer.optimizer.param_groups[0]["lr"] == pytest.approx(
            float(np.asarray(sched(jnp.int32(count)))), rel=4e-7, abs=1e-7 * lr)
        if count == 0:
            assert all(torch.equal(a, b) for a, b in zip(first, trainer.model.parameters()))
    assert trainer.count == steps


def test_fresh_encoder_initializes_as_flax():
    """Per leaf: the standard deviation within 5% of Flax's, kernels inside
    Flax's truncation (2 / 0.8796 / sqrt(fan_in)), biases zero, LayerNorm
    scales one; the default generator is left alone."""
    cfg = tminilm.MiniLMConfig(vocab_size=3777, max_position=192)
    state = torch.random.get_rng_state()
    port = tminilm.state_to_flax(tminilm.MiniLMEncoder(cfg, torch.Generator().manual_seed(0)))
    assert torch.equal(state, torch.random.get_rng_state())
    import flax.traverse_util as tu

    flax = {"/".join(k): np.asarray(v) for k, v in tu.flatten_dict(
        jminilm.FlaxMiniLMEmbedder(jminilm.MiniLMConfig(vocab_size=3777, max_position=192),
                                   seed=0).params).items()}
    assert sorted(port) == sorted(flax)
    for name, want in flax.items():
        got = port[name]
        assert got.shape == want.shape, name
        if name.endswith("/bias"):
            assert not got.any(), name
        elif name.endswith("/scale"):
            assert (got == 1).all(), name
        else:
            assert abs(got.std() / want.std() - 1) < 0.05, (name, got.std(), want.std())
            assert abs(got.mean()) < 0.1 * want.std(), name
            if name.endswith("/kernel"):
                fan_in = 1536 if "Dense_1" in name else 384
                bound = 2.0 / 0.87962566103423978 / np.sqrt(fan_in)
                assert np.abs(got).max() <= bound * (1 + 1e-6), name
                assert np.abs(got).max() > 0.95 * bound, name  # the tails reach it


def test_reports_match_jax(runs):
    port = runs["port"]["reports"]
    assert [r["step"] for r in port] == [r["step"] for r in runs["jax"]] == [2, 4]
    for p, j in zip(port, runs["jax"]):
        for key in ("loss", "cos_mean", "cos_min"):
            assert abs(p[key] - j[key]) <= TOL, (key, p, j)
    assert port[-1]["loss"] < port[0]["loss"]


def test_output_embeddings_match_jax(runs):
    tmp = runs["tmp"]
    texts = tdistill.load_pairs(runs["pickle"])[0]
    j = jminilm.load_distilled_embedder(f"{tmp}/jax").encode(texts)
    t = runs["port"]["embedder"].encode(texts)
    assert np.abs(t - j).max() <= TOL


def test_parameters_within_adam_steps_of_jax(runs):
    """Every leaf within 2 x steps x lr of JAX's (Adam's step bounds what
    rounding can do to a leaf whose gradient is zero up to rounding: the
    attention key biases, which softmax's shift invariance leaves
    untrained).  That bound alone would pass a run that moved nothing (the
    whole run's Adam movement is below it), so each other leaf's distance
    from JAX's is also held to 1e-3 of the distance JAX's run moved it."""
    tmp = runs["tmp"]
    init = runs["init"]
    with np.load(f"{tmp}/jax.npz") as jz, np.load(f"{tmp}/port.npz") as tz:
        assert sorted(jz.files) == sorted(tz.files) == sorted(init)
        diffs = np.concatenate([np.abs(tz[k] - jz[k]).ravel() for k in jz.files])
        rel = {k: np.linalg.norm(tz[k] - jz[k]) / max(np.linalg.norm(jz[k] - init[k]), 1e-30)
               for k in jz.files if not k.endswith("/key/bias")}
    assert diffs.max() <= 2 * STEPS * LR
    assert len(rel) == 101 - 6
    worst = max(rel, key=rel.get)
    assert rel[worst] <= 1e-3, (worst, rel[worst])
    print(f"parameters: max |diff| {diffs.max():.3g}; share beyond 1e-5 "
          f"{np.mean(diffs > 1e-5):.3g}; largest distance relative to JAX's "
          f"movement {rel[worst]:.3g} ({worst})")


def _leaves_equal(a, b):
    with np.load(a) as za, np.load(b) as zb:
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            assert za[k].dtype == zb[k].dtype and za[k].shape == zb[k].shape, k
            np.testing.assert_array_equal(za[k], zb[k], err_msg=k)


def test_checkpoint_layout_equals_jax(runs):
    """The port's checkpoint holds JAX's leaves: 101 parameters, 204
    optimizer leaves (Adam's count, 101 + 101 moments, the schedule's
    count), `__step__`, each of JAX's shape and dtype."""
    tmp = runs["tmp"]
    with np.load(f"{tmp}/jax_ckpt.step2.npz") as jz, np.load(f"{tmp}/port_ckpt.step2.npz") as tz:
        assert sorted(jz.files) == sorted(tz.files)
        assert sum(k.startswith("p/") for k in tz.files) == 101
        assert sum(k.startswith("o/") for k in tz.files) == 204
        for k in jz.files:
            assert (tz[k].shape, tz[k].dtype) == (jz[k].shape, jz[k].dtype), k
        assert int(tz["__step__"]) == 2
        assert int(tz["o/leaf_00000"]) == int(tz["o/leaf_00203"]) == 2


def test_resumed_port_run_is_bit_identical(runs, tmp_path):
    """Interrupted after its first chunk (the checkpoint of step 2), the
    port resumes to step 4 with exactly the uninterrupted run's state."""
    tmp = runs["tmp"]
    ck = str(tmp_path / "ckpt.npz")
    shutil.copy(f"{tmp}/port_ckpt.step2.npz", ck)
    res = tdistill.main(ARGS + ["--pickle", runs["pickle"], "--out", str(tmp_path / "port"),
                                "--device", "cpu", "--resume", ck], init=None)
    assert [r["step"] for r in res["reports"]] == [4]
    _leaves_equal(ck, f"{tmp}/port_ckpt.step4.npz")
    _leaves_equal(str(tmp_path / "port.npz"), f"{tmp}/port.npz")
    assert {k: v for k, v in res["reports"][0].items() if k != "elapsed_s"} == {
        k: v for k, v in runs["port"]["reports"][-1].items() if k != "elapsed_s"}


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoints_resume_across_packages(runs, tmp_path, direction):
    """A step-2 checkpoint of either package resumes in the other to step 4
    and ends within the packages' tolerance of the writer's own run."""
    tmp = runs["tmp"]
    ck = str(tmp_path / "ckpt.npz")
    writer, reader = direction.split("_to_")
    shutil.copy(f"{tmp}/{writer}_ckpt.step2.npz", ck)
    out = str(tmp_path / reader)
    if reader == "port":
        reports = tdistill.main(ARGS + ["--pickle", runs["pickle"], "--out", out,
                                        "--device", "cpu", "--resume", ck])["reports"]
    else:
        with pytest.MonkeyPatch.context() as mp:
            reports = run_jax(mp, tmp, runs["pickle"], ARGS + ["--out", out, "--resume", ck])
    want = runs["jax"] if writer == "jax" else runs["port"]["reports"]
    assert [r["step"] for r in reports] == [4]
    for key in ("loss", "cos_mean", "cos_min"):
        assert abs(reports[0][key] - want[-1][key]) <= TOL, key
    with np.load(out + ".npz") as got, np.load(f"{tmp}/{writer}.npz") as ref:
        assert max(np.abs(got[k] - ref[k]).max() for k in ref.files) <= 2 * STEPS * LR


def _close(a, b, path=""):
    """Equal keys, numbers within TOL, anything else equal."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            if k != "elapsed_s":
                _close(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (int, float)) and not isinstance(a, bool):
        assert abs(a - b) <= TOL, (path, a, b)
    else:
        assert a == b, path


def test_holdout_report_matches_jax(runs):
    tmp = runs["tmp"]
    jax_report = json.load(open(f"{tmp}/tools/minilm_holdout_report.json"))
    port_report = json.load(open(f"{tmp}/port_holdout_report.json"))
    _close(port_report, jax_report)
    assert port_report == json.loads(json.dumps(runs["port_holdout"]["holdout"]))
    _close(*(json.load(open(f"{tmp}/{w}_holdout_meta.json")) for w in ("port", "jax")))
    assert not os.path.exists(f"{tmp}/benchmarks/results.json")


@pytest.mark.parametrize("kind", ["", "_holdout"])
def test_artifacts_load_in_both_packages(runs, kind):
    """The port's artifacts load in JAX's `load_distilled_embedder` and the
    JAX tool's in the port's, with equal embeddings (1e-5)."""
    tmp = runs["tmp"]
    texts = tdistill.load_pairs(runs["pickle"])[0][:8]
    for writer in ("jax", "port"):
        j = jminilm.load_distilled_embedder(f"{tmp}/{writer}{kind}")
        t = tminilm.load_distilled_embedder(f"{tmp}/{writer}{kind}", device="cpu")
        assert j is not None and t is not None
        assert np.abs(t.encode(texts) - j.encode(texts)).max() <= 1e-5
    pmeta = json.load(open(f"{tmp}/port{kind}_meta.json"))
    jmeta = json.load(open(f"{tmp}/jax{kind}_meta.json"))
    assert sorted(pmeta) == sorted(jmeta) and pmeta["config"] == jmeta["config"]
    if not kind:
        assert pmeta["source"] == os.path.abspath(runs["pickle"])


def test_device_defaults_to_cuda(runs, tmp_path):
    argv = ARGS + ["--pickle", runs["pickle"], "--out", str(tmp_path / "x")]
    if torch.cuda.is_available():
        assert tdistill.parse_args(argv).device is None
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        tdistill.main(argv)
    with pytest.raises(RuntimeError, match="CUDA"):
        tdistill.main(argv + ["--device", "cuda"])
    assert not os.path.exists(tmp_path / "x.npz")


def test_default_paths_stay_out_of_the_jax_package():
    args = tdistill.parse_args([])
    assert args.out == tdistill.DEFAULT_OUT
    assert args.out.startswith(os.path.join(ROOT, "hcrag_tpu_torch", "_trained") + os.sep)
    assert args.pickle == "experiments/knowledge_graph_embeddings.pkl"


def test_no_repo_file_changed(runs):
    """Every run above left the repo's tools/ and benchmarks/ as they were."""
    assert _repo_files() == runs["before"]
