"""The port's parity tools (`hcrag_tpu_torch/tools/verify_parity.py`,
`agent_trace_fixture.py`) against the JAX package's (`tools/`), on the CPU,
over the seeded corpus (`testing.seeded_corpus`: 589 rows, its pickle the
hashing embedder's vectors).

The JAX tools run unmodified, their reference paths redirected onto the
seeded corpus: `build_adventureworks` and `process_corpus` patched on
`hcrag_tpu.ingest.adventureworks` (the tools import them inside their
functions), and `PKL`.

  * Every check line that both tools print is the same line.  The port
    skips the two checks that need the reference export (its 585 ids, and
    the committed fixture written from them) and checks instead that its
    traces equal a fixture it regenerates; it exits 0.
  * The port's agent traces equal JAX's field for field, and hold the
    reference's invariants.
  * `agent_trace_fixture --check` exits 0 against a fixture it regenerated
    and 1 against one with a score changed; neither tool writes under
    `tools/`.
"""

import contextlib
import hashlib
import io
import json
import os

import pytest

import tools.agent_trace_fixture as jatf
import tools.verify_parity as jverify
from hcrag_tpu_torch.testing import seeded_corpus
from hcrag_tpu_torch.tools import agent_trace_fixture as tatf
from hcrag_tpu_torch.tools import verify_parity as tverify

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE_ONLY = {"all 585 ids covered", "deterministic replay == fixture"}


def _tools_digests():
    out = {}
    for d, _, files in os.walk(os.path.join(ROOT, "tools")):
        if "__pycache__" not in d:
            for f in files:
                p = os.path.join(d, f)
                out[p] = hashlib.sha256(open(p, "rb").read()).hexdigest()
    return out


def _checks(text):
    """check name -> its line, for the `[PASS]` / `[FAIL]` / `[SKIP]` lines."""
    out = {}
    for line in text.splitlines():
        for tag in ("[PASS] ", "[FAIL] ", "[SKIP] "):
            if line.startswith("  " + tag):
                rest = line[len(tag) + 2:]
                name = rest.split(" (")[0].split(" {")[0].rstrip()
                out[name] = line
    return out


@contextlib.contextmanager
def _jax_on(data, pickle):
    import hcrag_tpu.ingest.adventureworks as jaw

    build, process = jaw.build_adventureworks, jaw.process_corpus
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jaw, "build_adventureworks",
                   lambda _dir, reference_pickle=None, **kw: build(
                       data, reference_pickle=pickle, **kw))
        mp.setattr(jaw, "process_corpus", lambda _dir: process(data))
        mp.setattr(jverify, "PKL", pickle)
        mp.setattr(jatf, "PKL", pickle)
        yield


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    before = _tools_digests()
    tmp = str(tmp_path_factory.mktemp("parity"))
    data, pickle = seeded_corpus(tmp)
    out = {"tmp": tmp, "data": data, "pickle": pickle}
    with _jax_on(data, pickle):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), pytest.raises(SystemExit) as exit_:
            jverify.main()
        out["jax_verify"], out["jax_exit"] = buf.getvalue(), exit_.value.code
        out["jax_traces"] = jatf.run_traces()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out["port_exit"] = tverify.main(["--data", data, "--pickle", pickle, "--device", "cpu"])
    out["port_verify"] = buf.getvalue()
    out["port_traces"] = tatf.run_traces(data, pickle, "cpu")
    fixture = os.path.join(tmp, "fixture", "traces.json")
    argv = ["--data", data, "--pickle", pickle, "--device", "cpu"]
    with contextlib.redirect_stdout(io.StringIO()):
        out["write_exit"] = tatf.main(argv + ["--out", fixture])
        out["check_exit"] = tatf.main(argv + ["--check", "--fixture", fixture])
        with open(fixture) as f:
            bad = json.load(f)
        step = next(s for q in tatf.QUESTIONS for s in bad[q]["steps"] if s["final_scores"])
        step["final_scores"][0] += 1e-6
        changed = os.path.join(tmp, "fixture", "changed.json")
        with open(changed, "w") as f:
            json.dump(bad, f)
        out["changed_exit"] = tatf.main(argv + ["--check", "--fixture", changed])
    out["fixture"] = fixture
    out["digests"] = (before, _tools_digests())
    return out


def test_port_verify_passes_and_skips_only_the_reference_checks(runs):
    checks = _checks(runs["port_verify"])
    assert runs["port_exit"] == 0, runs["port_verify"]
    assert "OVERALL: PASS" in runs["port_verify"]
    assert {n for n, line in checks.items() if "[SKIP]" in line} == REFERENCE_ONLY
    assert not any("[FAIL]" in line for line in checks.values())
    assert "[PASS] deterministic replay == regenerated fixture" in \
        checks["deterministic replay == regenerated fixture"]


def test_check_lines_equal_jax(runs):
    """Every check both tools make prints the same line (JAX's seeded run
    fails its committed-fixture check, which the port skips, so it exits
    1)."""
    port, jax_ = _checks(runs["port_verify"]), _checks(runs["jax_verify"])
    both = set(port) & set(jax_) - REFERENCE_ONLY
    assert len(both) == 11
    for name in sorted(both):
        assert port[name] == jax_[name], name
    assert set(jax_) - set(port) == set()
    assert runs["jax_exit"] == 1 and "[FAIL] deterministic replay == fixture" in \
        jax_["deterministic replay == fixture"]


def test_traces_equal_jax(runs):
    port, jax_ = runs["port_traces"], runs["jax_traces"]
    assert sorted(port) == sorted(jax_)
    for q in jax_:
        for field in jax_[q]:
            assert port[q][field] == jax_[q][field], (q, field)


def test_traces_hold_the_invariants(runs):
    assert tatf.check_invariants(runs["port_traces"]) == []
    assert jatf.check_invariants(runs["port_traces"]) == []
    decisions = [runs["port_traces"][q]["decision"] for q in tatf.QUESTIONS]
    assert "sufficient" in decisions


def test_fixture_check_exit_codes(runs):
    assert runs["write_exit"] == 0 and os.path.exists(runs["fixture"])
    assert runs["check_exit"] == 0
    assert runs["changed_exit"] == 1


def test_tools_write_nothing_under_tools(runs):
    before, after = runs["digests"]
    assert before == after
    assert not tatf.DEFAULT_OUT.startswith(os.path.join(ROOT, "tools") + os.sep)
    assert tatf.COMMITTED_FIXTURE == jatf.FIXTURE


def test_tools_raise_without_cuda(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (tverify.main, tatf.main):
        with pytest.raises(RuntimeError, match="CUDA"):
            main([])
