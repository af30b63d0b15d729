"""The port's bench (`python -m hcrag_tpu_torch.bench`) on the CPU at a
small BENCH_N beside the repository's `bench.py` (JAX, direct mode): the
same one-line JSON keys, the recall gate held, and the resolved kernel
config carrying every key JAX's does."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(BENCH_N="4096", BENCH_BATCH="64", BENCH_STEPS="1", BENCH_GATE_QUERIES="64")


def _run(cmd, extra=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT, **SMALL, **(extra or {}))
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    assert len(lines) == 1, proc.stdout
    return json.loads(lines[0]), proc.stderr


@pytest.fixture(scope="module")
def jax_row():
    return _run([sys.executable, "bench.py"], {"BENCH_DIRECT": "1"})[0]


def test_json_keys_equal_bench_py(jax_row):
    row, err = _run([sys.executable, "-m", "hcrag_tpu_torch.bench", "--device", "cpu"])
    assert set(row) == set(jax_row)
    assert set(row["config"]) == set(jax_row["config"])
    assert set(jax_row["config"]["resolved_kernel"]) <= set(row["config"]["resolved_kernel"])
    assert row["config"]["recall_at_10"] >= 0.998
    assert row["config"]["resolved_kernel"]["device"] == "cpu"
    assert "device=cpu" in err
    for key in ("index_rows", "batch", "top_k", "expansion_depth", "dtype", "int8_mode",
                "recall_gate_queries"):
        assert row["config"][key] == jax_row["config"][key], key


@pytest.mark.parametrize("extra", [
    dict(BENCH_DTYPE="bfloat16", BENCH_RESCORE="0", BENCH_TEXT="0"),
    dict(BENCH_DTYPE="bfloat16", BENCH_TEXT="0"),
    dict(BENCH_INT8_MODE="residual", BENCH_TEXT="0"),
    dict(BENCH_INT8_MODE="only", BENCH_TEXT="0", BENCH_PALLAS="1"),
])
def test_modes_run_and_pass_the_gate(extra, monkeypatch):
    from hcrag_tpu_torch import bench

    for k, v in {**SMALL, **extra}.items():
        monkeypatch.setenv(k, v)
    row = bench.run("cpu")
    assert row["config"]["recall_at_10"] >= 0.95
    assert "qps_text_to_results" not in row and row["value"] > 0


def test_use_pallas_off_is_refused(monkeypatch):
    from hcrag_tpu_torch import bench

    for k, v in {**SMALL, "BENCH_PALLAS": "0", "BENCH_TEXT": "0"}.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match="use_pallas"):
        bench.run("cpu")


def test_gate_fails_where_bench_py_fails():
    """int8 selection with the rescore from bf16 rows at 4,096 rows cannot
    order f32 near-ties: both benches print the same recall and exit 3."""
    extra = dict(BENCH_INT8_MODE="", BENCH_TEXT="0")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT, **SMALL, **extra)
    lines = []
    for cmd, more in (([sys.executable, "bench.py"], {"BENCH_DIRECT": "1"}),
                      ([sys.executable, "-m", "hcrag_tpu_torch.bench", "--device", "cpu"], {})):
        proc = subprocess.run(cmd, cwd=ROOT, env=dict(env, **more), capture_output=True,
                              text=True, timeout=600)
        assert proc.returncode == 3 and not proc.stdout.strip()
        lines.append([ln for ln in proc.stderr.splitlines() if "RECALL GATE" in ln])
    assert lines[0] == lines[1] and len(lines[0]) == 1
