"""The command itself: without a card it prints no result and exits with a
code other than 0; on the card (marked `cuda`) one short traced run of a
cell prints a correct result line with its device's busy time."""

import json
import subprocess
import sys

import pytest

from hcbench.spec import ROOT


def _run(*args, timeout=600):
    return subprocess.run([sys.executable, "-m", "hcbench.run", *args], cwd=str(ROOT),
                          capture_output=True, text=True, timeout=timeout)


@pytest.fixture
def no_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: runs a cell of the benchmark on the card")


def test_without_a_card_no_result(no_card):
    res = _run("--workload", "kg1m_int8.batch8k", "--seed", "1", "--seconds", "1",
               "--trace", "0", timeout=120)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "CUDA device" in res.stderr


def test_an_unknown_cell_is_refused():
    res = _run("--workload", "kg1m_int8.nothing", "--seed", "1", "--seconds", "1", timeout=120)
    assert res.returncode != 0 and res.stdout.strip() == ""


@pytest.mark.cuda
def test_a_cell_runs_on_the_card(card):
    res = _run("--workload", "kg1m_bf16.batch1k", "--seed", "7", "--seconds", "2",
               "--trace", "1")
    assert res.returncode == 0, res.stderr[-3000:]
    r = json.loads(res.stdout.strip().splitlines()[-1])
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["busy_s"] > 0
    assert list(r)[-1] == "checks"
    assert {"select_roofline", "device_idle_pct", "issue_ms"} <= set(r["metrics"])
