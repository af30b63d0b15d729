"""`python -m hcrag_tpu_torch.benchmarks.ab_executor` on the CPU (10,000
rows, 2,048 requests a drain), with this tree as its own parent: the
alternating turns, every drain's results equal across turns and trees, and
the JSON line's keys."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_ab_executor_against_itself():
    proc = subprocess.run(
        [sys.executable, "-m", "hcrag_tpu_torch.benchmarks.ab_executor", ROOT,
         "--device", "cpu"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.splitlines()
    turns = [ln.split(" ", 1)[0] for ln in lines[:-1]]
    assert turns == ["parent", "change", "change", "parent"] * 2 + ["parent", "change"]
    row = json.loads(lines[-1])
    assert row["device"] == "cpu" and row["requests_a_drain"] == 2048
    for tree in ("parent", "change"):
        assert len(row[tree]["turns_rps"]) == 5
        assert all(len(t) == 3 and min(t) > 0 for t in row[tree]["turns_rps"])
    assert row["change_over_parent"] > 0
