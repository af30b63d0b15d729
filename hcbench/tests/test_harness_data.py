"""A configuration, a traffic mix, a metric and a cell's limits added as
files and entries in a copy of the benchmark are found by name, and a cell
built from them runs, without an edit to any file already there."""

import hashlib
import json
import shutil

from hcbench.spec import ROOT
from hcbench.tests.small import run_small, small_cell


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "hcbench").rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_cell_added_as_data_runs(tmp_path):
    shutil.copytree(ROOT / "hcbench", tmp_path / "hcbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(tmp_path)
    pkg = tmp_path / "hcbench"
    config = json.loads((pkg / "configs" / "kg1m_int8.json").read_text())
    config.update(name="kg20k_f32", rows=20000, engine={},
                  select_bank="f32",
                  precision={"scores": {"rows": "f32", "queries": "f32"},
                             "expanded": {"rows": "f32", "queries": "f32"}})
    (pkg / "configs" / "kg20k_f32.json").write_text(json.dumps(config))
    (pkg / "traffic" / "twohop.json").write_text(json.dumps(
        {"loop": "closed", "batch": 16, "top_k": 5, "depth": 2, "max_expanded": 64,
         "in_flight": 2, "check_steps": 3, "why": "a test"}))
    (pkg / "metrics" / "steps_per_s.twohop.py").write_text(
        "def read(run):\n    return run['steps'] / run['window_s']\n")
    (pkg / "limits" / "kg20k_f32.twohop.json").write_text(json.dumps(
        {"bad_index": 0, "sel_gap": 1e-5, "score_err": 1e-5, "rel_err": 1e-5,
         "exp_mismatch": 0, "exp_rel_err": 1e-5}))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "kg20k_f32", "source": "a test",
                             "file": "hcbench/configs/kg20k_f32.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "kg20k_f32.twohop", "config": "kg20k_f32",
                               "traffic": "twohop", "chips": 1, "why": "a test"})
    bench["end_to_end"][0]["workloads"].append("kg20k_f32.twohop")
    bench["per_layer"].append({"name": "steps_per_s.twohop", "unit": "1/s", "better": "higher",
                               "source": "host_clock", "layer": "entry", "moves": "qps",
                               "workloads": ["kg20k_f32.twohop"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digests(tmp_path)
    assert all(after[p] == d for p, d in before.items())  # nothing edited

    cell = small_cell("kg20k_f32.twohop", root=tmp_path)
    assert cell.traffic["depth"] == 2 and cell.config["engine"] == {}
    out = run_small(cell)
    assert out["result"]["correct"], out["checks"]
    assert set(out["result"]["metrics"]) == {"qps", "setup_s"}
    traced = run_small(cell, trace=True)
    assert traced["result"]["correct"]
    assert "steps_per_s.twohop" in traced["result"]["metrics"]
    assert "issue_ms" not in traced["result"]["metrics"]  # listed for other cells
