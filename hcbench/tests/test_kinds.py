"""A configuration names its kind (`hcbench/kinds/<kind>.py`), and the harness
reaches the data, the system, the loops, the reference and the judge only
through it: the three cells run the retrieval kind, which binds the
harness's own objects; a toy kind added as new files runs through
`run.run_cell` and `control.readings`; a configuration without a kind, or
naming a missing one, is refused."""

import ast
import hashlib
import json
import shutil
import time

import pytest

from hcbench import check, data, loops, reference, system
from hcbench.bounds import select_bound_ms
from hcbench.spec import ROOT, fixed_work_problem, load_cell
from hcbench.tests.small import CELLS, CPU

RETRIEVAL = {"make_inputs": data.make_corpus, "System": system.System,
             "LOOPS": loops.LOOPS, "Reference": reference.Reference,
             "lowered": reference.lowered, "judge": check.judge,
             "control_outputs": check.control_outputs, "work_problem": fixed_work_problem}


@pytest.mark.parametrize("name", CELLS)
def test_the_cells_run_the_retrieval_kind(name):
    cell = load_cell(name)
    assert cell.config["kind"] == "retrieval" and "reference" not in cell.config
    assert cell.kind.__file__ == str(ROOT / "hcbench" / "kinds" / "retrieval.py")
    for attr, obj in RETRIEVAL.items():
        assert getattr(cell.kind, attr) is obj, attr
    cfg, tr = cell.config, cell.traffic
    assert cell.kind.trace_info(cfg, tr) == {
        "select_kernels": cfg["select_kernels"],
        "select_bound_ms": select_bound_ms(int(tr["batch"]), int(cfg["rows"]),
                                           int(cfg["dim"]), cfg["select_bank"],
                                           int(tr["top_k"]))}
    info = {"answers": 8.0, "full_subgraphs": 6.0, "queries": 8.0}
    cell.kind.finish_info(info)
    assert info == {"answers": 8.0, "full_subgraph_share": 0.75}


FORBIDDEN = {"System", "Reference", "LOOPS", "make_corpus", "judge", "lowered",
             "select_bound_ms", "fixed_work_problem"}


@pytest.mark.parametrize("module", ["run.py", "control.py"])
def test_the_harness_imports_nothing_of_a_kind(module):
    tree = ast.parse((ROOT / "hcbench" / module).read_text())
    names, modules = set(), set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            names |= {a.name for a in node.names}
            modules |= {f"{node.module}.{a.name}" for a in node.names} | {node.module}
        elif isinstance(node, ast.Import):
            modules |= {a.name for a in node.names}
    assert not names & FORBIDDEN, names
    assert not modules & {f"hcbench.{m}" for m in ("system", "reference", "loops", "bounds")}


TOY_KIND = '''"""toy: a system that sums each query's entries."""
import time

import torch


def make_inputs(config, g, device):
    return {}


class System:
    def __init__(self, config, inputs, device):
        pass

    def step(self, q, traffic):
        return q.sum(dim=1)


class Loop:
    def __init__(self, system, traffic, g, seed, device, dim):
        self.system, self.traffic, self.g, self.device, self.dim = system, traffic, g, device, dim
        self.kept = []

    def queries(self):
        return torch.randn((int(self.traffic["batch"]), self.dim), generator=self.g,
                           device=self.device)

    def warm_up(self):
        self.system.step(self.queries(), self.traffic)

    def window(self, seconds, tracer=None):
        t0, steps = time.monotonic(), 0
        while time.monotonic() - t0 < seconds:
            q = self.queries()
            out = self.system.step(q, self.traffic)
            if len(self.kept) < int(self.traffic["check_steps"]):
                self.kept.append((q, out))
            steps += 1
        n = steps * int(self.traffic["batch"])
        return dict(steps=steps, sums=n, attempted=n, failed=0,
                    window_s=time.monotonic() - t0)

    def kept_batches(self):
        return list(self.kept)

    def close(self):
        self.kept = []


LOOPS = {"toy": Loop}
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


class Reference:
    def __init__(self, config, inputs, device, precision=None):
        self.dtype = DTYPES[precision or config["precision"]]

    def sums(self, q):
        return q.to(self.dtype).to(torch.float64).sum(dim=1)


def lowered(precision):
    return {"f32": "bf16"}[precision]


def judge(ref, traffic, batches):
    err = max(float((out.to(torch.float64) - ref.sums(q)).abs().max()) for q, out in batches)
    return {"sum_err": err}, {"answers": float(sum(q.shape[0] for q, _ in batches))}


def control_outputs(low, traffic, q):
    return low.sums(q)


def work_problem(traffic, config):
    return None


def trace_info(config, traffic):
    return {}


def finish_info(info):
    pass
'''


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "hcbench").rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


@pytest.fixture
def toy_root(tmp_path):
    """A copy of the benchmark with a toy kind, its configuration, traffic,
    limits, reader and cell, added as new files and entries."""
    shutil.copytree(ROOT / "hcbench", tmp_path / "hcbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(tmp_path)
    pkg = tmp_path / "hcbench"
    (pkg / "kinds" / "toy.py").write_text(TOY_KIND)
    (pkg / "configs" / "sums.json").write_text(json.dumps(
        {"name": "sums", "kind": "toy", "dim": 16, "precision": "f32"}))
    (pkg / "traffic" / "toy8.json").write_text(json.dumps(
        {"loop": "toy", "batch": 8, "check_steps": 3, "why": "a test"}))
    (pkg / "limits" / "sums.toy8.json").write_text(json.dumps({"sum_err": 1e-4}))
    (pkg / "metrics" / "sums_per_s.py").write_text(
        "def read(run):\n    return run['sums'] / run['window_s']\n")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "sums", "source": "a test",
                             "file": "hcbench/configs/sums.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "sums.toy8", "config": "sums", "traffic": "toy8",
                               "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "sums_per_s", "unit": "sums/s", "better": "higher",
                                "bound": 0.01, "source": "host_clock",
                                "workloads": ["sums.toy8"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digests(tmp_path)
    assert all(after[p] == d for p, d in before.items())  # nothing edited
    return tmp_path


def _run(cell):
    from hcbench.run import run_cell

    return run_cell(cell, 2**31 + 71, 0.3, False, CPU, time.monotonic())


def test_a_new_kind_runs_from_new_files(toy_root):
    from hcbench.control import readings

    cell = load_cell("sums.toy8", root=toy_root)
    assert cell.kind.__file__ == str(toy_root / "hcbench" / "kinds" / "toy.py")
    out = _run(cell)
    assert out["result"]["correct"], out["checks"]
    assert set(out["result"]["metrics"]) == {"sums_per_s", "setup_s"}
    assert out["info"]["answers"] == 24
    [row] = readings([cell], 2**31 + 72, 0.3, CPU)
    assert row["workload"] == "sums.toy8"
    assert row["program"]["sum_err"] <= cell.limits["sum_err"] < row["control"]["sum_err"]


def test_a_new_kind_with_an_altered_answer_is_not_correct(toy_root, monkeypatch):
    cell = load_cell("sums.toy8", root=toy_root)
    real = cell.kind.System.step

    def altered(self, q, traffic):
        out = real(self, q, traffic).clone()
        out[0] += 1.0
        return out

    monkeypatch.setattr(cell.kind.System, "step", altered)
    out = _run(cell)
    assert not out["result"]["correct"], out["checks"]


@pytest.mark.parametrize("kind", [None, "nothing"])
def test_a_config_without_a_kind_module_is_refused(tmp_path, kind):
    shutil.copytree(ROOT / "hcbench", tmp_path / "hcbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    path = tmp_path / "hcbench" / "configs" / "kg1m_bf16.json"
    config = json.loads(path.read_text())
    if kind is None:
        del config["kind"]
    else:
        config["kind"] = kind
    path.write_text(json.dumps(config))
    want = path if kind is None else tmp_path / "hcbench" / "kinds" / f"{kind}.py"
    with pytest.raises((ValueError, FileNotFoundError)) as err:
        load_cell("kg1m_bf16.graph3", root=tmp_path)
    assert str(want) in str(err.value)


def test_a_kind_module_must_define_every_name(tmp_path):
    shutil.copytree(ROOT / "hcbench", tmp_path / "hcbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    kind = tmp_path / "hcbench" / "kinds" / "retrieval.py"
    kind.write_text(kind.read_text().replace("finish_info", "finish"))
    with pytest.raises(AttributeError, match="finish_info"):
        load_cell("kg1m_bf16.batch1k", root=tmp_path)
