"""The benchmark's specification: `BENCHMARK.json` and the files it names.

A cell `<config>.<traffic>` is one entry of `workloads`.  Everything that
belongs to it is found by name, so a later change adds a configuration, a
traffic mix, a metric or a cell's limits by adding files and entries:

  * `hcbench/configs/<config>.json`  the deployment (the `file` of its entry),
    whose `kind` key names its kind;
  * `hcbench/kinds/<kind>.py`        the kind: the data, the system, the
    loops, the reference, the judge and the traffic's check, by the names
    `hcbench/kinds/__init__.py` lists;
  * `hcbench/traffic/<traffic>.json` the traffic mix, read by the kind's loop
    its `loop` key names;
  * `hcbench/limits/<cell>.json`     the limit of each number compared;
  * `hcbench/metrics/<metric>.py`    one reader per metric, end to end or
    per layer: `read(run) -> float | None`.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parent.parent
PKG = "hcbench"
#: What a kind module defines (`hcbench/kinds/__init__.py`).
KIND_NAMES = ("make_inputs", "System", "LOOPS", "Reference", "lowered", "judge",
              "control_outputs", "work_problem", "trace_info", "finish_info")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: Dict
    traffic_name: str
    traffic: Dict
    limits: Dict[str, float]
    end_to_end: List[Dict]  # the end-to-end metrics this cell reports
    per_layer: List[Dict]  # the per-layer metrics this cell reports
    root: Path
    kind: ModuleType  # hcbench/kinds/<config's kind>.py

    def reader(self, metric: str) -> Callable[[Dict], Optional[float]]:
        return metric_reader(metric, self.root)


def load_benchmark(root: Path = ROOT) -> Dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _read_json(path: Path) -> Dict:
    if not path.is_file():
        raise FileNotFoundError(f"the benchmark names {path}, which is missing")
    return json.loads(path.read_text())


def _applies(metric: Dict, cell: str, e2e_names: Optional[List[str]] = None) -> bool:
    """Whether `metric` is reported in `cell`: the cells of its `workloads`
    key; without one, every cell (an end-to-end metric) or every cell that
    reports the end-to-end metric it moves (a per-layer metric)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_names is None or metric["moves"] in e2e_names


def load_cell(name: str, root: Path = ROOT, bench: Optional[Dict] = None,
              draft: bool = False) -> Cell:
    """The cell `name` of BENCHMARK.json.  With `draft`, a cell
    `<config>.<traffic>` that BENCHMARK.json does not list yet is built from
    its files alone, on one chip and with no metrics: the control tool and
    the tests take a cell so before it is proposed."""
    root = Path(root)
    bench = load_benchmark(root) if bench is None else bench
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        if not draft:
            known = ", ".join(w["name"] for w in bench["workloads"])
            raise KeyError(f"no workload {name!r} in BENCHMARK.json (known: {known})")
        config_name, _, traffic_name = name.partition(".")
        entry = dict(name=name, config=config_name, traffic=traffic_name, chips=1)
    cfg_entry = next((c for c in bench["configs"] if c["name"] == entry["config"]), None)
    cfg_file = cfg_entry["file"] if cfg_entry else f"{PKG}/configs/{entry['config']}.json"
    config = _read_json(root / cfg_file)
    kind = load_kind(config, root / cfg_file, root)
    traffic = _read_json(root / PKG / "traffic" / f"{entry['traffic']}.json")
    limits = _read_json(root / PKG / "limits" / f"{name}.json")
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    e2e_names = [m["name"] for m in e2e]
    per_layer = [m for m in bench["per_layer"] if _applies(m, name, e2e_names)]
    problem = kind.work_problem(traffic, config)
    if problem:
        raise ValueError(f"traffic {entry['traffic']!r} refused: {problem}")
    return Cell(name, int(entry["chips"]), entry["config"], config, entry["traffic"],
                traffic, limits, e2e, per_layer, root, kind)


def load_kind(config: Dict, config_path: Path, root: Path = ROOT) -> ModuleType:
    """The module `hcbench/kinds/<kind>.py` that `config` (read from
    `config_path`) names by its `kind` key, loaded by its path."""
    if "kind" not in config:
        raise ValueError(f"{config_path} names no kind: give it a \"kind\" key, the name "
                         f"of a module in {Path(root) / PKG / 'kinds'}")
    path = Path(root) / PKG / "kinds" / f"{config['kind']}.py"
    if not path.is_file():
        raise FileNotFoundError(f"{config_path} names the kind {config['kind']!r}, "
                                f"which has no module at {path}")
    module = _load(path, f"hcbench_kind_{config['kind']}")
    missing = [n for n in KIND_NAMES if not hasattr(module, n)]
    if missing:
        raise AttributeError(f"the kind module {path} lacks {', '.join(missing)}")
    return module


def fixed_work_problem(traffic: Dict, config: Dict) -> Optional[str]:
    """Why a traffic's work could depend on the seed, or None: the
    retrieval kind's `work_problem`.

    The expansion stops after the hop at which every query of the batch
    holds `max_expanded` nodes.  After h hops a query holds at most
    top_k * (M + M^2 + ... + M^h) nodes, M the ELL table's width, so the
    exit can never fire before the last hop when `max_expanded` exceeds
    that sum for h = depth - 1: every batch then runs every hop and makes
    the same host syncs, whatever the data.  Depth 1 has no exit."""
    depth, top_k = int(traffic["depth"]), int(traffic["top_k"])
    m = int(config["graph"]["ell_max_degree"])
    reach = top_k * sum(m ** h for h in range(1, depth))
    if depth > 1 and int(traffic["max_expanded"]) <= reach:
        return (f"max_expanded {traffic['max_expanded']} does not exceed top_k x "
                f"(M + ... + M^{depth - 1}) = {reach}: the early exit could stop "
                "before the last hop on some seeds and not on others")
    return None


def metric_reader(metric: str, root: Path = ROOT) -> Callable[[Dict], Optional[float]]:
    """`read` of `hcbench/metrics/<metric>.py`, loaded by its path (a
    metric's name may hold dots)."""
    path = Path(root) / PKG / "metrics" / f"{metric}.py"
    if not path.is_file():
        raise FileNotFoundError(f"metric {metric!r} has no reader at {path}")
    return _load(path, f"hcbench_metric_{metric}").read


def _load(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
