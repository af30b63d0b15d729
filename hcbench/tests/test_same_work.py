"""Every traffic gives every seed the same work: the same batch and sizes,
the same expansion hops at the same widths; no batch of queries is sent
twice; and a traffic whose expansion could stop early on some seeds is
refused."""

import json
import shutil

import pytest
import torch

from hcbench import data
from hcbench.loops import LOOPS
from hcbench.spec import ROOT, fixed_work_problem, load_cell
from hcbench.system import System
from hcbench.tests.small import CELLS, CPU, small_cell

SEEDS = (2**31 + 101, 2**31 + 202)


def _loop(cell, seed):
    g = data.generator(seed, CPU)
    corpus = data.make_corpus(cell.config, g, CPU)
    system = System(cell.config, corpus, CPU)
    return LOOPS[cell.traffic["loop"]](system, cell.traffic, g, seed, CPU,
                                       int(cell.config["dim"]))


def program_work(cell, seed):
    """What the program does for one step: the sizes, and every expansion
    hop's dedup width."""
    import hcrag_tpu_torch.ops.expand as expand

    loop = _loop(cell, seed)
    widths = []
    real = expand.dedup_and_cap

    def recording(cands, *a, **k):
        widths.append(tuple(cands.shape))
        return real(cands, *a, **k)

    expand.dedup_and_cap = recording
    try:
        out = loop.system.step(loop.queries(), cell.traffic)
    finally:
        expand.dedup_and_cap = real
    return {"batch": tuple(out[0].shape), "expanded": tuple(out[4].shape), "hops": widths}


@pytest.mark.parametrize("name", CELLS)
def test_every_seed_gets_the_same_work(name):
    cell = small_cell(name)
    cell.config["rows"] = 4000
    a, b = (program_work(cell, s) for s in SEEDS)
    assert a == b
    t = cell.traffic
    m, k = int(cell.config["graph"]["ell_max_degree"]), int(t["top_k"])
    # hop h adds top_k x M^h candidates; every hop runs
    assert a["hops"] == [(t["batch"], k * sum(m ** j for j in range(1, h + 1)))
                         for h in range(1, int(t["depth"]) + 1)]


@pytest.mark.parametrize("name", CELLS)
def test_no_batch_is_sent_twice(name):
    """Each step gets fresh queries from the seed: every kept batch differs
    from every other, and the same seed draws the same batches (over a
    one-hop traffic, for speed: the draw does not depend on the traffic)."""
    cell = small_cell(name)
    cell.config["rows"] = 2000
    cell.traffic.update(batch=4, check_steps=4, top_k=10, depth=1, max_expanded=20)
    loop = _loop(cell, SEEDS[0])
    loop.warm_up()
    run = loop.window(1.0)
    kept = [q for q, _ in loop.kept_batches()]
    loop.close()
    assert len(kept) == min(run["steps"], 4) >= 2
    assert len({tuple(q.flatten().tolist()) for q in kept}) == len(kept)
    fresh = _loop(cell, SEEDS[0])
    first = [fresh.queries() for _ in range(3)]
    again = _loop(cell, SEEDS[0])
    assert all(torch.equal(a, again.queries()) for a in first)


def test_graph3_states_its_inequality():
    cell = load_cell("kg1m_bf16.graph3")
    t, m = cell.traffic, cell.config["graph"]["ell_max_degree"]
    assert t["max_expanded"] > t["top_k"] * (m + m * m)
    assert "fixed_work" in t


@pytest.mark.parametrize("max_expanded,refused", [(7200, True), (800, True), (7201, False)])
def test_an_early_exit_that_could_fire_is_refused(max_expanded, refused):
    cell = load_cell("kg1m_bf16.graph3")
    traffic = dict(cell.traffic, max_expanded=max_expanded)
    assert (fixed_work_problem(traffic, cell.config) is not None) == refused


def test_load_refuses_such_a_traffic(tmp_path):
    shutil.copytree(ROOT / "hcbench", tmp_path / "hcbench")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    path = tmp_path / "hcbench" / "traffic" / "graph3.json"
    t = json.loads(path.read_text())
    t["max_expanded"] = 5000
    path.write_text(json.dumps(t))
    with pytest.raises(ValueError, match="early exit"):
        load_cell("kg1m_bf16.graph3", root=tmp_path)
