"""`correct` at a size a test run holds: the program's answers pass; the
control (the reference one precision step lower, in the program's place)
fails; and each fault a cell can have, planted under the timed path, makes
the run come out not correct.  The faults of a one-chip retrieval cell: a
step that returns its previous outputs unchanged, half of the batch left out
(its second half answered with the first half's answers) and one answer
altered where it is produced.  No cell exchanges anything between chips."""

import pytest
import torch

from hcbench import check, data
from hcbench.loops import LOOPS
from hcbench.reference import Reference, lowered
from hcbench.system import System
from hcbench.tests.small import CELLS, CPU, run_small, small_cell


@pytest.mark.parametrize("name", CELLS)
def test_the_program_is_correct(name):
    out = run_small(small_cell(name))
    assert out["result"]["correct"], out["checks"]
    assert out["info"]["answers"] > 0
    assert list(out["result"])[-1] == "checks"


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    cell = small_cell(name)
    seed = 2**31 + 33
    g = data.generator(seed, CPU)
    corpus = data.make_corpus(cell.config, g, CPU)
    loop = LOOPS[cell.traffic["loop"]](System(cell.config, corpus, CPU), cell.traffic, g,
                                       seed, CPU, int(cell.config["dim"]))
    loop.warm_up()
    loop.window(0.5)
    batches = loop.kept_batches()
    loop.close()
    low = Reference(cell.config, corpus, CPU, precision=lowered(cell.config["precision"]))
    ctrl = [(q, check.control_outputs(low, cell.traffic, q)) for q, _ in batches]
    numbers, _ = check.judge(Reference(cell.config, corpus, CPU), cell.traffic, ctrl)
    correct, rows = check.verdict(numbers, cell.limits)
    assert not correct, rows


def _stale(outs, cache):
    """The previous call's outputs of the same shape: the state unchanged."""
    key = tuple(t.shape for t in outs)
    prev = cache.get(key, outs)
    cache[key] = outs
    return tuple(t.clone() for t in prev)


def _half(outs, cache):
    b = outs[0].shape[0]
    return tuple(torch.cat([t[: b - b // 2], t[: b // 2]]) for t in outs)


def _altered(outs, cache):
    outs = tuple(t.clone() for t in outs)
    outs[1][0, 0] = (outs[1][0, 0] + 1) % 1000  # one answer's best row
    return outs


FAULTS = {"state_unchanged": _stale, "half_batch": _half, "answer_altered": _altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    from hcrag_tpu_torch.query.engine import QueryEngine

    cache = {}
    real = QueryEngine.query_batch_device

    def broken(self, *a, **k):
        return FAULTS[fault](tuple(real(self, *a, **k)), cache)

    monkeypatch.setattr(QueryEngine, "query_batch_device", broken)
    out = run_small(small_cell(name))
    assert not out["result"]["correct"], out["checks"]
