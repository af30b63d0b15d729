"""Nothing the benchmark runs loads JAX, jaxlib, flax or the JAX package,
top-level names compared whole (the program's name begins with the JAX
package's), and the reference loads nothing of the program."""

import ast
import json
import subprocess
import sys
import types

import pytest

from hcbench.run import BANNED, banned_modules
from hcbench.spec import ROOT

#: The yardstick: it may import torch, numpy and itself, never the program.
REFERENCE_SIDE = ("reference.py", "check.py", "bounds.py", "data.py", "loops.py",
                  "trace.py", "spec.py", "kinds/retrieval.py")


def test_banned_names_are_compared_whole(monkeypatch):
    for name in ("hcrag_tpu_torch", "jaxtyping", "flaxen", "hcrag_tpu_x"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert banned_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    monkeypatch.setitem(sys.modules, "hcrag_tpu.ops", types.ModuleType("hcrag_tpu.ops"))
    assert banned_modules() == ["hcrag_tpu", "jax"]
    assert set(BANNED) == {"jax", "jaxlib", "flax", "hcrag_tpu"}


@pytest.mark.parametrize("name", REFERENCE_SIDE)
def test_reference_side_imports_no_program(name):
    tree = ast.parse((ROOT / "hcbench" / name).read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    assert not roots & {"hcrag_tpu_torch", *BANNED}, roots


def test_a_run_loads_nothing_banned():
    """A whole small run in a fresh process: the program, the loops, the
    reference; then the modules it holds."""
    script = (
        "import json, sys\n"
        "from hcbench.tests.small import small_cell, run_small\n"
        "out = run_small(small_cell('kg1m_bf16.graph3'))\n"
        "import hcbench.reference, hcbench.check\n"
        "print(json.dumps({'correct': out['result']['correct'],\n"
        "                  'loaded': sorted({m.split('.')[0] for m in sys.modules})}))\n"
    )
    res = subprocess.run([sys.executable, "-c", script], cwd=str(ROOT), capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got["correct"] is True
    assert "hcrag_tpu_torch" in got["loaded"]
    assert not set(got["loaded"]) & set(BANNED), got["loaded"]


def test_the_reference_alone_loads_no_program():
    script = ("import sys, hcbench.reference, hcbench.check, hcbench.bounds\n"
              "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    res = subprocess.run([sys.executable, "-c", script], cwd=str(ROOT), capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    loaded = set(ast.literal_eval(res.stdout.strip().splitlines()[-1]))
    assert not loaded & {"hcrag_tpu_torch", *BANNED}, loaded
