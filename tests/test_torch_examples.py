"""The port's examples (`hcrag_tpu_torch/examples/`) against the JAX
package's (`examples/`).

Each pair runs as subprocesses, all six at once, over a corpus written from
a seed (`testing.write_adventureworks_corpus`); the port's with `--device
cpu`.  Their printed lines are equal, scores as printed, but for the time
`EnhancedRAG` reports (a host clock, and JAX's first call compiles).
Without CUDA and without `--device`, each port example raises.
"""

import os
import re
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = ("end_to_end", "configurable_weights", "path_extraction")
TAKES_DATA = ("end_to_end", "path_extraction")
_CLOCK = re.compile(r"time=\d+\.\d+s")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from hcrag_tpu_torch.testing import write_adventureworks_corpus

    root = tmp_path_factory.mktemp("aw")
    write_adventureworks_corpus(root)
    return str(root)


@pytest.fixture(scope="module")
def outputs(corpus):
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")
    procs = {}
    for name in EXAMPLES:
        data = [corpus] if name in TAKES_DATA else []
        procs[name] = (
            subprocess.Popen([sys.executable, os.path.join("examples", f"{name}.py"), *data],
                             cwd=ROOT, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True),
            subprocess.Popen([sys.executable, "-m", f"hcrag_tpu_torch.examples.{name}",
                              *data, "--device", "cpu"],
                             cwd=ROOT, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True),
        )
    out = {}
    for name, pair in procs.items():
        runs = []
        for p in pair:
            stdout, stderr = p.communicate(timeout=600)
            runs.append((p.returncode, stdout, stderr))
        out[name] = runs
    return out


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_prints_what_jax_prints(outputs, name):
    (jrc, jout, jerr), (trc, tout, terr) = outputs[name]
    assert jrc == 0, jerr[-2000:]
    assert trc == 0, terr[-2000:]
    assert tout.strip(), "the port's example printed nothing"
    assert _CLOCK.sub("time=", tout).splitlines() == _CLOCK.sub("time=", jout).splitlines()


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_without_cuda_raises(corpus, name):
    if torch.cuda.is_available():
        return  # the default device is valid
    import importlib

    mod = importlib.import_module(f"hcrag_tpu_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main([corpus] if name in TAKES_DATA else [])
