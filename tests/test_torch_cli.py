"""`python -m hcrag_tpu_torch.cli <cmd> --device cpu` beside
`python -m hcrag_tpu.cli <cmd>` on the same `--data` directory (a seeded
AdventureWorks-shaped corpus, built once for the module).

`build`, `stats`, `query`, `extract-graph`, `agent` and `repl` print the
same lines (paths of the two output directories aside), with every number
compared within 1e-3: the JAX engine on the CPU selects through
`masked_top_k`, the port through B4's plain version, and the printed
scores are rounded to 3 places.  `viz` and `graph-html` write the same
HTML, the embedded elements parsed and their scores compared within 1e-5;
the extracted property graphs' JSON files are equal (a page's title that
names its store's path aside).  Without CUDA the port's CLI refuses to run
unless given `--device cpu`."""

import json
import os
import re
import subprocess
import sys

import pytest

from hcrag_tpu_torch.testing import write_adventureworks_corpus

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = ("hcrag_tpu", "hcrag_tpu_torch")
QUERY = "mountain bike frame"
_NUM = re.compile(r"-?\d+\.\d+|-?\d+")


def _start(pkg, args, stdin=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    extra = ["--device", "cpu"] if pkg == "hcrag_tpu_torch" else []
    return subprocess.Popen([sys.executable, "-m", f"{pkg}.cli", *args, *extra],
                            cwd=ROOT, env=env, text=True, stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE), stdin


def _finish(started, timeout=300):
    proc, stdin = started
    out, err = proc.communicate(stdin, timeout=timeout)
    assert proc.returncode == 0, err[-2000:]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every command of both CLIs, each package's commands run at once."""
    tmp = tmp_path_factory.mktemp("cli")
    data = str(write_adventureworks_corpus(tmp / "data", seed=3))
    out = {pkg: {} for pkg in PKGS}
    art = {pkg: str(tmp / f"art_{pkg}") for pkg in PKGS}
    builds = {pkg: _start(pkg, ["build", "--data", data, "--out", art[pkg]]) for pkg in PKGS}
    for pkg in PKGS:
        out[pkg]["build"] = _finish(builds[pkg]).replace(art[pkg], "ART")
    runs_ = {}
    for pkg in PKGS:
        a = ["--artifacts", art[pkg]]
        runs_[pkg] = {
            "stats": _start(pkg, ["stats", *a]),
            "query": _start(pkg, ["query", QUERY, *a, "--threshold", "0.0"]),
            "query_data": _start(pkg, ["query", QUERY, "--data", data, "--threshold", "0.0"]),
            "agent": _start(pkg, ["agent", "What mountain bikes do you have?", *a]),
            "repl": _start(pkg, ["repl", *a], "mode:vector road frame\n:stats\n"
                                              ":filter database_table\njersey\n:quit\n"),
            "viz": _start(pkg, ["viz", QUERY, *a, "--out", str(tmp / f"viz_{pkg}.html")]),
            "viz_menu": _start(pkg, ["viz", *a, "--out", str(tmp / f"menu_{pkg}.html")],
                               "1\n0\n"),
            "graph-html": _start(pkg, ["graph-html", *a, "--out", str(tmp / f"kg_{pkg}.html"),
                                       "--max-nodes", "60"]),
            "extract-graph": _start(pkg, ["extract-graph", "--data", data, "--out",
                                          str(tmp / f"pg_{pkg}"), "--link-sources"]),
        }
    for pkg in PKGS:
        for name, started in runs_[pkg].items():
            out[pkg][name] = _finish(started).replace(str(tmp), "TMP").replace(pkg, "PKG")
    store = {pkg: str(tmp / f"pg_{pkg}" / "property_graph.json") for pkg in PKGS}
    for pkg in PKGS:
        out[pkg]["store-html"] = _finish(_start(pkg, [
            "graph-html", "--store", store[pkg], "--out", str(tmp / f"pg_{pkg}.html")])
        ).replace(str(tmp), "TMP").replace(pkg, "PKG")
    return tmp, out


def _same_lines(a: str, b: str, atol: float = 1e-3):
    la, lb = a.splitlines(), b.splitlines()
    assert len(la) == len(lb), (a, b)
    for x, y in zip(la, lb):
        assert _NUM.sub("#", x) == _NUM.sub("#", y), (x, y)
        for u, v in zip(_NUM.findall(x), _NUM.findall(y)):
            assert abs(float(u) - float(v)) <= atol, (x, y)


@pytest.mark.parametrize("cmd", ["build", "stats", "query", "query_data", "extract-graph",
                                 "agent", "repl", "viz", "viz_menu", "graph-html",
                                 "store-html"])
def test_stdout_equals_jax(runs, cmd):
    _, out = runs
    jax_out, port_out = out["hcrag_tpu"][cmd], out["hcrag_tpu_torch"][cmd]
    assert port_out.strip()
    _same_lines(port_out.replace("hcrag_tpu_torch", "PKG"), jax_out)


def test_query_on_artifacts_equals_query_on_the_built_bundle(runs):
    _, out = runs
    port = out["hcrag_tpu_torch"]
    assert port["query"] == port["query_data"]


def _html_parts(path):
    # The title of the store's page names the store's path.
    text = re.sub(r"pg_hcrag_tpu(_torch)?/", "pg_PKG/", open(path).read())
    m = re.search(r"const elements = (.*);\n", text)
    return text[:m.start()] + text[m.end():], json.loads(m.group(1))


def _same_elements(a, b, atol=1e-5):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x, y = dict(x["data"]), dict(y["data"])
        sx, sy = x.pop("similarity_score", None), y.pop("similarity_score", None)
        assert x == y
        assert (sx is None) == (sy is None) and (sx is None or abs(sx - sy) <= atol)


@pytest.mark.parametrize("name", ["viz", "menu", "kg", "pg"])
def test_html_equals_jax(runs, name):
    tmp, _ = runs
    jt, je = _html_parts(tmp / f"{name}_hcrag_tpu.html")
    tt, te = _html_parts(tmp / f"{name}_hcrag_tpu_torch.html")
    assert tt == jt
    _same_elements(te, je)
    assert len(te) > 2


def test_extracted_store_files_equal(runs):
    tmp, _ = runs
    assert (tmp / "pg_hcrag_tpu_torch" / "property_graph.json").read_text() == \
        (tmp / "pg_hcrag_tpu" / "property_graph.json").read_text()


def test_artifacts_load_in_either_package(runs):
    from hcrag_tpu.core.dense_index import DenseIndex as JaxIndex
    from hcrag_tpu.core.graph import CsrGraph as JaxGraph
    from hcrag_tpu_torch.core.dense_index import DenseIndex
    from hcrag_tpu_torch.core.graph import CsrGraph

    tmp, _ = runs
    port_dir, jax_dir = tmp / "art_hcrag_tpu_torch", tmp / "art_hcrag_tpu"
    assert JaxIndex.load(port_dir).texts == DenseIndex.load(jax_dir).texts
    assert (JaxGraph.load(port_dir).col_idx == CsrGraph.load(jax_dir).col_idx).all()


def test_cli_refuses_the_card_without_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from hcrag_tpu_torch import cli

    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["stats", "--artifacts", "nowhere"])
