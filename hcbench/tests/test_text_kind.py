"""The text kind (`hcbench/kinds/text.py`) at a size a CPU run holds: the
cell loads by name; its traffic gives every seed the same multiset of
lengths, each drawn text tokenizes to its drawn length under the reference
tokenizer, and a traffic that could vary is refused; the program is
correct, and a bf16 encoder, one altered embedding or one text tokenized
otherwise makes a run not correct; the kind and its reference import
nothing of the program; the readers and the model FLOPs by hand."""

import ast
import json
import shutil

import pytest
import torch

from hcbench import data
from hcbench.run import BANNED
from hcbench.spec import ROOT, load_cell, metric_reader
from hcbench.tests.small import CPU, run_small, small_cell

CELL = "kg1m_minilm.text1k"
SEEDS = (2**31 + 301, 2**31 + 302)


def _kind():
    return load_cell(CELL).kind


def test_the_cell_loads_by_name():
    cell = load_cell(CELL)
    assert cell.config["kind"] == "text" and cell.chips == 1
    assert cell.kind.__file__ == str(ROOT / "hcbench" / "kinds" / "text.py")
    assert cell.traffic["loop"] in cell.kind.LOOPS
    assert {"emb_err", "tok_mismatch", "sel_gap"} <= set(cell.limits)
    assert [m["name"] for m in cell.end_to_end] == ["qps", "setup_s"]
    assert {m["name"] for m in cell.per_layer} == {
        "mfu.text", "tokenize_ms.text", "pad_share.text", "select_roofline.text",
        "device_idle_pct.text"}
    enc = cell.config["encoder"]
    assert (enc["num_hidden_layers"], enc["hidden_size"], enc["num_attention_heads"],
            enc["intermediate_size"], enc["vocab_size"]) == (6, 384, 12, 1536, 30522)


def test_the_lengths_are_one_multiset_by_hand():
    kind, traffic = _kind(), load_cell(CELL).traffic
    pieces = kind.lengths(traffic)
    assert len(pieces) == 1024 and sum(pieces) == 20908
    assert min(pieces) == 4 and pieces.count(128) == 2
    assert round(100 * (1 - sum(pieces) / (1024 * 128)), 2) == 84.05


def _texts(seed, steps=3, batch=64):
    kind = _kind()
    traffic = dict(load_cell(CELL).traffic, batch=batch)
    words = kind.whole_words(ROOT / "hcbench" / "vocab" / "wordpiece_3777.txt")
    pieces = kind.lengths(traffic)
    return kind.draw_texts(data.generator(seed, CPU), CPU, words, pieces, steps), pieces


def test_every_seed_draws_the_same_lengths_and_fresh_texts():
    (a, pieces), (b, _) = (_texts(s) for s in SEEDS)
    ref = _kind().WordPiece(ROOT / "hcbench" / "vocab" / "wordpiece_3777.txt")
    for batches in (a, b):
        for texts in batches:
            ids, mask = ref.batch(texts, 128)
            assert sorted(mask.sum(dim=1).tolist()) == sorted(pieces)
            assert not (ids == ref.unk).any()
    flat = [t for batches in (a, b) for texts in batches for t in texts]
    assert len(set(flat)) == len(flat)  # no text drawn twice
    again, _ = _texts(SEEDS[0])
    assert again == a


def test_every_drawn_text_has_its_drawn_length():
    """Each text's tokens equal its own drawn length, not only the batch's
    multiset: n - 2 whole words give n pieces."""
    (batches, _) = _texts(SEEDS[0], steps=2)
    ref = _kind().WordPiece(ROOT / "hcbench" / "vocab" / "wordpiece_3777.txt")
    for texts in batches:
        _, mask = ref.batch(texts, 128)
        assert mask.sum(dim=1).tolist() == [len(t.split()) + 2 for t in texts]


@pytest.mark.parametrize("change,refused", [
    ({}, False),
    ({"lengths": {"draw": "sample", "median": 16, "sigma": 0.7, "min": 4, "max": 128}}, True),
    ({"max_len": 256}, True),
    ({"lengths": {"draw": "quantiles", "median": 16, "sigma": 0.7, "min": 4, "max": 200}}, True),
    ({"depth": 3, "max_expanded": 100}, True),
])
def test_work_problem(change, refused):
    cell = load_cell(CELL)
    traffic = dict(cell.traffic, **change)
    assert (cell.kind.work_problem(traffic, cell.config) is not None) == refused


def test_load_refuses_a_sampled_traffic(tmp_path):
    shutil.copytree(ROOT / "hcbench", tmp_path / "hcbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    path = tmp_path / "hcbench" / "traffic" / "text1k.json"
    t = json.loads(path.read_text())
    t["lengths"]["draw"] = "sample"
    path.write_text(json.dumps(t))
    with pytest.raises(ValueError, match="quantiles"):
        load_cell(CELL, root=tmp_path)


@pytest.fixture(scope="module")
def correct_run():
    return run_small(small_cell(CELL), seed=2**31 + 311)


def test_the_program_is_correct(correct_run):
    out = correct_run
    assert out["result"]["correct"], out["checks"]
    assert out["info"]["answers"] > 0 and out["info"]["tokenizer"] in ("native", "python")
    checks = {r["name"]: r["value"] for r in out["checks"]}
    assert checks["tok_mismatch"] == 0 and checks["emb_err"] < 1e-6


def _bf16_weights(monkeypatch):
    from hcbench import system_text

    real = system_text.System.__init__

    def rounded(self, *a, **k):
        real(self, *a, **k)
        with torch.no_grad():
            for p in self.engine.embedder.model.parameters():
                p.copy_(p.to(torch.bfloat16).to(torch.float32))

    monkeypatch.setattr(system_text.System, "__init__", rounded)


def _altered_embedding(monkeypatch):
    from hcrag_tpu_torch.query.engine import QueryEngine

    real = QueryEngine.query_text_batch_device

    def altered(self, *a, **k):
        out = real(self, *a, **k)
        emb = out[7].clone()
        emb[0, 0] += 1e-3
        return (*out[:7], emb)

    monkeypatch.setattr(QueryEngine, "query_text_batch_device", altered)


def _other_tokens(monkeypatch):
    from hcrag_tpu_torch.models.minilm import WordPieceTokenizer

    real = WordPieceTokenizer.encode_batch

    def other(self, *a, **k):
        ids, mask = real(self, *a, **k)
        ids = ids.copy()
        ids[0, 1] = (ids[0, 1] + 1) % self.vocab_size
        return ids, mask

    monkeypatch.setattr(WordPieceTokenizer, "encode_batch", other)


FAULTS = {"bf16_encoder": _bf16_weights, "embedding_altered": _altered_embedding,
          "text_tokenized_otherwise": _other_tokens}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_is_not_correct(fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    out = run_small(small_cell(CELL), seed=2**31 + 311)
    assert not out["result"]["correct"], out["checks"]
    checks = {r["name"]: r for r in out["checks"]}
    assert checks["emb_err"]["value"] > checks["emb_err"]["limit"]
    if fault == "text_tokenized_otherwise":
        assert checks["tok_mismatch"]["value"] >= 1


@pytest.mark.parametrize("name", ["kinds/text.py", "reference_text.py"])
def test_the_kind_and_its_reference_import_no_program(name):
    tree = ast.parse((ROOT / "hcbench" / name).read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    assert not roots & {"hcrag_tpu_torch", *BANNED}, roots


def test_model_flops_by_hand():
    kind, cell = _kind(), load_cell(CELL)
    enc = cell.config["encoder"]
    # 6 layers x (n (8 h^2 + 4 h f) + 4 n^2 h), h 384, f 1536: 3,538,944 n + 1,536 n^2
    assert kind.model_flops([10], enc) == 6 * (10 * 3_538_944 + 1_536 * 100)
    pieces = kind.lengths(cell.traffic)
    assert kind.model_flops(pieces, enc) == 6 * sum(
        n * 3_538_944 + 1_536 * n * n for n in pieces)
    info = kind.trace_info(cell.config, cell.traffic)
    assert info["model_flops_per_step"] == kind.model_flops(pieces, enc)
    assert info["select_kernels"] == ["float_tile_topk_kernel"]


def test_readers_by_hand(monkeypatch):
    """10 traced steps in a 0.5-s slice, 50 ms a step, each of a quarter of
    the FLOPs that 67 TFLOP/s does in 50 ms: 25%."""
    run = {"trace": {"busy_s": 0.45, "window_s": 0.5, "steps": 10, "op_s": {}},
           "model_flops_per_step": 67e12 * 0.05 * 0.25}
    assert metric_reader("mfu.text")(run) == pytest.approx(25.0)
    assert metric_reader("device_idle_pct.text")(run) == pytest.approx(10.0)
    assert metric_reader("mfu.text")({"trace": None}) is None
    from hcrag_tpu_torch.utils import timing

    monkeypatch.setattr(timing, "summary", lambda: {
        "steps": 4, "spans": {"engine.tokenize": {"n": 4, "host_ms": 10.0, "self_ms": 10.0}},
        "counters": {"encode.tokens": 20908 * 4, "encode.padded_tokens": 131072 * 4}})
    assert metric_reader("tokenize_ms.text")(run) == pytest.approx(2.5)
    assert metric_reader("pad_share.text")(run) == pytest.approx(100 * (1 - 20908 / 131072))
    monkeypatch.setattr(timing, "summary", lambda: {"steps": 4, "spans": {}, "counters": {}})
    assert metric_reader("tokenize_ms.text")(run) is None
    assert metric_reader("pad_share.text")(run) is None
