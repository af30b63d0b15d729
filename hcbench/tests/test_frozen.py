"""The frozen copies inside the benchmark, held to hand-worked values: the
bound arithmetic, the data generators and the metric readers."""

import pytest
import torch

from hcbench import bounds, data
from hcbench.spec import load_cell, metric_reader


def test_b1_bound_at_the_cells_shapes():
    # 2 x 8192 x 1,001,472 x 384 int8 operations at 1,979 TOP/s
    assert round(bounds.select_bound_ms(8192, 1_001_472, 384, "int8", 10), 2) == 3.18
    assert round(bounds.select_bound_ms(2048, 1_001_472, 384, "int8", 10), 3) == 0.796
    # B4 over bf16 rows at B=1024: 2 x 1024 x 1,001,472 x 384 at 989 TFLOP/s
    assert round(bounds.select_bound_ms(1024, 1_001_472, 384, "bf16", 10), 3) == 0.796


def test_bound_by_bytes_when_operations_are_few():
    ms, by = bounds.bound_ms(1.0, "f32", 3.35e9)
    assert by == "bytes" and ms == pytest.approx(1.0)
    ms, by = bounds.bound_ms(1979e9, "int8", 1.0)
    assert by == "operations" and ms == pytest.approx(1.0)


def test_entity_words_by_hand():
    words, counts = data.entity_words(torch.tensor([[0, 33, 127], [5, 5, 5]]), 128)
    assert words.tolist() == [[1, 2, 0, 1 << 31], [1 << 5, 0, 0, 0]]
    assert counts.tolist() == [3, 1]


def test_corpus_is_made_from_the_seed():
    config = load_cell("kg1m_bf16.graph3").config
    config["rows"] = 3000
    cpu = torch.device("cpu")
    a = data.make_corpus(config, data.generator(2**31 + 9, cpu), cpu)
    b = data.make_corpus(config, data.generator(2**31 + 9, cpu), cpu)
    c = data.make_corpus(config, data.generator(2**31 + 10, cpu), cpu)
    for k in a:
        assert torch.equal(a[k], b[k]), k
        assert a[k].shape == c[k].shape, k
    assert not torch.equal(a["emb"], c["emb"])
    torch.testing.assert_close(torch.linalg.vector_norm(a["emb"], dim=1),
                               torch.ones(3000), rtol=0, atol=1e-6)
    pop = sum(((a["bits"] >> i) & 1).sum(dim=1) for i in range(32))
    assert torch.equal(pop, a["counts"])
    assert a["counts"].min() >= 1 and a["counts"].max() <= 3
    assert a["type_ids"].min() >= 0 and a["type_ids"].max() < 6
    assert torch.equal(a["src"], torch.arange(3000).repeat_interleave(8))
    assert set(a["etype"].unique().tolist()) == {0, 1}


def test_readers_by_hand():
    assert metric_reader("qps")({"completed_queries": 500, "window_s": 2.0}) == 250.0
    assert metric_reader("qps")({"steps": 3}) is None
    trace = {"busy_s": 0.75, "window_s": 1.0}
    assert metric_reader("device_idle_pct.graph")({"trace": trace}) == 25.0


def test_selection_readers_by_hand():
    """10 traced steps in a 0.5-s slice; the selection kernel ran 0.2 s of
    it, other kernels 0.25 s: 20 ms of selection a step, 30 ms of the rest."""
    trace = {"busy_s": 0.45, "window_s": 0.5, "steps": 10,
             "op_s": {"void ns::float_tile_topk_kernel<bf16>(float*)": 0.2,
                      "void at::native::vectorized_gather_kernel<16>": 0.25}}
    run = {"trace": trace, "select_kernels": ["float_tile_topk_kernel"],
           "select_bound_ms": 0.8}
    assert metric_reader("select_roofline")(run) == pytest.approx(4.0)
    assert metric_reader("select_roofline.graph")(run) == pytest.approx(4.0)
    assert metric_reader("post_select_ms.graph")(run) == pytest.approx(30.0)
    # a slice in which no selection kernel ran reads nothing, never 0
    for miss in ({"select_kernels": ["tc_tile_topk_kernel"]}, {"trace": dict(trace, steps=0)},
                 {"trace": None}):
        assert metric_reader("select_roofline")(dict(run, **miss)) is None
        assert metric_reader("post_select_ms.graph")(dict(run, **miss)) is None
