"""The port's recorder (`hcrag_tpu_torch.utils.timing`): when it records,
how spans nest across threads, that its clock is the profiler's, that the
step gives the same outputs with it on, the expansion's counters against
hand-summed widths, and the benchmark's readers of it on fabricated
summaries (CPU)."""

import json
import threading

import numpy as np
import pytest
import torch

from hcbench.spec import metric_reader
from hcrag_tpu_torch.ops.expand import expand_batch_early_exit
from hcrag_tpu_torch.query.engine import QueryEngine
from hcrag_tpu_torch.utils import timing
from hcrag_tpu_torch.utils.synthetic import synthetic_setup

N, D, B, K = 4096, 64, 4, 10

STEP_OUTPUTS = ("top_scores", "top_indices", "relevance", "combined",
                "expanded_nodes", "expanded_counts", "expanded_relevance")


@pytest.fixture(scope="module")
def setup():
    return synthetic_setup(N, D, graph_degree=4)


@pytest.fixture(scope="module")
def engine(setup):
    return QueryEngine(*setup, device="cpu", ell_max_degree=8)


@pytest.fixture(autouse=True)
def clean_recorder():
    timing.reset()
    yield
    timing.reset()


def _queries(seed=3):
    q = torch.from_numpy(np.random.default_rng(seed).standard_normal((B, D)).astype(np.float32))
    return q / torch.linalg.vector_norm(q, dim=1, keepdim=True)


def test_nothing_is_recorded_with_the_profiler_off(engine):
    assert timing.span("engine.step") is timing.span("engine.select")  # the shared no-op
    with timing.span("engine.step") as s:
        assert s is None
    timing.count("expand.candidate_slots")
    engine.query_batch_device(_queries(), top_k=K, expansion_depth=3, max_expanded=1024)
    out = timing.summary()
    assert out == {"steps": 0, "spans": {}, "counters": {}}
    assert timing.records() == []


def test_spans_nest_per_thread():
    rec = timing.Recorder()
    barrier = threading.Barrier(2, timeout=30)

    def work():
        with rec.span("engine.step", batch=1):
            with rec.span("engine.select"):
                barrier.wait()
            with rec.span("engine.expand"):
                for hop in (1, 2):
                    with rec.span("engine.expand.hop", hop=hop):
                        barrier.wait()
                        rec.count("hops")

    with rec.recording():
        threads = [threading.Thread(target=work) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)

    spans = rec.records()
    by_id = {s["id"]: s for s in spans}
    steps = [s for s in spans if s["name"] == "engine.step"]
    assert len(spans) == 10 and len(steps) == 2
    assert {s["thread"] for s in steps} == {t.ident for t in threads}
    want_parent = {"engine.select": "engine.step", "engine.expand": "engine.step",
                   "engine.expand.hop": "engine.expand"}
    for s in spans:
        if s["name"] == "engine.step":
            assert s["parent"] is None and s["step"] == s["id"]
            continue
        parent = by_id[s["parent"]]
        assert parent["name"] == want_parent[s["name"]]
        assert parent["thread"] == s["thread"]
        assert by_id[s["step"]]["thread"] == s["thread"]
        assert parent["start_ns"] <= s["start_ns"] <= s["end_ns"] <= parent["end_ns"]
    assert sorted(s["attrs"].get("hop") for s in spans if s["name"] == "engine.expand.hop") \
        == [1, 1, 2, 2]

    out = rec.summary()
    assert out["steps"] == 2 and out["counters"] == {"hops": 4}
    host = lambda name: sum(s["end_ns"] - s["start_ns"]  # noqa: E731
                            for s in spans if s["name"] == name) * 1e-6
    assert out["spans"]["engine.step"]["self_ms"] == pytest.approx(
        host("engine.step") - host("engine.select") - host("engine.expand"), abs=1e-9)
    assert out["spans"]["engine.expand"]["self_ms"] == pytest.approx(
        host("engine.expand") - host("engine.expand.hop"), abs=1e-9)
    rec.reset()
    assert rec.summary()["steps"] == 0 and rec.records() == []


def test_spans_share_the_profilers_clock():
    from torch.profiler import ProfilerActivity, profile

    rec = timing.Recorder()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(4):  # the first record_function of a process starts up lazily
            with rec.span(f"clock.warm{i}"):
                torch.ones(64).sum()
        with rec.span("clock.outer"):
            with rec.span("clock.inner"):
                torch.ones(256).sum()
    events = {e.name(): (e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()}
    for s in rec.records():
        if s["name"].startswith("clock.warm"):
            continue
        a, b = events[s["name"]]
        assert a <= s["start_ns"] <= s["end_ns"] <= b, s["name"]
        assert s["start_ns"] - a < 50_000 and b - s["end_ns"] < 50_000, s["name"]


@pytest.mark.parametrize("mode", ["float", "int8_rescore"])
def test_the_step_is_bit_equal_with_recording_on(setup, engine, mode):
    if mode == "int8_rescore":
        engine = QueryEngine(*setup, device="cpu", ell_max_degree=8, quantize_int8=True,
                             int8_rescore=32, int8_f32_rescore=True)
    q = _queries(7)
    kw = dict(top_k=K, expansion_depth=3, max_expanded=1024)
    off = engine.query_batch_device(q, **kw)
    with timing.recording():
        on = engine.query_batch_device(q, **kw)
    out = timing.summary()
    assert out["steps"] == 1
    assert ("engine.rescore" in out["spans"]) == (mode == "int8_rescore")
    for name, a, b in zip(STEP_OUTPUTS, off, on):
        assert torch.equal(a, b), name


def test_depth3_counters_against_hand_summed_widths(engine):
    """Above reach (K * (M + M^2) = 720 < 1,024) every batch runs three hops
    and syncs twice; the dedups take K*M, K*M + K*M^2 and
    K*M + K*M^2 + K*M^3 slots a query."""
    m1, m2 = engine.d_neighbors.shape[1], engine.d_neighbors_hop2.shape[1]
    assert m1 == m2 == 8
    widths = [K * m1, K * m1 + K * m1 * m2, K * m1 + K * m1 * m2 + K * m1 * m2 * m2]
    steps = 2
    with timing.recording():
        outs = [engine.query_batch_device(_queries(s), top_k=K, expansion_depth=3,
                                          max_expanded=1024) for s in range(steps)]
    out = timing.summary()
    assert out["steps"] == steps
    c = out["counters"]
    assert set(c) == {"expand.candidate_slots", "expand.kept_nodes"}
    assert c["expand.candidate_slots"] == steps * B * sum(widths)
    assert c["expand.kept_nodes"] == sum(int(o[5].sum()) for o in outs)
    spans = out["spans"]
    assert spans["engine.expand.hop"]["n"] == 3 * steps
    assert spans["engine.expand.sync"]["n"] == 2 * steps
    for name in ("engine.select", "engine.metrics", "engine.expand", "engine.score_expanded"):
        assert spans[name]["n"] == steps, name
    assert "engine.rescore" not in spans  # the f32 bank selects exactly
    for s in timing.records():
        assert s["step"] is not None
    assert {s["attrs"]["batch"] for s in timing.records() if s["name"] == "engine.step"} == {B}


def test_depth1_makes_no_sync(engine):
    with timing.recording():
        engine.query_batch_device(_queries(), top_k=K, expansion_depth=1, max_expanded=20)
    out = timing.summary()
    assert out["spans"]["engine.expand.hop"]["n"] == 1
    assert "engine.expand.sync" not in out["spans"]
    assert out["counters"]["expand.candidate_slots"] == B * K * 8


def test_early_exit_counts_one_sync_when_the_first_hop_fills():
    """A cap the first hop fills: one sync, then no second hop."""
    nbrs = (torch.arange(64, dtype=torch.int32) % 16).reshape(16, 4)
    seeds = torch.tensor([[0, 1, 2], [3, 4, 5]], dtype=torch.int32)
    with timing.recording():
        out, count = expand_batch_early_exit(nbrs, seeds, depth=3, max_nodes=6)
    out = timing.summary()
    assert count.tolist() == [6, 6]
    assert {k: v["n"] for k, v in out["spans"].items()} == \
        {"engine.expand.hop": 1, "engine.expand.sync": 1}
    assert out["counters"] == {"expand.candidate_slots": 2 * 12, "expand.kept_nodes": 12}


def test_a_profiler_alone_turns_recording_on():
    """Under a profiler the recorder records without `recording()`, and
    each span is a profiler range of its name; after it, nothing."""
    from torch.profiler import ProfilerActivity, profile

    rec = timing.Recorder()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with rec.span("engine.step"):
            rec.count("expand.candidate_slots", 7)
            torch.ones(4).sum()
    with rec.span("engine.step"):
        rec.count("expand.candidate_slots", 5)
    out = rec.summary()
    assert out["steps"] == 1 and out["counters"] == {"expand.candidate_slots": 7}
    assert "engine.step" in {e.name() for e in prof.profiler.kineto_results.events()}


def test_the_store_keeps_the_newest_spans(monkeypatch):
    monkeypatch.setattr(timing, "RING", 3)
    rec = timing.Recorder()
    with rec.recording():
        for i in range(5):
            with rec.span("engine.expand.hop", hop=i):
                pass
    assert [s["attrs"]["hop"] for s in rec.records()] == [2, 3, 4]
    assert rec.summary()["spans"]["engine.expand.hop"]["n"] == 3


def test_a_raising_block_still_closes_its_span():
    rec = timing.Recorder()
    with rec.recording():
        with pytest.raises(ValueError):
            with rec.span("engine.step"):
                with rec.span("engine.select"):
                    raise ValueError("bad operand")
        with rec.span("engine.step"):  # the stack unwound: a fresh root
            pass
    spans = rec.records()
    assert [(s["name"], s["parent"]) for s in spans] == [
        ("engine.select", spans[1]["id"]), ("engine.step", None), ("engine.step", None)]
    assert spans[2]["step"] == spans[2]["id"] != spans[1]["id"]


def test_recording_blocks_nest():
    rec = timing.Recorder()
    with rec.recording():
        with rec.recording():
            rec.count("expand.candidate_slots")
        rec.count("expand.candidate_slots")  # the outer block still records
    rec.count("expand.candidate_slots")  # off
    assert rec.summary()["counters"] == {"expand.candidate_slots": 2}


def test_trace_to_writes_the_spans(tmp_path):
    with timing.trace_to(str(tmp_path)):
        with timing.span("engine.rerank", rows=3):
            torch.ones(8).sum()
    got = json.loads((tmp_path / "spans.json").read_text())
    assert got["summary"]["spans"]["engine.rerank"]["n"] == 1
    assert [(s["name"], s["attrs"]) for s in got["spans"]] == [("engine.rerank", {"rows": 3})]
    assert (tmp_path / "trace.json").is_file()


# --- the benchmark's readers of the recorder ---------------------------------

#: A slice of 4 steps, by hand: each step 10 ms of host of which 2 outside its
#: children, a 3-ms select, two syncs.
FABRICATED = {
    "steps": 4,
    "spans": {
        "engine.step": dict(n=4, host_ms=40.0, self_ms=8.0),
        "engine.select": dict(n=4, host_ms=12.0, self_ms=12.0),
        "engine.expand": dict(n=4, host_ms=6.0, self_ms=0.5),
        "engine.expand.sync": dict(n=8, host_ms=4.0, self_ms=4.0),
        "engine.score_expanded": dict(n=4, host_ms=1.0, self_ms=1.0),
    },
    "counters": {"expand.candidate_slots": 4 * 512 * 66_400, "expand.kept_nodes": 4 * 512 * 8192},
}

READINGS = {
    "entry_self_ms": 2.0,
    "select_host_ms": 3.0,
    "host_syncs.graph": 2.0,
    "expand_yield.graph": 100.0 * 8192 / 66_400,
}


#: What a reader gives for steps recorded without its span or counter: a
#: count reads 0, a time None.
EMPTY = {"host_syncs.graph": 0.0}


@pytest.mark.parametrize("metric", sorted(READINGS))
def test_reader_by_hand(monkeypatch, metric):
    read = metric_reader(metric)
    run = {"trace": {"steps": 4, "busy_s": 0.1, "window_s": 0.1}}
    monkeypatch.setattr(timing, "summary", lambda: FABRICATED)
    assert read(run) == pytest.approx(READINGS[metric])
    assert read({"trace": None}) is None  # an untraced run
    monkeypatch.setattr(timing, "summary", lambda: {"steps": 0, "spans": {}, "counters": {}})
    assert read(run) is None  # nothing recorded
    monkeypatch.setattr(timing, "summary", lambda: dict(FABRICATED, spans={}, counters={}))
    assert read(run) == EMPTY.get(metric)  # steps, but not this span or counter
    monkeypatch.delattr(timing, "summary")
    assert read(run) is None  # a program without the recorder
