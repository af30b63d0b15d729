"""Kernel B8 of the PyTorch port (`ops/sweep_cuda.py`: the stage-attribution
kernels `matmul_only_acc`, `matmul_only_wide`, `encode_level1`) against the
JAX sweep's Pallas kernels (`benchmarks/kernel_sweep.py`) in interpret mode,
and the port's sweep (`hcrag_tpu_torch.benchmarks.kernel_sweep`) and timing
helpers on the CPU.  On the CPU the wrappers run their plain versions, so
these tests hold the plain versions to the Pallas kernels; the chip smoke run
and tests/test_torch_cuda.py hold the CUDA kernels to the plain versions.

Tolerances: on dyadic inputs (multiples of 1/64) every dot is exact in f32 in
any order, so the two sides agree bit for bit.  On normal inputs the f32
sums run in another order: B8a and B8b agree within 1e-6 (the dots are
cosines, at most 1 in size), and B8c's keys by `testing.check_level1`."""

import functools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from benchmarks import kernel_sweep as jax_sweep
from hcrag_tpu_torch.benchmarks import kernel_sweep as port_sweep
from hcrag_tpu_torch.ops import sweep_cuda
from hcrag_tpu_torch.testing import check_level1
from hcrag_tpu_torch.utils.timing import device_time, trace_to

B, D = 16, 128
KERNELS = {  # port wrapper -> the JAX sweep's kernel factory
    "matmul_only_acc": jax_sweep.make_matmul_only_acc,
    "matmul_only_wide": jax_sweep.make_matmul_only_wide,
    "encode_level1": jax_sweep.make_encode_level1,
}


@pytest.fixture
def interpret(monkeypatch):
    """The sweep's kernels look up `pl.pallas_call` when they are traced:
    run them in interpret mode on the CPU."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _dyadic(tile_n, tiles, seed):
    """Multiples of 1/64 up to 12/64: every dot is exact in f32.  Query 0 is
    all 12/64, and column 5 of every group of every tile holds its negation,
    so that its shifted score s + 2 = -2.5 gives negative keys (lane 5 of
    query 0 then holds 0 in both halves of B8c's output)."""
    rng = np.random.default_rng(seed)
    q = (rng.integers(-12, 13, (B, D)) / 64).astype(np.float32)
    e = (rng.integers(-12, 13, (tile_n * tiles, D)) / 64).astype(np.float32)
    q[0] = 12 / 64
    e[5::128] = -q[0]
    return q, e


def _normal(tile_n, tiles, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, D)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    e = rng.standard_normal((tile_n * tiles, D)).astype(np.float32)
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    return q, e


def _both(name, q, e, tile_n):
    """(Pallas kernel in interpret mode, port wrapper on CPU tensors), both
    as numpy, over the bf16 bank of e and the f32 queries q."""
    e_bf16 = jnp.asarray(e).astype(jnp.bfloat16)
    jax_out = KERNELS[name](q.shape[0], q.shape[1], tile_n, e.shape[0] // tile_n)(
        jnp.asarray(q), e_bf16)
    e_t = torch.from_numpy(np.array(e_bf16.astype(jnp.float32))).to(torch.bfloat16)
    port_out = getattr(sweep_cuda, name)(torch.from_numpy(q), e_t, tile_n)
    return np.array(jax_out), port_out.numpy(), e_t


@pytest.mark.parametrize("tile_n,tiles", [(128, 3), (256, 3), (2048, 2)])
@pytest.mark.parametrize("name", list(KERNELS))
def test_b8_equals_pallas_on_exact_dots(interpret, name, tile_n, tiles):
    q, e = _dyadic(tile_n, tiles, seed=tile_n + tiles)
    jax_out, port_out, _ = _both(name, q, e, tile_n)
    assert port_out.dtype == jax_out.dtype and port_out.shape == jax_out.shape
    np.testing.assert_array_equal(port_out.view(np.int32), jax_out.view(np.int32))
    if name == "encode_level1":
        assert port_out[0, 5] == 0 and port_out[0, 128 + 5] == 0  # negative keys clamp


@pytest.mark.parametrize("tile_n,tiles", [(256, 3), (2048, 2)])
@pytest.mark.parametrize("name", list(KERNELS))
def test_b8_agrees_with_pallas_on_normal_inputs(interpret, name, tile_n, tiles):
    q, e = _normal(tile_n, tiles, seed=3 * tile_n + tiles)
    jax_out, port_out, e_t = _both(name, q, e, tile_n)
    if name == "encode_level1":
        moved = check_level1(torch.from_numpy(port_out), torch.from_numpy(jax_out),
                             torch.from_numpy(q).to(torch.bfloat16), e_t, tile_n)
        assert moved <= 2
    else:
        np.testing.assert_allclose(port_out, jax_out, atol=1e-6, rtol=0)


def test_b8c_m2_stays_zero_with_one_group(interpret):
    """At tile_n 128 a tile holds one 128-column group: m2 never leaves 0."""
    q, e = _normal(128, 4, seed=5)
    jax_out, port_out, _ = _both("encode_level1", q, e, 128)
    np.testing.assert_array_equal(port_out, jax_out)
    assert (port_out[:, 128:] == 0).all() and (port_out[:, :128] > 0).all()


def test_b8a_b8b_read_the_first_128_columns():
    """B8a and B8b on CPU tensors: the columns past 128 of a tile reach no
    output, and B8a starts from -1e30."""
    q, e = (torch.from_numpy(a) for a in _normal(256, 2, seed=9))
    e = e.to(torch.bfloat16)
    s = q.to(torch.bfloat16).float() @ e.float().T
    wide = sweep_cuda.matmul_only_wide(q, e, 256)
    torch.testing.assert_close(wide, torch.cat([s[:, :128], s[:, 256:384]], dim=1),
                               atol=1e-6, rtol=0)
    acc = sweep_cuda.matmul_only_acc(q, e, 256)
    torch.testing.assert_close(acc, torch.maximum(s[:, :128], s[:, 256:384]), atol=1e-6,
                               rtol=0)
    far = torch.full((2, 128), -3e30)  # below the start: the fold keeps -1e30
    assert bool((sweep_cuda.matmul_only_acc_plain(far, torch.ones((256, 128),
                                                  dtype=torch.bfloat16), 256)
                 == -1e30).all())


def test_check_level1_accepts_equal_and_rejects_faults():
    q, e = (torch.from_numpy(a) for a in _normal(256, 3, seed=11))
    e = e.to(torch.bfloat16)
    out = sweep_cuda.encode_level1(q, e, 256)
    qb = q.to(torch.bfloat16)
    assert check_level1(out.clone(), out, qb, e, 256) == 0
    bad = out.clone()
    bad[2, 7] += 2048  # one quantum up, away from any boundary
    with pytest.raises(AssertionError, match="boundary"):
        check_level1(bad, out, qb, e, 256)
    with pytest.raises(AssertionError, match="more than"):
        check_level1(out + 2048, out, qb, e, 256)


@pytest.mark.parametrize("case,match", [
    ("ragged_bank", "whole number"),
    ("tile_not_lanes", "multiple of 128"),
    ("tile_too_wide", "multiple of 128"),
    ("d_not_64", "multiple of 64"),
    ("f32_bank", "bfloat16"),
    ("no_queries", "at least one"),
])
@pytest.mark.parametrize("name", list(KERNELS))
def test_b8_refuses_shapes_the_kernels_do_not_take(name, case, match):
    q = torch.zeros((4, 128))
    e = torch.zeros((1024, 128), dtype=torch.bfloat16)
    tile_n = 256
    if case == "ragged_bank":
        e = e[:1000]
    elif case == "tile_not_lanes":
        tile_n = 192
    elif case == "tile_too_wide":
        e, tile_n = torch.zeros((4096, 128), dtype=torch.bfloat16), 4096
    elif case == "d_not_64":
        q, e = q[:, :96], e[:, :96]
    elif case == "f32_bank":
        e = e.float()
    else:
        q = q[:0]
    with pytest.raises(ValueError, match=match):
        getattr(sweep_cuda, name)(q, e, tile_n)


def test_b8_wrappers_refuse_other_devices():
    q = torch.zeros((4, 128), device="meta")
    e = torch.zeros((256, 128), dtype=torch.bfloat16, device="meta")
    for name in KERNELS:
        with pytest.raises(ValueError, match="CUDA or CPU"):
            getattr(sweep_cuda, name)(q, e, 256)


def test_sweep_data_is_the_jax_sweeps():
    """The JAX sweep's construction (benchmarks/kernel_sweep.py main) at a
    small size: rows first, normalized in f32, cast to bf16; then queries."""
    n, d, b, tile = 5000, 64, 8, 2048
    n_pad = 3 * tile
    rng = np.random.default_rng(7)
    e = rng.standard_normal((n_pad, d)).astype(np.float32)
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    q = rng.standard_normal((b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    tq, te = port_sweep.sweep_data("cpu", n=n, d=d, b=b, tile_n=tile)
    np.testing.assert_array_equal(tq.numpy(), q)
    want = np.asarray(jnp.asarray(e).astype(jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(te.float().numpy(), want)


def test_sweep_on_cpu_runs_every_row_and_launches_no_kernel():
    wrappers = port_sweep._wrappers()
    before = {k: w.launches for k, w in wrappers.items()}
    out = port_sweep.sweep("cpu", n=4096, d=64, b=8, tile_n=2048, steps=1)
    assert {k: w.launches for k, w in wrappers.items()} == before
    rows = set(port_sweep.JAX_ROWS) | {"library_matmul", "b5_alone", "matmul_only_acc_tile128",
                                       "b1_alone", "library_int8_matmul"}
    assert rows <= set(out)
    assert all(out[k] > 0 for k in rows)
    assert all(not c for c in out["launches"].values())
    assert set(out["attribution"]) >= {"dots_ms", "writes_ms", "encode_level1_ms",
                                       "b5_over_library", "b1_over_library",
                                       "acc_2048_over_128"}
    assert "level2_ms" not in out["attribution"]  # B5 and B8 run different loops
    assert out["device"] == "cpu" and out["shapes"]["n"] == 4096
    json.dumps(out)


def test_quantize_bank_takes_the_sweeps_tensor_bank():
    """`b1_alone` quantizes the sweep's bf16 bank where it lies: byte-equal
    to quantizing the same rows from the host (the JAX package's
    `quantize_rows`)."""
    from hcrag_tpu.ops.quantize import quantize_rows as jax_quantize_rows
    from hcrag_tpu_torch.ops.quantize import ROW_CHUNK, quantize_bank

    _, e = port_sweep.sweep_data("cpu", n=ROW_CHUNK + 300, d=64, b=4, tile_n=2048)
    e8, es = quantize_bank(e, torch.device("cpu"))
    w8, ws = jax_quantize_rows(e.float().numpy())
    np.testing.assert_array_equal(e8.numpy(), np.asarray(w8))
    np.testing.assert_array_equal(es.numpy(), np.asarray(ws))


def test_kernel_labels_and_ptxas_report_read_nvcc_output():
    """The build report names each kernel by its template's arguments and
    gives its registers, stack and spill bytes (the lines `chip_smoke.py`
    prints), from nvcc's `-Xptxas -v` log."""
    from hcrag_tpu_torch.ops import _build

    tc = ("_ZN7tc_tile19tc_tile_topk_kernelILi128ELi16ENS_4Int8EN50_GLOBAL__N__dce003d3_17_"
          "int8_tile_topk_cu_64d1a18c9PackedKeyELb0EEEv14CUtensorMap_stPKhPKfS8_S6_PfPiiiii")
    dots = ("_ZN7tc_tile19tc_tile_topk_kernelILi64ELi0ENS_4Bf16EN51_GLOBAL__N__155bee95_18_"
            "float_tile_topk_cu_13a1ec919PackedKeyELb1EEEv14CUtensorMap_stPKhPKfS8_S6_PfPiiii")
    exact = ("_ZN50_GLOBAL__N__dce003d3_17_int8_tile_topk_cu_64d1a18c27int8_exact_tile_topk_"
             "kernelEPKaPKfS1_S3_PKhPfPiiiiiii")
    assert _build.kernel_label(tc) == "tc_tile_topk_kernel<128,16,Int8,PackedKey>"
    assert _build.kernel_label(dots) == "tc_tile_topk_kernel<64,0,Bf16,PackedKey,DOTS>"
    assert _build.kernel_label(exact) == "int8_exact_tile_topk_kernel"
    b4 = ("_ZN7tc_tile25float_tile_topk_kernel_tcILi128ELi10ENS_4Bf16EN51_GLOBAL__N__155bee95_"
          "18_float_tile_topk_cu_13a1ec918ExactKeyELb0EEEv14CUtensorMap_stPKhPKfS8_S6_PfPiiii")
    assert _build.kernel_label(b4) == "float_tile_topk_kernel_tc<128,10,Bf16,ExactKey>"
    log = (f"ptxas info    : Compiling entry function '{tc}' for 'sm_90a'\n"
           f"ptxas info    : Function properties for {tc}\n"
           "    128 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
           "ptxas info    : Used 165 registers, used 2 barriers, 128 bytes cumulative stack\n")
    assert _build.ptxas_report(log) == [
        ("tc_tile_topk_kernel<128,16,Int8,PackedKey>",
         "165 registers, 128 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads")]


def test_ab_kernels_needs_a_card():
    from hcrag_tpu_torch.benchmarks import ab_kernels

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ab_kernels.main([".", "."])


def test_sweep_main_refuses_a_missing_card_and_runs_on_cpu(capsys):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            port_sweep.main([])
    assert port_sweep.main(["--device", "cpu"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert set(port_sweep.JAX_ROWS) <= set(json.loads(line))


def test_device_time_and_trace_to_on_cpu(tmp_path):
    calls = []
    t = device_time(lambda x: calls.append(x), 1, iters=3, warmup=2, device="cpu")
    assert calls == [1] * 5 and t >= 0.0
    with pytest.raises(ValueError, match="CUDA or CPU"):
        device_time(lambda: None, device="meta")
    with pytest.raises(TypeError):
        device_time(lambda: None)  # the device is never guessed
    with trace_to(str(tmp_path / "trace")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert trace["traceEvents"]
    assert any("mm" in e.key for e in prof.key_averages())

