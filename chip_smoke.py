#!/usr/bin/env python3
"""Smoke run of the PyTorch port (hcrag_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero before the
last line:

  1. card   — the card's name and power limit (nvidia-smi);
  2. build  — nvcc builds every kernel of the main path from csrc/, all in
              parallel (sm_90a);
  3. kernels — every kernel against its plain PyTorch version on the card,
              bit for bit: b=512 at D=384 over 20 tiles with a ragged last
              tile and masked rows, the main path's 4890-candidate pool,
              all-tied input, a small pool, the per-tile pick-count raise;
  4. main path — `QueryEngine.query_batch` at 1,000,000 x 384, B=8192,
              top_k=10, depth 1 in the int8-select + f32-rescore mode:
              launch counts from that run, recall@10 against f32 brute force
              on 256 queries, the card engine against the CPU engine on a
              small index, a profile of the step, each kernel against its
              plain version at the main path's shapes, the card engine with
              TF32 enabled against itself without it, then timings (CUDA
              events) of the step and of each kernel beside its plain
              version, its bound and, where one exists, a one-call PyTorch
              equivalent.

The second-to-last line is a JSON object listing the kernels; the last is
{"ok": true, "device": {...}}.  Exits non-zero without a result when CUDA is
unavailable or the package is missing.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

# Published H100 SXM peaks (dense): int8 tensor cores and memory rate.
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12

N_ROWS, DIM, BATCH, TOP_K, DEPTH = 1_000_000, 384, 8192, 10, 1
RESCORE = 32
GATE_QUERIES, MIN_RECALL = 256, 0.998


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device milliseconds of fn() over `reps` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def same_bits(kv, ki, pv, pi) -> float:
    """Assert kernel and plain outputs are bit-equal; return the max abs
    difference of the values (0.0 when they are)."""
    torch.cuda.synchronize()
    if not torch.equal(ki, pi):
        bad = (ki != pi).nonzero()[:5].tolist()
        raise AssertionError(f"indices differ at {bad}")
    if not torch.equal(kv.view(torch.int32), pv.view(torch.int32)):
        raise AssertionError("values differ in their bits")
    return float((kv.double() - pv.double()).abs().max())


def b1_inputs(b, n, d, seed, dev, tied=False, mask_frac=0.1):
    from hcrag_tpu_torch.ops.quantize import quantize_queries, quantize_rows

    rng = np.random.default_rng(seed)
    e = rng.standard_normal((n, d)).astype(np.float32)
    if tied:
        e[:] = e[0]
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    q = e[:b].copy() if tied else rng.standard_normal((b, d)).astype(np.float32)
    q = torch.nn.functional.normalize(torch.from_numpy(q).to(dev), dim=1)
    q8, qs = quantize_queries(q)
    e8, es = quantize_rows(e)
    mask = torch.from_numpy(rng.random(n) >= mask_frac).to(dev)
    return q8, qs, torch.from_numpy(e8).to(dev), torch.from_numpy(es).to(dev), mask


def phase_kernels(dev) -> dict:
    """Every kernel against its plain version; returns the max abs errors."""
    from hcrag_tpu_torch.ops import topk_cuda as tc

    err = {"int8_tile_topk": 0.0, "packed_candidate_merge": 0.0}

    def b1(name, args, k, tile):
        kv, ki = tc.int8_tile_topk(*args, k, tile_n=tile)
        pv, pi = tc.int8_tile_topk_plain(*args, k, tile_n=tile)
        e = same_bits(kv, ki, pv, pi)
        err["int8_tile_topk"] = max(err["int8_tile_topk"], e)
        log(f"  B1 {name}: b={args[0].shape[0]} n={args[2].shape[0]} "
            f"d={args[0].shape[1]} k={k} tile={tile}: bit-equal")
        return ki

    def b2(name, v, i, out_k):
        kv, ki = tc.packed_candidate_merge(v, i, out_k)
        pv, pi = tc.packed_candidate_merge_plain(v, i, out_k)
        e = same_bits(kv, ki, pv, pi)
        err["packed_candidate_merge"] = max(err["packed_candidate_merge"], e)
        b, tiles, k = v.shape
        log(f"  B2 {name}: b={b} pool={tiles} x {k} out_k={out_k}: bit-equal")

    # The main path's width and tile: b=512 over 20 tiles of 2048, the last
    # ragged, a tenth of the rows masked.
    b1("bench", b1_inputs(512, 40_000, DIM, 0, dev), TOP_K, 2048)
    ki = b1("all_tied", b1_inputs(64, 5000, DIM, 1, dev, tied=True, mask_frac=0.0),
            TOP_K, 1024)
    want = (torch.arange(5, device=dev)[:, None] * 1024
            + torch.arange(TOP_K, device=dev)).to(torch.int32)
    if not torch.equal(ki, want.expand(64, 5, TOP_K)):
        raise AssertionError("all-tied rows did not give the lowest indices")
    k_raised = tc.tile_pick_count(TOP_K, 2100, 2048, RESCORE)
    if k_raised != 16:
        raise AssertionError(f"pick-count raise gave {k_raised}, want 16")
    b1("pick_raise", b1_inputs(100, 2100, DIM, 2, dev), k_raised, 2048)
    b1("k128_ragged_queries", b1_inputs(130, 4096, 128, 3, dev), 128, 2048)

    # B2 reads B1's [b, tiles, k] output; the last twentieth of the tiles
    # hold only fillers.
    rng = np.random.default_rng(4)
    for name, b, tiles, ties in (("bench", 512, 489, False),
                                 ("ties", 64, 489, True),
                                 ("small_pool", 64, 100, False)):
        v = (rng.standard_normal((b, tiles, TOP_K)) * 0.1).astype(np.float32)
        if ties:
            v = np.round(v * 8) / 8
        v[:, -tiles // 20:] = -1e30
        i = rng.integers(0, N_ROWS, size=(b, tiles, TOP_K)).astype(np.int32)
        i[:, -tiles // 20:] = -1
        b2(name, torch.from_numpy(v.astype(np.float32)).to(dev),
           torch.from_numpy(i).to(dev), RESCORE)

    # A pool below 4096 takes the stable sort, not B2.
    vals, idxs = tc.int8_tile_topk(*b1_inputs(64, 40_000, DIM, 5, dev), TOP_K)
    before = tc.packed_candidate_merge.launches
    tc.merge_tile_candidates(vals, idxs, RESCORE)
    if tc.packed_candidate_merge.launches != before:
        raise AssertionError("a 200-candidate pool was routed through B2")
    log("  merge routing: pool 200 < 4096 takes the stable sort")
    return err


def recall_at_k(emb_f32: torch.Tensor, queries: torch.Tensor, got: np.ndarray) -> float:
    """recall@k of `got` against f32 brute force with ties to the lowest
    index, over the first GATE_QUERIES queries (row chunks of 250k)."""
    q = queries[:GATE_QUERIES]
    best_v = torch.full((q.shape[0], TOP_K), -float("inf"), device=q.device)
    best_i = torch.zeros((q.shape[0], TOP_K), dtype=torch.int64, device=q.device)
    chunk = 250_000
    for lo in range(0, emb_f32.shape[0], chunk):
        s = q @ emb_f32[lo:lo + chunk].T
        cv, ci = torch.sort(s, dim=1, descending=True, stable=True)
        allv = torch.cat([best_v, cv[:, :TOP_K]], dim=1)
        alli = torch.cat([best_i, ci[:, :TOP_K] + lo], dim=1)
        order = torch.sort(allv, dim=1, descending=True, stable=True).indices[:, :TOP_K]
        best_v, best_i = allv.gather(1, order), alli.gather(1, order)
    ref = best_i.cpu().numpy()
    hits = sum(len(set(got[b].tolist()) & set(ref[b].tolist())) for b in range(len(ref)))
    return hits / (len(ref) * TOP_K)


def check_small_against_cpu(dev) -> None:
    """The card engine equals the CPU engine (plain versions) on a small
    index: exact indices and expansion, scores to atol 1e-5 (f32 sums in
    another order).  With TF32 enabled the card engine gives the same bits:
    the step takes no f32 matrix product."""
    from hcrag_tpu_torch.query.engine import QueryEngine
    from hcrag_tpu_torch.utils.synthetic import synthetic_setup

    index, graph = synthetic_setup(20_000, DIM, graph_degree=4)
    opts = dict(quantize_int8=True, int8_rescore=RESCORE, int8_f32_rescore=True,
                select_lane_t=1, ell_max_degree=8)
    q = np.random.default_rng(11).standard_normal((64, DIM)).astype(np.float32)
    gpu = QueryEngine(index, graph, device=dev, **opts)
    rg = gpu.query_batch(q, top_k=TOP_K)
    rc = QueryEngine(index, graph, device="cpu", **opts).query_batch(q, top_k=TOP_K)
    for f in ("top_indices", "expanded_nodes", "expanded_counts"):
        np.testing.assert_array_equal(getattr(rg, f), getattr(rc, f), err_msg=f)
    for f in ("top_scores", "relevance", "combined", "expanded_relevance"):
        np.testing.assert_allclose(getattr(rg, f), getattr(rc, f), atol=1e-5,
                                   rtol=0, err_msg=f)
    log("  small index (20,000 x 384, B=64): card engine == CPU engine")
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
        rt = gpu.query_batch(q, top_k=TOP_K)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
    for f in ("top_scores", "top_indices", "relevance", "combined",
              "expanded_nodes", "expanded_counts", "expanded_relevance"):
        np.testing.assert_array_equal(getattr(rt, f), getattr(rg, f), err_msg=f)
    log("  small index with TF32 enabled: the same bits as without")


def profile_step(step, card: str, steps: int = 3) -> None:
    """Device time by kernel over a few steps (torch.profiler), and the
    device's busy share of that window's wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for evt in prof.key_averages():
        # Device-side events only (kernels, copies): the host ops above them
        # report the same device time again.
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us, evt.key, evt.count))
    total = sum(r[0] for r in rows)
    if not total:
        log("[profile] the profiler saw no device time: not measured")
        return
    log(f"[profile] {steps} steps: device busy {total / 1e3:.3f} ms of "
        f"{wall_us / 1e3:.3f} ms wall ({100 * total / wall_us:.1f}%); {card}")
    for dev_us, key, count in sorted(rows, reverse=True)[:10]:
        log(f"[profile]   {dev_us / steps / 1e3:9.3f} ms/step  "
            f"{100 * dev_us / total:5.1f}%  x{count // steps:<4d} {key[:70]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    from hcrag_tpu_torch.ops import _build
    from hcrag_tpu_torch.ops import topk_cuda as tc
    from hcrag_tpu_torch.ops.quantize import quantize_queries
    from hcrag_tpu_torch.query.engine import QueryEngine
    from hcrag_tpu_torch.utils.synthetic import synthetic_setup

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    # 1. card ---------------------------------------------------------------
    card = card_line()
    log(card)
    log(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")

    # 2. build --------------------------------------------------------------
    kernels = ("int8_tile_topk", "packed_candidate_merge")
    t0 = time.time()
    reports = _build.build(kernels)
    log(f"[build] {len(reports)} of {len(kernels)} kernels built in "
        f"{time.time() - t0:.1f} s (nvcc -gencode arch=compute_90a,code=sm_90a)")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    # 3. kernels against their plain versions -------------------------------
    log("[kernels] kernel vs plain PyTorch version, bit for bit")
    max_err = phase_kernels(dev)

    # 4. main path ------------------------------------------------------------
    t0 = time.time()
    index, graph = synthetic_setup(N_ROWS, DIM, graph_degree=4)
    log(f"[main] synthetic index {N_ROWS} x {DIM} + graph built in "
        f"{time.time() - t0:.1f} s (host)")
    t0 = time.time()
    engine = QueryEngine(
        index, graph, device=dev, quantize_int8=True, int8_rescore=RESCORE,
        int8_f32_rescore=True, select_lane_t=1, ell_max_degree=8,
    )
    torch.cuda.synchronize()
    log(f"[main] engine ready in {time.time() - t0:.1f} s; resolved: "
        f"{json.dumps(engine.resolved_kernel_config(BATCH, TOP_K))}")
    rng = np.random.default_rng(7)
    queries = rng.standard_normal((BATCH, DIM)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)

    tc.int8_tile_topk.launches = 0
    tc.packed_candidate_merge.launches = 0
    t0 = time.time()
    res = engine.query_batch(queries, top_k=TOP_K, expansion_depth=DEPTH)
    first_s = time.time() - t0
    launches = {
        "int8_tile_topk": tc.int8_tile_topk.launches,
        "packed_candidate_merge": tc.packed_candidate_merge.launches,
    }
    log(f"[main] query_batch B={BATCH} k={TOP_K} depth={DEPTH}: first call "
        f"{first_s:.2f} s, launches {launches}")
    for name, count in launches.items():
        if count < 1:
            raise AssertionError(f"the main path never launched {name}")

    shapes = {
        "top_scores": (BATCH, TOP_K), "top_indices": (BATCH, TOP_K),
        "relevance": (BATCH, TOP_K), "combined": (BATCH, TOP_K),
        "expanded_nodes": (BATCH, 20), "expanded_counts": (BATCH,),
        "expanded_relevance": (BATCH, 20),
    }
    for f, shape in shapes.items():
        a = getattr(res, f)
        if a.shape != shape or not np.isfinite(a).all():
            raise AssertionError(f"{f}: shape {a.shape} (want {shape}) or non-finite")
    if not ((res.top_indices >= 0) & (res.top_indices < N_ROWS)).all():
        raise AssertionError("top_indices out of range")
    if not ((res.expanded_counts >= 0) & (res.expanded_counts <= 20)).all():
        raise AssertionError("expanded_counts out of range")
    if not (np.diff(res.top_scores, axis=1) <= 0).all():
        raise AssertionError("top_scores not descending")

    recall = recall_at_k(engine.d_emb_f32[:N_ROWS], torch.from_numpy(queries).to(dev),
                         res.top_indices)
    log(f"[main] recall@{TOP_K} vs f32 brute force ({GATE_QUERIES} queries): "
        f"{recall:.4f} (gate {MIN_RECALL})")
    if recall < MIN_RECALL:
        raise AssertionError(f"recall {recall} below {MIN_RECALL}")
    check_small_against_cpu(dev)

    # Step time: the async step, back to back, CUDA events.
    dq = torch.from_numpy(queries).to(dev)
    step = lambda: engine.query_batch_device(dq, top_k=TOP_K, expansion_depth=DEPTH)  # noqa: E731
    torch.cuda.reset_peak_memory_stats()
    step_ms = cuda_ms(step, reps=5)
    log(f"[main] step {step_ms:.3f} ms, {BATCH / step_ms * 1e3:.1f} QPS "
        f"(CUDA events, 5 steps; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {card})")
    profile_step(step, card)

    # Each kernel at the main path's shapes.
    bank = engine._bank()
    e8, es = bank["emb_int8"], bank["emb_scale"]
    n_bank = e8.shape[0]
    mask = torch.zeros(n_bank, dtype=torch.bool, device=dev)
    mask[:N_ROWS] = True
    q8, qs = quantize_queries(dq)
    vals, idxs = tc.int8_tile_topk(q8, qs, e8, es, mask, TOP_K)
    err = same_bits(vals, idxs, *tc.int8_tile_topk_plain(q8, qs, e8, es, mask, TOP_K))
    max_err["int8_tile_topk"] = max(max_err["int8_tile_topk"], err)
    b, tiles, k = vals.shape
    pool = tiles * k
    out_k = RESCORE
    err = same_bits(*tc.packed_candidate_merge(vals, idxs, out_k),
                    *tc.packed_candidate_merge_plain(vals, idxs, out_k))
    max_err["packed_candidate_merge"] = max(max_err["packed_candidate_merge"], err)
    log("[main] B1 and B2 at the main path's shapes: bit-equal to their plain versions")

    b1_ms = cuda_ms(lambda: tc.int8_tile_topk(q8, qs, e8, es, mask, TOP_K), reps=3)
    b1_plain_ms = cuda_ms(
        lambda: tc.int8_tile_topk_plain(q8, qs, e8, es, mask, TOP_K), reps=1)
    b2_ms = cuda_ms(lambda: tc.packed_candidate_merge(vals, idxs, out_k), reps=20)
    b2_plain_ms = cuda_ms(
        lambda: tc.packed_candidate_merge_plain(vals, idxs, out_k), reps=5)
    flat = vals.view(b, pool)
    b2_lib_ms = cuda_ms(lambda: torch.topk(flat, out_k, dim=1), reps=20)

    b1_ops = 2.0 * BATCH * n_bank * DIM
    b1_bytes = (q8.numel() + 4 * qs.numel() + e8.numel() + 4 * es.numel()
                + mask.numel() + 8 * vals.numel())
    # B2 reads every value once, gathers out_k indices per query (one
    # 32-byte sector each) and writes (value, index) pairs.
    b2_bytes = 4 * vals.numel() + 32 * BATCH * out_k + 8 * BATCH * out_k
    b1_bound = max(b1_ops / PEAK_INT8_OPS, b1_bytes / PEAK_BYTES) * 1e3
    b2_bound = b2_bytes / PEAK_BYTES * 1e3
    log(f"[main] B1 int8_tile_topk B={BATCH} N={n_bank} tiles={tiles}: "
        f"{b1_ms:.3f} ms (plain {b1_plain_ms:.3f} ms, bound {b1_bound:.3f} ms "
        f"by operations; {card})")
    log(f"[main] B2 packed_candidate_merge B={BATCH} pool={pool} out_k={out_k}: "
        f"{b2_ms:.3f} ms (plain {b2_plain_ms:.3f} ms, torch.topk {b2_lib_ms:.3f} ms, "
        f"bound {b2_bound:.4f} ms by bytes; {card})")

    summary = {"kernels": [
        {"name": "int8_tile_topk", "route": "cuda",
         "source": "hcrag_tpu_torch/csrc/int8_tile_topk.cu",
         "replaces": "hcrag_tpu/ops/topk_pallas.py:535",
         "launches": launches["int8_tile_topk"],
         "max_abs_err": max_err["int8_tile_topk"],
         "ms": b1_ms, "plain_ms": b1_plain_ms, "bound_ms": b1_bound,
         "bound_by": "operations" if b1_ops / PEAK_INT8_OPS > b1_bytes / PEAK_BYTES
         else "bytes",
         "library_ms": None},
        {"name": "packed_candidate_merge", "route": "cuda",
         "source": "hcrag_tpu_torch/csrc/packed_candidate_merge.cu",
         "replaces": "hcrag_tpu/ops/topk_pallas.py:808",
         "launches": launches["packed_candidate_merge"],
         "max_abs_err": max_err["packed_candidate_merge"],
         "ms": b2_ms, "plain_ms": b2_plain_ms, "bound_ms": b2_bound,
         "bound_by": "bytes", "library_ms": b2_lib_ms},
    ]}
    print(json.dumps(summary), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
