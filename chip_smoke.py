#!/usr/bin/env python3
"""Smoke run of the PyTorch port (hcrag_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero before the
last line:

  1. card    — the card's name and power limit (nvidia-smi);
  2. build   — nvcc builds every kernel source from csrc/, all in parallel
               (sm_90a);
  3. kernels — every kernel against its plain PyTorch version on the card:
               B1 and B2 bit for bit (b=512 at D=384 over 20 tiles with a
               ragged last tile and masked rows, the 4890-candidate pool,
               all-tied input, a small pool, the per-tile pick-count
               raise); B4 (f32 and bf16 banks) and B5 at the same shapes
               under the rules of `hcrag_tpu_torch/testing.py`, and exactly
               on a zero query, on one-hot queries under a filter that
               leaves fewer than k rows in a tile, and in the pick-count
               raise case;
  4. int8 path — `QueryEngine.query_batch` at 1,000,000 x 384, B=8192,
               top_k=10, depth 1 in the int8-select + f32-rescore mode
               (kernels B1, B2): launch counts from that run, recall@10
               against f32 brute force on 256 queries, the card engine
               against the CPU engine on a small index, a profile of the
               step, B1 and B2 against their plain versions at the path's
               shapes, the card engine with TF32 enabled against itself
               without it, then timings (CUDA events) of the step and of
               each kernel beside its plain version, its bound and, where
               one exists, a one-call PyTorch equivalent;
  5. path F2 — the same index in `bench.py`'s bf16 mode (`exact_rescore=32`:
               B5 over a bf16 bank, B2, the f32 rescore), B=8192: launch
               counts, recall, card vs CPU engine, step time, B5 at the
               path's shapes;
  6. path F1 — the default engine (B4 over the f32 bank), `query_batch` at
               B=1024, then `process_query`, `find_similar_content`,
               `search_by_category` (every 500th row re-typed) and
               `retrieve_batch_device` at B=1024, each of which must launch
               B4; recall, card vs CPU engine, step time, B4 at the path's
               shapes.

The synthetic index is built once and shared; each engine is freed before
the next.  The second-to-last line is a JSON object listing the kernels; the
last is {"ok": true, "device": {...}}.  Exits non-zero without a result when
CUDA is unavailable or the package is missing.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from hcrag_tpu_torch.utils.bounds import bound_ms

N_ROWS, DIM, BATCH, TOP_K, DEPTH = 1_000_000, 384, 8192, 10, 1
F1_BATCH = 1024  # the JAX float path's own sub-batch
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


def float_inputs(b, n, d, seed, dev, dtype, mask_frac=0.1):
    rng = np.random.default_rng(seed)
    e = rng.standard_normal((n, d)).astype(np.float32)
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    q = rng.standard_normal((b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    mask = torch.from_numpy(rng.random(n) >= mask_frac).to(dev)
    return (torch.from_numpy(q).to(dev, dtype), torch.from_numpy(e).to(dev, dtype),
            mask)


def phase_float_kernels(dev, err: dict) -> None:
    """B4 and B5 against their plain versions; updates the max abs errors
    in `err`."""
    from hcrag_tpu_torch.ops import topk_cuda as tc
    from hcrag_tpu_torch.testing import check_exact_topk, check_packed_topk

    def run(kernel, args, k, tile):
        out = getattr(tc, kernel)(*args, k, tile_n=tile)
        plain = getattr(tc, kernel + "_plain")(*args, k, tile_n=tile)
        torch.cuda.synchronize()
        return out + plain

    def b4(name, args, k=TOP_K, tile=2048):
        kv, ki, pv, pi = run("float_tile_topk", args, k, tile)
        e, moved = check_exact_topk(kv, ki, pv, pi, *args)
        err["float_tile_topk"] = max(err["float_tile_topk"], e)
        log(f"  B4 {name}: b={args[0].shape[0]} n={args[1].shape[0]} "
            f"d={args[0].shape[1]} {str(args[1].dtype)[6:]} k={k} tile={tile}: "
            f"max |err| {e:.3g}, {moved} indices at near-ties")
        return kv, ki, pv, pi

    def b5(name, args, k=TOP_K, tile=2048):
        kv, ki, pv, pi = run("float_packed_tile_topk", args, k, tile)
        e, moved = check_packed_topk(kv, ki, pv, pi, *args[:2])
        err["float_packed_tile_topk"] = max(err["float_packed_tile_topk"], e)
        log(f"  B5 {name}: b={args[0].shape[0]} n={args[1].shape[0]} "
            f"d={args[0].shape[1]} {str(args[1].dtype)[6:]} k={k} tile={tile}: "
            f"max |err| {e:.3g}, {moved} tiles next to a key-quantum boundary")
        return kv, ki, pv, pi

    def exact(name, kv, ki, pv, pi):
        if not (torch.equal(ki, pi) and torch.equal(kv.view(torch.int32),
                                                    pv.view(torch.int32))):
            raise AssertionError(f"{name}: kernel and plain version differ")
        log(f"  {name}: bit-equal")

    # The main path's width and tile: b=512 over 20 tiles of 2048, the last
    # ragged, a tenth of the rows masked.
    for dtype in (torch.float32, torch.bfloat16):
        b4("bench", float_inputs(512, 40_000, DIM, 20, dev, dtype))
    b5("bench", float_inputs(512, 40_000, DIM, 21, dev, torch.bfloat16))
    b5("bench_f32_bank", float_inputs(256, 40_000, DIM, 22, dev, torch.float32))

    # A zero query ties every row: the lowest rows win, exactly.
    q, e, mask = float_inputs(64, 5000, DIM, 23, dev, torch.bfloat16, mask_frac=0.0)
    q.zero_()
    out = b4("zero_query", (q, e, mask), tile=1024)
    exact("B4 zero_query", *out)
    want = (torch.arange(5, device=dev)[:, None] * 1024
            + torch.arange(TOP_K, device=dev)).to(torch.int32)
    if not torch.equal(out[1], want.expand(64, 5, TOP_K)):
        raise AssertionError("B4: a zero query did not give the lowest rows")
    exact("B5 zero_query", *b5("zero_query", (q, e, mask), tile=1024))

    # One-hot queries (their dots are exact in any order) under a filter
    # that leaves 3 rows: B4 fills with (-1e30, tile's first row), B5 with
    # (-1e30, -1).
    for dtype in (torch.float32, torch.bfloat16):
        _, e, _ = float_inputs(128, 5000, DIM, 24, dev, dtype)
        q = torch.eye(DIM, device=dev, dtype=dtype)[:128]
        mask = torch.zeros(5000, dtype=torch.bool, device=dev)
        mask[[5, 2100, 4999]] = True
        exact(f"B4 filter_3_rows {str(dtype)[6:]}", *b4("filter_3_rows", (q, e, mask)))
        exact(f"B5 filter_3_rows {str(dtype)[6:]}", *b5("filter_3_rows", (q, e, mask)))

    # The pick-count raise: two tiles cannot give 32 candidates at k=10.
    k_raised = tc.tile_pick_count(TOP_K, 2100, 2048, RESCORE)
    if k_raised != 16:
        raise AssertionError(f"pick-count raise gave {k_raised}, want 16")
    b5("pick_raise", float_inputs(100, 2100, DIM, 25, dev, torch.bfloat16), k_raised)
    b4("k128_ragged_queries", float_inputs(130, 4096, 128, 26, dev, torch.float32), 128)
    b5("k128_ragged_queries", float_inputs(130, 4096, 128, 27, dev, torch.bfloat16), 128)


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


def check_small_against_cpu(dev, label: str, opts: dict, tf32: bool = False) -> None:
    """The card engine equals the CPU engine (plain versions) on a small
    index: exact indices and expansion, scores to atol 1e-5 (f32 sums in
    another order).  With `tf32`, also: the card engine with TF32 enabled
    gives the same bits (the step takes no f32 matrix product)."""
    from hcrag_tpu_torch.query.engine import QueryEngine
    from hcrag_tpu_torch.utils.synthetic import synthetic_setup

    index, graph = synthetic_setup(20_000, DIM, graph_degree=4)
    q = np.random.default_rng(11).standard_normal((64, DIM)).astype(np.float32)
    gpu = QueryEngine(index, graph, device=dev, **opts)
    rg = gpu.query_batch(q, top_k=TOP_K)
    rc = QueryEngine(index, graph, device="cpu", **opts).query_batch(q, top_k=TOP_K)
    for f in ("top_indices", "expanded_nodes", "expanded_counts"):
        np.testing.assert_array_equal(getattr(rg, f), getattr(rc, f), err_msg=f)
    for f in ("top_scores", "relevance", "combined", "expanded_relevance"):
        np.testing.assert_allclose(getattr(rg, f), getattr(rc, f), atol=1e-5,
                                   rtol=0, err_msg=f)
    log(f"  {label}: small index (20,000 x 384, B=64): card engine == CPU engine")
    if not tf32:
        return
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
    log(f"  {label}: small index with TF32 enabled: the same bits as without")


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


def check_result(res, batch: int) -> None:
    """Finite outputs of the expected shapes, indices in range, scores
    descending."""
    shapes = {
        "top_scores": (batch, TOP_K), "top_indices": (batch, TOP_K),
        "relevance": (batch, TOP_K), "combined": (batch, TOP_K),
        "expanded_nodes": (batch, 20), "expanded_counts": (batch,),
        "expanded_relevance": (batch, 20),
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


def drive(engine, queries: np.ndarray, counted, label: str) -> dict:
    """One `query_batch` with every launch counter at 0 just before it;
    returns the counts read just after.  Every kernel in `counted` must
    have launched."""
    from hcrag_tpu_torch.ops import topk_cuda as tc

    for name in KERNELS:
        getattr(tc, name).launches = 0
    t0 = time.time()
    res = engine.query_batch(queries, top_k=TOP_K, expansion_depth=DEPTH)
    first_s = time.time() - t0
    launches = {name: getattr(tc, name).launches for name in KERNELS}
    log(f"[{label}] query_batch B={len(queries)} k={TOP_K} depth={DEPTH}: first "
        f"call {first_s:.2f} s, launches {launches}")
    for name in counted:
        if launches[name] < 1:
            raise AssertionError(f"path {label} never launched {name}")
    check_result(res, len(queries))
    bank = engine.d_emb_f32 if engine.d_emb_f32 is not None else engine.d_emb
    recall = recall_at_k(bank[:N_ROWS], torch.from_numpy(queries).to(bank.device),
                         res.top_indices)
    log(f"[{label}] recall@{TOP_K} vs f32 brute force ({GATE_QUERIES} queries): "
        f"{recall:.4f} (gate {MIN_RECALL})")
    if recall < MIN_RECALL:
        raise AssertionError(f"{label}: recall {recall} below {MIN_RECALL}")
    return launches


def time_step(engine, dq, label: str, card: str, reps: int) -> float:
    step = lambda: engine.query_batch_device(dq, top_k=TOP_K, expansion_depth=DEPTH)  # noqa: E731
    torch.cuda.reset_peak_memory_stats()
    step_ms = cuda_ms(step, reps=reps)
    log(f"[{label}] step {step_ms:.3f} ms, {len(dq) / step_ms * 1e3:.1f} QPS "
        f"(CUDA events, {reps} steps; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {card})")
    profile_step(step, card)
    return step_ms


def path_mask(n_bank: int, dev) -> torch.Tensor:
    mask = torch.zeros(n_bank, dtype=torch.bool, device=dev)
    mask[:N_ROWS] = True
    return mask


KERNELS = ("int8_tile_topk", "packed_candidate_merge", "float_tile_topk",
           "float_packed_tile_topk")
SOURCES = {
    "int8_tile_topk": ("hcrag_tpu_torch/csrc/int8_tile_topk.cu",
                       "hcrag_tpu/ops/topk_pallas.py:535"),
    "packed_candidate_merge": ("hcrag_tpu_torch/csrc/packed_candidate_merge.cu",
                               "hcrag_tpu/ops/topk_pallas.py:808"),
    "float_tile_topk": ("hcrag_tpu_torch/csrc/float_tile_topk.cu",
                        "hcrag_tpu/ops/topk_pallas.py:36"),
    "float_packed_tile_topk": ("hcrag_tpu_torch/csrc/float_tile_topk.cu",
                               "hcrag_tpu/ops/topk_pallas.py:441"),
}


def path_int8(index, graph, queries, dev, card, max_err, rows) -> None:
    """The int8 path: int8 select + f32 rescore, B=8192 (B1, B2)."""
    from hcrag_tpu_torch.ops import topk_cuda as tc
    from hcrag_tpu_torch.ops.quantize import quantize_queries
    from hcrag_tpu_torch.query.engine import QueryEngine

    t0 = time.time()
    engine = QueryEngine(
        index, graph, device=dev, quantize_int8=True, int8_rescore=RESCORE,
        int8_f32_rescore=True, select_lane_t=1, ell_max_degree=8,
    )
    torch.cuda.synchronize()
    log(f"[int8] engine ready in {time.time() - t0:.1f} s; resolved: "
        f"{json.dumps(engine.resolved_kernel_config(BATCH, TOP_K))}")
    launches = drive(engine, queries, ("int8_tile_topk", "packed_candidate_merge"), "int8")
    check_small_against_cpu(dev, "int8", dict(
        quantize_int8=True, int8_rescore=RESCORE, int8_f32_rescore=True,
        select_lane_t=1, ell_max_degree=8), tf32=True)
    dq = torch.from_numpy(queries).to(dev)
    time_step(engine, dq, "int8", card, reps=5)

    # Each kernel at the path's shapes.
    bank = engine._bank()
    e8, es = bank["emb_int8"], bank["emb_scale"]
    n_bank = e8.shape[0]
    mask = path_mask(n_bank, dev)
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
    log("[int8] B1 and B2 at the path's shapes: bit-equal to their plain versions")

    b1_ms = cuda_ms(lambda: tc.int8_tile_topk(q8, qs, e8, es, mask, TOP_K), reps=3)
    b1_plain_ms = cuda_ms(
        lambda: tc.int8_tile_topk_plain(q8, qs, e8, es, mask, TOP_K), reps=1)
    b2_ms = cuda_ms(lambda: tc.packed_candidate_merge(vals, idxs, out_k), reps=20)
    b2_plain_ms = cuda_ms(
        lambda: tc.packed_candidate_merge_plain(vals, idxs, out_k), reps=5)
    flat = vals.view(b, pool)
    b2_lib_ms = cuda_ms(lambda: torch.topk(flat, out_k, dim=1), reps=20)

    b1_bytes = (q8.numel() + 4 * qs.numel() + e8.numel() + 4 * es.numel()
                + mask.numel() + 8 * vals.numel())
    b1_bound, b1_by = bound_ms(2.0 * BATCH * n_bank * DIM, "int8", b1_bytes)
    # B2 reads every value once, gathers out_k indices per query (one
    # 32-byte sector each) and writes (value, index) pairs.
    b2_bytes = 4 * vals.numel() + 32 * BATCH * out_k + 8 * BATCH * out_k
    b2_bound, _ = bound_ms(0.0, "int8", b2_bytes)
    log(f"[int8] B1 int8_tile_topk B={BATCH} N={n_bank} tiles={tiles}: "
        f"{b1_ms:.3f} ms (plain {b1_plain_ms:.3f} ms, bound {b1_bound:.3f} ms "
        f"by {b1_by}; {card})")
    log(f"[int8] B2 packed_candidate_merge B={BATCH} pool={pool} out_k={out_k}: "
        f"{b2_ms:.3f} ms (plain {b2_plain_ms:.3f} ms, torch.topk {b2_lib_ms:.3f} ms, "
        f"bound {b2_bound:.4f} ms by bytes; {card})")
    rows["int8_tile_topk"] = dict(
        launches=launches["int8_tile_topk"], ms=b1_ms, plain_ms=b1_plain_ms,
        bound_ms=b1_bound, bound_by=b1_by, library_ms=None)
    rows["packed_candidate_merge"] = dict(
        launches=launches["packed_candidate_merge"], ms=b2_ms,
        plain_ms=b2_plain_ms, bound_ms=b2_bound, bound_by="bytes",
        library_ms=b2_lib_ms)


def path_f2(index, graph, queries, dev, card, max_err, rows) -> None:
    """bench.py's bf16 mode: B5 over a bf16 bank, B2, the f32 rescore,
    B=8192."""
    from hcrag_tpu_torch.ops import topk_cuda as tc
    from hcrag_tpu_torch.query.engine import QueryEngine
    from hcrag_tpu_torch.testing import check_packed_topk

    opts = dict(exact_rescore=RESCORE, select_lane_t=1, ell_max_degree=8)
    t0 = time.time()
    engine = QueryEngine(index, graph, device=dev, **opts)
    torch.cuda.synchronize()
    log(f"[F2] engine ready in {time.time() - t0:.1f} s; resolved: "
        f"{json.dumps(engine.resolved_kernel_config(BATCH, TOP_K))}")
    launches = drive(engine, queries, ("float_packed_tile_topk", "packed_candidate_merge"),
                     "F2")
    check_small_against_cpu(dev, "F2", opts)
    dq = torch.from_numpy(queries).to(dev)
    time_step(engine, dq, "F2", card, reps=3)

    e = engine.d_emb
    n_bank = e.shape[0]
    mask = path_mask(n_bank, dev)
    qb = dq.to(torch.bfloat16)
    k = tc.tile_pick_count(TOP_K, n_bank, 2048, RESCORE)
    kv, ki = tc.float_packed_tile_topk(qb, e, mask, k)
    pv, pi = tc.float_packed_tile_topk_plain(qb, e, mask, k)
    err, moved = check_packed_topk(kv, ki, pv, pi, qb, e)
    max_err["float_packed_tile_topk"] = max(max_err["float_packed_tile_topk"], err)
    log(f"[F2] B5 at the path's shapes: agrees with its plain version "
        f"(max |err| {err:.3g}, {moved} of {kv.shape[0] * kv.shape[1]} tiles next to "
        f"a key-quantum boundary)")
    del kv, ki, pv, pi
    b5_ms = cuda_ms(lambda: tc.float_packed_tile_topk(qb, e, mask, k), reps=2)
    b5_plain_ms = cuda_ms(lambda: tc.float_packed_tile_topk_plain(qb, e, mask, k),
                          reps=1, warmup=0)
    tiles = -(-n_bank // 2048)
    b5_bytes = 2 * qb.numel() + 2 * e.numel() + mask.numel() + 8 * BATCH * tiles * k
    b5_bound, b5_by = bound_ms(2.0 * BATCH * n_bank * DIM, "bf16", b5_bytes)
    log(f"[F2] B5 float_packed_tile_topk B={BATCH} N={n_bank} tiles={tiles} bf16: "
        f"{b5_ms:.3f} ms (plain {b5_plain_ms:.3f} ms, bound {b5_bound:.3f} ms by "
        f"{b5_by}; {card})")
    rows["float_packed_tile_topk"] = dict(
        launches=launches["float_packed_tile_topk"], ms=b5_ms, plain_ms=b5_plain_ms,
        bound_ms=b5_bound, bound_by=b5_by, library_ms=None)
    log(f"[F2] B2 launches on this path: {launches['packed_candidate_merge']}")


def path_f1(index, graph, dev, card, max_err, rows) -> None:
    """The default engine: B4 over the f32 bank, B=1024, and the host API
    over it."""
    from hcrag_tpu_torch.ops import topk_cuda as tc
    from hcrag_tpu_torch.query.engine import QueryEngine
    from hcrag_tpu_torch.testing import check_exact_topk

    t0 = time.time()
    engine = QueryEngine(index, graph, ell_max_degree=8)  # the default: cuda, f32
    torch.cuda.synchronize()
    log(f"[F1] engine ready in {time.time() - t0:.1f} s; resolved: "
        f"{json.dumps(engine.resolved_kernel_config(F1_BATCH, TOP_K))}")
    rng = np.random.default_rng(8)
    queries = rng.standard_normal((F1_BATCH, DIM)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    launches = drive(engine, queries, ("float_tile_topk",), "F1")

    def moves_b4(label, fn):
        before = tc.float_tile_topk.launches
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        n = tc.float_tile_topk.launches - before
        log(f"[F1] {label}: {time.time() - t0:.3f} s, B4 launches {n}")
        if n < 1:
            raise AssertionError(f"{label} did not launch B4")
        return out

    out = moves_b4("process_query('red mountain bike')",
                   lambda: engine.process_query("red mountain bike", top_k=TOP_K))
    if set(out) != {"parsed_query", "search_text", "results", "summary",
                    "query_embedding"} or out["query_embedding"].shape != (DIM,):
        raise AssertionError(f"process_query returned {sorted(out)}")
    log(f"[F1]   {out['summary']}")
    hits = moves_b4("find_similar_content(row 123's embedding)",
                    lambda: engine.find_similar_content(index.emb[123], top_k=TOP_K))
    if not hits or hits[0]["content"] != index.texts[123] or \
            abs(hits[0]["similarity_score"] - 1.0) > 1e-5:
        raise AssertionError("find_similar_content did not return the row itself first")
    types = [m["type"] for m in index.metadata]
    try:
        for r, m in enumerate(index.metadata):
            m["type"] = "json_table" if r % 500 == 0 else "database_table"
        out = moves_b4("search_by_category(..., 'json_table')",
                       lambda: engine.search_by_category(
                           "red mountain bike", category_filter="json_table", top_k=TOP_K))
        rows_out = [r["metadata"]["row_index"] for r in out["results"]]
        if len(rows_out) != TOP_K or any(r % 500 for r in rows_out):
            raise AssertionError(f"search_by_category returned rows {rows_out}")
        log(f"[F1]   {out['summary']}: rows {rows_out}")
    finally:
        for m, t in zip(index.metadata, types):
            m["type"] = t
    dq = torch.from_numpy(queries).to(dev)
    v, i = moves_b4(f"retrieve_batch_device(B={F1_BATCH})",
                    lambda: engine.retrieve_batch_device(dq, top_k=TOP_K))
    if tuple(i.shape) != (F1_BATCH, TOP_K) or not bool(torch.isfinite(v).all()):
        raise AssertionError("retrieve_batch_device gave a bad result")
    check_small_against_cpu(dev, "F1", dict(ell_max_degree=8))
    time_step(engine, dq, "F1", card, reps=5)

    e = engine.d_emb
    n_bank = e.shape[0]
    mask = path_mask(n_bank, dev)
    kv, ki = tc.float_tile_topk(dq, e, mask, TOP_K)
    pv, pi = tc.float_tile_topk_plain(dq, e, mask, TOP_K)
    err, moved = check_exact_topk(kv, ki, pv, pi, dq, e, mask)
    max_err["float_tile_topk"] = max(max_err["float_tile_topk"], err)
    log(f"[F1] B4 at the path's shapes: agrees with its plain version "
        f"(max |err| {err:.3g}, {moved} indices at near-ties)")
    b4_ms = cuda_ms(lambda: tc.float_tile_topk(dq, e, mask, TOP_K), reps=3)
    b4_plain_ms = cuda_ms(lambda: tc.float_tile_topk_plain(dq, e, mask, TOP_K), reps=1)
    tiles = -(-n_bank // 2048)
    b4_bytes = 4 * dq.numel() + 4 * e.numel() + mask.numel() + 8 * F1_BATCH * tiles * TOP_K
    b4_bound, b4_by = bound_ms(2.0 * F1_BATCH * n_bank * DIM, "f32", b4_bytes)
    log(f"[F1] B4 float_tile_topk B={F1_BATCH} N={n_bank} tiles={tiles} f32: "
        f"{b4_ms:.3f} ms (plain {b4_plain_ms:.3f} ms, bound {b4_bound:.3f} ms by "
        f"{b4_by}; {card})")
    rows["float_tile_topk"] = dict(
        launches=launches["float_tile_topk"], ms=b4_ms, plain_ms=b4_plain_ms,
        bound_ms=b4_bound, bound_by=b4_by, library_ms=None)


def free(label: str) -> None:
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"[{label}] engine freed; {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"still allocated")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    from hcrag_tpu_torch.ops import _build
    from hcrag_tpu_torch.ops import topk_cuda as tc
    from hcrag_tpu_torch.utils.synthetic import synthetic_setup

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    t_start = time.time()

    # 1. card ---------------------------------------------------------------
    card = card_line()
    log(card)
    log(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")

    # 2. build --------------------------------------------------------------
    t0 = time.time()
    reports = _build.build(tc.KERNEL_SOURCES)
    log(f"[build] {len(reports)} of {len(tc.KERNEL_SOURCES)} sources built in "
        f"{time.time() - t0:.1f} s (nvcc -gencode arch=compute_90a,code=sm_90a)")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    # 3. kernels against their plain versions -------------------------------
    log("[kernels] kernel vs plain PyTorch version")
    max_err = phase_kernels(dev)
    max_err.update(float_tile_topk=0.0, float_packed_tile_topk=0.0)
    phase_float_kernels(dev, max_err)

    # 4-6. the paths, over one shared index ------------------------------------
    t0 = time.time()
    index, graph = synthetic_setup(N_ROWS, DIM, graph_degree=4)
    log(f"[setup] synthetic index {N_ROWS} x {DIM} + graph built in "
        f"{time.time() - t0:.1f} s (host)")
    rng = np.random.default_rng(7)
    queries = rng.standard_normal((BATCH, DIM)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    rows: dict = {}
    path_int8(index, graph, queries, dev, card, max_err, rows)
    free("int8")
    path_f2(index, graph, queries, dev, card, max_err, rows)
    free("F2")
    path_f1(index, graph, dev, card, max_err, rows)
    free("F1")
    log(f"[done] {time.time() - t_start:.1f} s in all")

    summary = {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name][0],
         "replaces": SOURCES[name][1], "launches": rows[name]["launches"],
         "max_abs_err": max_err[name], "ms": rows[name]["ms"],
         "plain_ms": rows[name]["plain_ms"], "bound_ms": rows[name]["bound_ms"],
         "bound_by": rows[name]["bound_by"], "library_ms": rows[name]["library_ms"]}
        for name in KERNELS
    ]}
    print(json.dumps(summary), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
