#!/usr/bin/env python3
"""Smoke run of the PyTorch port (hcrag_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero before the
last line:

  1. card    — the card's name and power limit (nvidia-smi);
  2. build   — nvcc builds every kernel source from csrc/, all in parallel
               (sm_90a), and prints each kernel's registers, stack and spill
               bytes (ptxas), none of which may spill; the int8 library's
               machine code (cuobjdump) must show the int8 wgmma in every
               kernel of B1, B3e and B7i, and __dp4a in none;
  3. kernels — every kernel against its plain PyTorch version on the card:
               B1, B3e, B7i and B2 bit for bit (b=512 at D=384 over 20 tiles
               with a ragged last tile and masked rows, the 4890-candidate
               pool, all-tied input, a small pool; B1 and B7i on the int8
               tensor cores at k 1-128, d 16-768, tiles of 64-2048 rows and
               supertiles of 128 and 8192, batches of 1-8192, under a
               filter that leaves fewer than k rows; batches that put 8 and 2
               queries in a block with a partial last block, pools past
               one block's shared memory (10M rows at per-tile k = 12, and
               k = 128), the per-tile pick-count raise, B3e under filters
               that leave fewer than k rows in a tile or fewer than top_k
               in the bank, and on the int8 tensor cores at B1's edge
               shapes, d = 1040 and k 11-17, each kind of its lists); B4
               (f32 and bf16 banks) and B5 at the same shapes under the
               rules of `hcrag_tpu_torch/testing.py`, B4 on its CUDA-core
               loop's edge shapes (d 64 and 1024, tiles of 64 and 192 rows,
               k 1-128) by that rule and bit for bit on exact dots, and
               exactly on a zero query, on one-hot queries under a filter
               that leaves fewer than k rows in a tile, and in the
               pick-count raise case; B5 on the tensor cores bit for bit on
               exact dots at per-tile k 1, 10, 100 and 128, d 128 and 384,
               and by `testing.py` on normal inputs at the same shapes; the
               tensor-core loop's largest |dot - float64 dot| against
               `testing.TC_DOT_ERROR`; B6 within
               1e-5 in both regimes: the byte-bound kernel at query blocks
               of 1-16 (one query x 2048-32768 nodes, ragged node counts,
               scalar rows at d = 383, d = 1040) and the tiled CUDA-core
               loop (256 x 8192 nodes, both reductions, 17 and 300
               queries), and the shapes the loop refuses (d = 383, W = 210)
               at 16 queries a block; then both regimes' device times at
               17-256 queries (the route rule's data); B7i and B7f (f32 and
               bf16 banks; inputs whose dots are exact in any order) bit for
               bit at 2048-, 4096- and 8192-row supertiles with masked rows,
               a ragged last supertile, ragged queries, k_sub 1, 10, 100 and
               128 at d 128 and 384, and the small-pool pick raise, B7f on
               normal inputs by `testing.py`'s rule, and the supertile
               merge's routing (B2 from 1024);
  4. int8 path — `QueryEngine.query_batch` at 1,000,000 x 384, B=8192,
               top_k=10, depth 1 in the int8-select + f32-rescore mode
               (kernels B1, B2);
  5. path F2 — the same index in `bench.py`'s bf16 mode (`exact_rescore=32`:
               B5 over a bf16 bank, B2, the f32 rescore), B=8192;
     path S1 — the same index, `exact_rescore=32, pallas_super=8` (1024-row
               tiles grouped 8 at a time: 123 supertiles of 8192 rows), B=8192:
               B7f, B2 over the 123 x 16 pool, the f32 rescore;
     path S2 — the same index, `quantize_int8=True, int8_rescore=32,
               int8_f32_rescore=True, pallas_super=4` (2048 x 4 rows),
               B=8192: B7i, B2;
  6. path F1 — the default engine (B4 over the f32 bank), `query_batch` at
               B=1024, then `process_query`, `find_similar_content`,
               `search_by_category` (every 500th row re-typed) and
               `retrieve_batch_device` at B=1024, each of which must launch
               B4;
     path M  — the MiniLM query encoder on the card over F1's engine: the
               distilled weights (`tools/minilm_distilled*`) loaded and
               attached (`attach_device_encoder`), 1024 texts of the
               committed vocabulary encoded at max_len 64 and 192 (forward
               ms per batch by CUDA events, texts/s, peak memory; the card
               within 1e-4 of the CPU on 8 texts), their embeddings through
               `query_batch` (one B4 launch), `process_query` on text, and
               the encoder confidence over a 100,000-row slice (the auto
               rule's limit), on the host clock;
     path X  — the same rows with a degree-8 graph, `exact_rescore=32`,
               top_k=100, depth 3, B=256 (the JAX repo's expansion-heavy
               deployment): B5 at per-tile k = 100, B2 over 489 x 100 -> 100;
               then its breakdown: retrieval only, `expand_batch` at depth 3
               over random seeds, the dedup alone at C = 58,400, each held
               against the CPU on a few rows;
     paths L1, L2 — top_k = 256 (past the kernels' per-tile lists) through
               the JAX engine's route off the TPU, B=64 over the same rows:
               the default f32 engine and the int8 + f32 rescore engine;
               no selection kernel may launch; recall@256 against f32 brute
               force, the card against the CPU on 4 rows, the step's time;
  7. path D3 — the same rows rounded to bf16 (as `bench.py` hands the index
               in its BENCH_INT8_MODE="" mode), `quantize_int8=True,
               int8_rescore=32`: B1, B2, the rescore from bf16 rows, B=8192;
     refresh — the int8 + f32 rescore engine over the same rows, 10,000
               rows appended, `refresh_index` (seconds); queries equal to
               appended rows must return them first;
  8. path R  — `batch_isRelevant` over 8192 nodes (D=384) for the six
               multi-metric strategies, offline LLM client: one launch of
               B6 per call, scores against the CPU's plain route, host time
               of each call beside the unfused route on the card; B6's
               device time (CUDA-graph replays) at 1 x 2048, 8192 and 32768
               nodes and at the JAX ablation's 256 x 8192 (with and without
               the llm column), beside its bound and the dots alone; then both
               routes at 512, 2048, 8192 and 32768 nodes, ten calls each in
               turns, with the device's busy share of one call of each;
  9. path D1 — a 10,000,000 x 384 index, `quantize_int8=True,
               int8_residual=True, int8_rescore=32`, B=2048 (the JAX repo's
               10M one-chip deployment): B1, B2, the rescore from the
               int8 + residual reconstruction; then `cosine_top_k_int8(...,
               packed_select=False)` over its bank (kernel B3e);
     path S3 — the same rows, `int8_residual=True, int8_rescore=32,
               pallas_super=4`, B=2048: B7i, B2 over the 1221 x 16 pool;
 10. path D2 — the same rows rounded to bf16, `int8_only=True` (no
               rescore): B1 at per-tile k = top_k, the contract of B3's
               k-pass packed branch, and B2; its gate queries' top-10 must
               equal the plain route's.

Between the 1M-row paths and path R, path K runs the kernel sweep
(`hcrag_tpu_torch.benchmarks.kernel_sweep`) over its own bank, the JAX
sweep's data (1,001,472 x 384 bf16 rows, B=512): kernels B8a-c
(`matmul_only_acc`, `matmul_only_wide`, `encode_level1`), B5 + B2, B4, B5
alone and one cuBLAS bf16 product, B1 alone over the bank quantized on the
card and one `torch._int_mm` of the same int8 operands, each launch counted
per timed row; it
prints the sweep's JSON line, the split of the CUDA-core dot loop (B8a-c)
and B5 on the tensor cores beside the cuBLAS product, checks that B8a's
time per dot is the same at 128- and 2048-row tiles (no dot dropped), and
holds B8a-c against their plain versions at the sweep's shapes (B8a/B8b
within 1e-5, B8c by `testing.check_level1`), B4 alone by
`testing.check_exact_topk` and B1 bit for bit.  The
kernel phase also holds B8a-c bit for bit on exact dots (d=384; tiles of
2048, 1024 and 128 rows; b=512 and a ragged 200; negative keys in B8c).

Every engine path prints: launch counts (set to 0 just before its
`query_batch`; the supertile paths must not launch B1 or B5), recall@10
against f32 brute force on 256 queries (TF32 off), a small card-vs-CPU
engine check, host set-up time, step time (CUDA events),
a profile of the step, peak device memory, and its kernels at its shapes
against their plain versions, with their bounds; B2 also beside one
`torch.topk` over the same pool.  Each engine and index is
freed before the next.  The second-to-last line is a JSON object listing the
kernels; the last is {"ok": true, "device": {...}}.  Exits non-zero without
a result when CUDA is unavailable or the package is missing.
"""

from __future__ import annotations

import json
import resource
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
N_10M, D_BATCH = 10_000_000, 2048  # the density paths (results.json's B)
D2_MIN_RECALL = 0.90  # int8 selection without a rescore
# The rescore from bf16 rows cannot order f32 near-ties: the JAX repo
# recorded 0.9973 for this mode on the same 256 queries
# (benchmarks/results.json, synthetic_1M_int8_rescore).
D3_MIN_RECALL = 0.997
R_NODES = 8192
R_ROUTE_NODES = (512, 2048, 8192, 32768)  # path R's route data
SUPER_FLOAT, SUPER_INT8 = 8, 4  # pallas_super of path S1, of paths S2 and S3
X_TOP_K, X_DEPTH, X_BATCH, X_DEGREE = 100, 3, 256, 8  # path X
LARGE_K, LARGE_K_BATCH = 256, 64  # paths L1 and L2
M_TEXTS, M_CONF_ROWS = 1024, 100_000  # path M; the confidence's auto-rule limit
REFRESH_ROWS = 10_000  # rows the refresh phase appends
LARGE_K_MIN_RECALL_INT8 = 0.95


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


def check_int8_sass(build) -> None:
    """The built int8 library's machine code: every kernel of B1, B7i and
    B3e (the tensor-core template over Int8 with PackedKey, SuperKey and
    ExactKey, four instantiations each) issues the int8 wgmma (IGMMA, from
    wgmma.mma_async ... s32.s8.s8), and no kernel issues __dp4a (IDP.4A).
    Raises otherwise."""
    ops = build.sass_opcodes(build.library_path("int8_tile_topk"))
    for key in ("PackedKey", "SuperKey", "ExactKey"):
        fns = [f for f in ops if f.startswith("tc_tile_topk_kernel") and f"Int8,{key}" in f]
        if len(fns) != 4:
            raise AssertionError(f"expected 4 int8 tensor-core kernels of {key}, found "
                                 f"{sorted(ops)}")
    if len(ops) != 12:
        raise AssertionError(f"expected the 12 tensor-core kernels alone, found {sorted(ops)}")
    for f in sorted(ops):
        igmma = sum(op.startswith("IGMMA") for op in ops[f])
        idp = sum(op.startswith("IDP") for op in ops[f])
        log(f"[build] int8_tile_topk SASS: {f}: {igmma} IGMMA (int8 wgmma), {idp} IDP.4A "
            "(__dp4a)")
        if igmma < 1 or idp:
            raise AssertionError(f"{f}: not on the int8 tensor cores alone")
    log("[build] B1, B7i and B3e (int8_tile_topk, int8_super_tile_topk, "
        "int8_exact_tile_topk) run wgmma s32.s8.s8 in every instantiation; no kernel "
        "issues __dp4a")


# (b, n, d, k, tile_n) of B1 and (b, n, d, k_sub, lbits) of B7i on the int8
# tensor cores: k 1-16 take the register lists, 17-128 the shared-memory
# lists; d of 16 and 48 leave most of a 128-column chunk to the zero fill;
# tiles of 64-2048 rows and supertiles of 128 and 8192; batches of 1-8192
# (ragged query blocks); ragged last tiles; d = 768 at k = 128 is the widest
# block that still takes 128 queries.
INT8_TC_B1 = ((1, 3000, 16, 1, 64), (65, 9000, 48, 10, 1024), (130, 4500, 128, 16, 2048),
              (130, 5000, 384, 17, 2048), (65, 3000, 768, 64, 1024),
              (8192, 2100, 384, 10, 2048), (70, 4100, 128, 128, 2048),
              (130, 9000, 16, 64, 64), (130, 5000, 768, 128, 2048))
INT8_TC_B7I = ((65, 5000, 48, 16, 128), (130, 20_000, 384, 10, 8192),
               (1, 9000, 768, 128, 8192), (8192, 9000, 128, 17, 8192),
               (130, 3000, 16, 64, 128), (65, 20_000, DIM, 1, 8192))


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
        return kv, ki

    def b2(name, v, i, out_k):
        kv, ki = tc.packed_candidate_merge(v, i, out_k)
        pv, pi = tc.packed_candidate_merge_plain(v, i, out_k)
        e = same_bits(kv, ki, pv, pi)
        err["packed_candidate_merge"] = max(err["packed_candidate_merge"], e)
        b, tiles, k = v.shape
        ms = cuda_ms(lambda: tc.packed_candidate_merge(v, i, out_k), reps=5)
        wpq = tc.merge_warps(b)
        log(f"  B2 {name}: b={b} pool={tiles} x {k} out_k={out_k} ({wpq} warp(s) a query, "
            f"{8 // wpq} a block): bit-equal, {ms:.4f} ms")

    # The main path's width and tile: b=512 over 20 tiles of 2048, the last
    # ragged, a tenth of the rows masked.
    b1("bench", b1_inputs(512, 40_000, DIM, 0, dev), TOP_K, 2048)
    for k in (TOP_K, 64):
        _, ki = b1(f"all_tied k={k}", b1_inputs(64, 5000, DIM, 1, dev, tied=True,
                                                mask_frac=0.0), k, 1024)
        want = (torch.arange(5, device=dev)[:, None] * 1024
                + torch.arange(k, device=dev)).to(torch.int32)
        if not torch.equal(ki, want.expand(64, 5, k)):
            raise AssertionError("all-tied rows did not give the lowest indices")
    k_raised = tc.tile_pick_count(TOP_K, 2100, 2048, RESCORE)
    if k_raised != 16:
        raise AssertionError(f"pick-count raise gave {k_raised}, want 16")
    b1("pick_raise", b1_inputs(100, 2100, DIM, 2, dev), k_raised, 2048)
    b1("k128_ragged_queries", b1_inputs(130, 4096, 128, 3, dev), 128, 2048)
    # The int8 tensor-core loop at its edge shapes (INT8_TC_B1); then a
    # filter that leaves 3 rows in tile 0, whose other slots are fillers,
    # under both epilogues.
    for b, n, d, k, tile in INT8_TC_B1:
        b1("tensor_core", b1_inputs(b, n, d, 10 + k + d, dev), k, tile)
    for k in (TOP_K, 64):
        q8, qs, e8, es, mask = b1_inputs(130, 9000, DIM, 11 + k, dev)
        mask[:2048] = False
        mask[[5, 700, 2000]] = True
        kv, ki = b1("filter_3_rows_in_tile_0", (q8, qs, e8, es, mask), k, 2048)
        if not (bool((ki[:, 0, 3:] == -1).all()) and bool((kv[:, 0, 3:] == -1e30).all())):
            raise AssertionError("B1: tile 0's empty slots are not (-1e30, -1)")

    # B2 reads B1's [b, tiles, k] output; the last twentieth of the tiles
    # hold only fillers.  10M rows at per-tile k = 12 (58,596 candidates)
    # and k = 128 pass one block's shared memory, which the first version
    # needed for its pool; B2 streams any pool from device memory.  Batches
    # of 4229 and 2049 put 8 and 2 queries in a block with a partial last
    # block, smaller ones one query over 8 warps.
    rng = np.random.default_rng(4)
    for name, b, tiles, k, out_k, ties in (
            ("bench", 512, 489, TOP_K, RESCORE, False),
            ("ties", 64, 489, TOP_K, RESCORE, True),
            ("small_pool", 64, 100, TOP_K, RESCORE, False),
            ("8_queries_a_block_ragged", 4229, 489, TOP_K, RESCORE, True),
            ("2_queries_a_block_ragged", 2049, 489, TOP_K, 100, False),
            ("10M_k12", 256, 4883, 12, RESCORE, False),
            ("10M_k12_ties", 64, 4883, 12, RESCORE, True),
            ("k128", 8, 20_000, 128, 128, True)):
        v = (rng.standard_normal((b, tiles, k)) * 0.1).astype(np.float32)
        if ties:
            v = np.round(v * 8) / 8
        v[:, -tiles // 20:] = -1e30
        i = rng.integers(0, N_10M, size=(b, tiles, k)).astype(np.int32)
        i[:, -tiles // 20:] = -1
        b2(name, torch.from_numpy(v.astype(np.float32)).to(dev),
           torch.from_numpy(i).to(dev), out_k)

    # A pool below 4096 takes the stable sort, not B2.
    vals, idxs = tc.int8_tile_topk(*b1_inputs(64, 40_000, DIM, 5, dev), TOP_K)
    before = tc.packed_candidate_merge.launches
    tc.merge_tile_candidates(vals, idxs, RESCORE)
    if tc.packed_candidate_merge.launches != before:
        raise AssertionError("a 200-candidate pool was routed through B2")
    log("  merge routing: pool 200 < 4096 takes the stable sort")

    # B3e at B1's shapes, then under filters: 3 valid rows in tile 0 (its
    # other slots fill with (-1e30, 0)), and 3 valid rows in the bank.
    err["int8_exact_tile_topk"] = 0.0

    def b3e(name, args, k, tile):
        kv, ki = tc.int8_exact_tile_topk(*args, k, tile_n=tile)
        e = same_bits(kv, ki, *tc.int8_exact_tile_topk_plain(*args, k, tile_n=tile))
        err["int8_exact_tile_topk"] = max(err["int8_exact_tile_topk"], e)
        log(f"  B3e {name}: b={args[0].shape[0]} n={args[2].shape[0]} "
            f"d={args[0].shape[1]} k={k} tile={tile}: bit-equal")
        return kv, ki

    b3e("bench", b1_inputs(512, 40_000, DIM, 6, dev), TOP_K, 2048)
    b3e("k128_ragged_queries", b1_inputs(130, 4096, 128, 7, dev), 128, 2048)
    # On the int8 tensor cores with its 64-bit key: B1's edge shapes, the
    # widest rows, and k 11, 16 and 17 (10-key register lists in 128-query
    # blocks up to k = 10, 16-key ones in 64-query blocks to 16, shared
    # lists past that).
    for b, n, d, k, tile in INT8_TC_B1 + ((65, 3000, 1040, 10, 2048),
                                          (130, 2500, 1040, 128, 2048),
                                          (2048, 2100, DIM, 11, 2048),
                                          (130, 5000, DIM, 16, 1024),
                                          (130, 5000, DIM, 17, 2048)):
        b3e("tensor_core", b1_inputs(b, n, d, 12 + k + d, dev), k, tile)
    q8, qs, e8, es, mask = b1_inputs(64, 40_000, DIM, 8, dev)
    mask[:2048] = False
    mask[[5, 700, 2000]] = True
    kv, ki = b3e("filter_3_rows_in_tile_0", (q8, qs, e8, es, mask), TOP_K, 2048)
    if not (bool((kv[:, 0, 3:] == -1e30).all()) and bool((ki[:, 0, 3:] == 0).all())):
        raise AssertionError("B3e: tile 0's empty slots are not (-1e30, 0)")
    mask[:] = False
    mask[[5, 20_000, 39_999]] = True
    v, i = tc.merge_tile_candidates(*b3e("filter_3_rows_in_bank", (q8, qs, e8, es, mask),
                                         TOP_K, 2048), 0, packed=False)
    if not (bool((i[:, 3:] == 0).all()) and bool((v[:, 3:] == -1e30).all())):
        raise AssertionError("B3e: the merge of a 3-row bank does not fill with (-1e30, 0)")
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
    # B4's CUDA-core loop at its edge shapes (d of 64 and 1024, tiles of 64
    # and 192 rows, k 1 to 128), by the rule above and bit for bit on exact
    # dots, over both banks.
    for b, n, d, k, tile in ((1, 3000, 64, 1, 64), (129, 3000, 1024, 17, 512),
                             (130, 2500, 1024, 128, 2048), (63, 1000, 768, 1, 192),
                             (1024, 2100, DIM, TOP_K, 2048)):
        for dtype in (torch.float32, torch.bfloat16):
            b4("core_loop", float_inputs(b, n, d, 30 + k + d, dev, dtype), k, tile)
            exact(f"B4 exact_dots b={b} n={n} d={d} k={k} tile={tile} {str(dtype)[6:]}",
                  *run("float_tile_topk", dyadic_inputs(b, n, d, 31 + k + d, dev, dtype),
                       k, tile))
    b5("k128_ragged_queries", float_inputs(130, 4096, 128, 27, dev, torch.bfloat16), 128)

    # B5 over a bf16 bank runs on the tensor cores: bit for bit on exact
    # dots at per-tile k 1, 10, 100 and 128, d 128 and 384, ragged tiles
    # and query blocks, a tenth of the rows masked; by `testing.py`'s rule
    # on normal inputs at the same shapes.
    for k, d, b, n in ((1, DIM, 130, 9000), (TOP_K, 128, 70, 5000), (100, DIM, 200, 4500),
                       (128, 128, 64, 4096), (100, DIM, 129, 5000)):
        args = dyadic_inputs(b, n, d, 40 + k + d, dev, torch.bfloat16)
        exact(f"B5 exact_dots k={k} d={d} b={b} n={n}", *run("float_packed_tile_topk", args,
                                                            k, 2048))
        b5(f"normal k={k} d={d}", float_inputs(b, n, d, 41 + k + d, dev, torch.bfloat16), k)

    # How far the tensor-core loop's sums lie from the float64 dots
    # (`testing.TC_DOT_ERROR` is the band the card tests hold it to).
    from hcrag_tpu_torch.testing import TC_DOT_ERROR

    q, e, _ = float_inputs(512, 65_536, DIM, 42, dev, torch.bfloat16)
    dots = tc.bf16_tc_dots(q, e)
    f32 = (q.float() @ e.float().T).double()
    want = q.double() @ e.double().T
    tc_err, f32_err = (float((x.double() - want).abs().max()) for x in (dots, f32))
    log(f"  tensor-core dot loop (bf16_tc_dots) over 512 x 65,536 normalized rows, d={DIM}: "
        f"max |dot - float64 dot| {tc_err:.3g} (an f32 matrix product: {f32_err:.3g}; "
        f"band {TC_DOT_ERROR:g})")
    if tc_err > TC_DOT_ERROR:
        raise AssertionError(f"tensor-core dots {tc_err} off, past {TC_DOT_ERROR}")
    del dots, f32, want
    q, e, _ = dyadic_inputs(200, 5000, DIM, 43, dev, torch.bfloat16)
    if not torch.equal(tc.bf16_tc_dots(q, e), (q.double() @ e.double().T).float()):
        raise AssertionError("tensor-core dots are not exact on dyadic inputs")
    log("  tensor-core dot loop on exact dots: equal to the float64 dots")


def dyadic_inputs(b, n, d, seed, dev, dtype, mask_frac=0.1):
    """Float operands that are multiples of 1/64 (|x| <= 6/64): every dot is
    exact in f32 in any summation order, so B7f and its plain version see
    the same keys and must agree bit for bit."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.integers(-6, 7, (b, d)) / 64).to(dev, dtype)
    e = torch.from_numpy(rng.integers(-6, 7, (n, d)) / 64).to(dev, dtype)
    return q, e, torch.from_numpy(rng.random(n) >= mask_frac).to(dev)


def phase_super_kernels(dev, err: dict) -> None:
    """B7i and B7f against their plain versions, and the supertile merge's
    routing; updates the max abs errors in `err`."""
    from hcrag_tpu_torch.ops import topk_cuda as tc
    from hcrag_tpu_torch.testing import check_packed_topk

    err.update(int8_super_tile_topk=0.0, float_packed_super_tile_topk=0.0)

    def b7(kernel, name, args, k, lbits, exact=True):
        kv, ki = getattr(tc, kernel)(*args, k, lbits)
        pv, pi = getattr(tc, kernel + "_plain")(*args, k, lbits)
        if exact:
            e, how = same_bits(kv, ki, pv, pi), "bit-equal"
        else:
            torch.cuda.synchronize()
            e, moved = check_packed_topk(kv, ki, pv, pi, *args[:2], lane_bits=lbits)
            how = f"max |err| {e:.3g}, {moved} supertiles next to a key-quantum boundary"
        err[kernel] = max(err[kernel], e)
        int8 = "int8" in kernel
        bank = args[2] if int8 else args[1]
        log(f"  {'B7i' if int8 else 'B7f'} {name}: b={args[0].shape[0]} n={bank.shape[0]} "
            f"d={bank.shape[1]} {str(bank.dtype)[6:]} k_sub={k} lbits={lbits}: {how}")
        return kv, ki

    # b=512 over 40,000 rows (a ragged last supertile), a tenth masked, at
    # each supertile width; then k_sub 128 over ragged queries, and the
    # small-pool raise (one 8192-row supertile cannot give 32 at k_sub 16).
    k_raised = tc.super_pick_count(TOP_K, 5000, 8192, RESCORE)
    if k_raised != 32:
        raise AssertionError(f"supertile pick-count raise gave {k_raised}, want 32")
    for lbits in (2048, 4096, 8192):
        b7("int8_super_tile_topk", "bench", b1_inputs(512, 40_000, DIM, 30 + lbits, dev), 16,
           lbits)
    b7("int8_super_tile_topk", "k128_ragged_queries", b1_inputs(130, 20_000, DIM, 31, dev),
       128, 8192)
    b7("int8_super_tile_topk", "pick_raise", b1_inputs(100, 5000, DIM, 32, dev), k_raised,
       8192)
    # The int8 tensor-core loop at its edge shapes; a filter that leaves 3
    # rows in supertile 0 (both epilogues); all-tied rows.
    for b, n, d, k, lbits in INT8_TC_B7I:
        b7("int8_super_tile_topk", "tensor_core", b1_inputs(b, n, d, 50 + k + d, dev), k,
           lbits)
    for k in (16, 128):
        q8, qs, e8, es, mask = b1_inputs(130, 9000, DIM, 51 + k, dev)
        mask[:8192] = False
        mask[[5, 700, 2000]] = True
        kv, ki = b7("int8_super_tile_topk", "filter_3_rows_in_supertile_0",
                    (q8, qs, e8, es, mask), k, 8192)
        if not (bool((ki[:, 0, 3:] == -1).all()) and bool((kv[:, 0, 3:] == -1e30).all())):
            raise AssertionError("B7i: supertile 0's empty slots are not (-1e30, -1)")
    _, ki = b7("int8_super_tile_topk", "all_tied", b1_inputs(65, 9000, DIM, 52, dev, tied=True,
                                                            mask_frac=0.0), 16, 8192)
    want = torch.arange(2, device=dev)[:, None] * 8192 + torch.arange(16, device=dev)
    if not torch.equal(ki, want.expand(65, 2, 16).to(torch.int32)):
        raise AssertionError("B7i: all-tied rows did not give the lowest indices")
    for dtype in (torch.float32, torch.bfloat16):
        for lbits in (2048, 4096, 8192):
            b7("float_packed_super_tile_topk", "exact_dots",
               dyadic_inputs(512, 40_000, DIM, 33 + lbits, dev, dtype), 16, lbits)
        b7("float_packed_super_tile_topk", "exact_dots_k128_ragged_queries",
           dyadic_inputs(130, 20_000, DIM, 34, dev, dtype), 128, 8192)
        b7("float_packed_super_tile_topk", "exact_dots_pick_raise",
           dyadic_inputs(100, 5000, DIM, 35, dev, dtype), k_raised, 8192)
        for k, d, lbits in ((1, 128, 4096), (100, DIM, 2048), (TOP_K, 128, 8192)):
            b7("float_packed_super_tile_topk", f"exact_dots_k{k}_d{d}",
               dyadic_inputs(130, 20_000, d, 38 + k, dev, dtype), k, lbits)
        b7("float_packed_super_tile_topk", "normal", float_inputs(512, 40_000, DIM, 36, dev,
                                                                  dtype), 16, 8192, exact=False)

    # Supertile pools of 1024 or more go through B2, smaller ones through the
    # stable sort in slot-major order.
    q8, qs, e8, es, mask = b1_inputs(64, 40_000, DIM, 37, dev)
    for lbits in (2048, 8192):
        vals, idxs = tc.int8_super_tile_topk(q8, qs, e8, es, mask, 16, lbits)
        before = tc.packed_candidate_merge.launches
        tc.merge_super_candidates(vals, idxs, TOP_K, RESCORE)
        if tc.packed_candidate_merge.launches != before:
            raise AssertionError(f"a {vals.shape[1]} x 16 supertile pool went through B2")
    vals = torch.randn(64, 123, 16, device=dev)
    before = tc.packed_candidate_merge.launches
    tc.merge_super_candidates(vals, torch.zeros_like(vals, dtype=torch.int32), TOP_K,
                              RESCORE)
    if tc.packed_candidate_merge.launches != before + 1:
        raise AssertionError("a 1968-candidate supertile pool did not go through B2")
    log("  supertile merge routing: pools of 320 and 80 take the stable sort, 1968 takes B2")


def sweep_dyadic(b, n, seed, dev):
    """Operands of kernels B8a-c whose dots are exact in any order: f32
    queries and bf16 rows, multiples of 1/64 up to 12/64.  Query 0 is all
    12/64 and column 5 of every 128-column group holds its negation (a dot
    of -13.5, so B8c's keys there are negative)."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.integers(-12, 13, (b, DIM)) / 64).float()
    e = torch.from_numpy(rng.integers(-12, 13, (n, DIM)) / 64).float()
    q[0] = 12 / 64
    e[5::128] = -q[0]
    return q.to(dev), e.to(dev, torch.bfloat16)


def level1_err(got, want) -> float:
    """Max abs difference of B8c's keys decoded to their shifted scores."""
    def score(k):
        return (k & ~2047).view(torch.float32).double()
    return float((score(got) - score(want)).abs().max())


def check_sweep_kernel(name, q, e, tile_n, exact: bool) -> float:
    """B8a, B8b or B8c against its plain version: bit for bit (`exact`), or
    within 1e-5 (B8a, B8b) / by `testing.check_level1` (B8c).  Returns the
    max abs error (B8c: of the decoded scores)."""
    from hcrag_tpu_torch.ops import sweep_cuda as sw
    from hcrag_tpu_torch.testing import check_level1

    got = getattr(sw, name)(q, e, tile_n)
    want = getattr(sw, name + "_plain")(q, e, tile_n)
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {got.dtype} {tuple(got.shape)} against "
                             f"{want.dtype} {tuple(want.shape)}")
    if exact:
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"{name} tile_n={tile_n}: kernel and plain version differ")
        return 0.0
    if name == "encode_level1":
        check_level1(got, want, q.to(torch.bfloat16), e, tile_n)
        return level1_err(got, want)
    err = float((got - want).abs().max())
    if not err <= 1e-5:
        raise AssertionError(f"{name} tile_n={tile_n}: max |err| {err} > 1e-5")
    return err


def phase_sweep_kernels(dev, err: dict) -> None:
    """B8a-c against their plain versions: bit for bit on exact dots at
    tiles of 2048, 1024 and 128 rows, b=512 and a ragged 200; on normal
    inputs by their tolerances.  Updates the max abs errors in `err`."""
    err.update({name: 0.0 for name in SWEEP_KERNELS})
    for b, tile_n, tiles in ((512, 2048, 4), (200, 2048, 3), (512, 1024, 6), (200, 1024, 5),
                             (512, 128, 40), (200, 128, 17)):
        q, e = sweep_dyadic(b, tile_n * tiles, b + tile_n, dev)
        for name in SWEEP_KERNELS:
            check_sweep_kernel(name, q, e, tile_n, exact=True)
        log(f"  B8a-c exact_dots: b={b} n={tile_n * tiles} d={DIM} bf16 tile={tile_n}: "
            f"bit-equal")
    for tile_n in (2048, 128):
        q, e, _ = float_inputs(512, 8 * 2048, DIM, 40 + tile_n, dev, torch.float32)
        e = e.to(torch.bfloat16)
        errs = {name: check_sweep_kernel(name, q, e, tile_n, exact=False)
                for name in SWEEP_KERNELS}
        for name, x in errs.items():
            err[name] = max(err[name], x)
        log(f"  B8a-c normal: b=512 n={8 * 2048} d={DIM} bf16 tile={tile_n}: max |err| "
            + ", ".join(f"{name} {x:.3g}" for name, x in errs.items()))


def b6_inputs(b, n, seed, dev, w=8, d=DIM):
    """Operands of kernel B6: normalized f32 rows, random bit words (every
    other query and every 7th node without entities), intents, types, the
    weights, the priority table and an llm column."""
    from hcrag_tpu_torch.core.types import PRIORITY_MATRIX

    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    e = rng.standard_normal((n, d)).astype(np.float32)
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    qb = (rng.integers(0, 2**32, (b, w), dtype=np.uint32)
          & rng.integers(0, 2**32, (b, w), dtype=np.uint32))
    nb = (rng.integers(0, 2**32, (n, w), dtype=np.uint32)
          & rng.integers(0, 2**32, (n, w), dtype=np.uint32))
    qb[::2] = 0
    nb[::7] = 0
    qc = np.unpackbits(qb.view(np.uint8), axis=1).sum(axis=1).astype(np.int32)
    nc = np.unpackbits(nb.view(np.uint8), axis=1).sum(axis=1).astype(np.int32)
    arrays = (q, qb.view(np.int32), qc, rng.integers(0, 5, b).astype(np.int32), e,
              nb.view(np.int32), nc, rng.integers(0, 6, n).astype(np.int32),
              np.array([0.3, 0.45, 0.15, 0.1], np.float32), PRIORITY_MATRIX,
              rng.uniform(0, 1, (b, n)).astype(np.float32))
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]


# B6's kernel phase: (b, n, d, w, reduction, llm).  Up to 16 queries the
# byte-bound kernel (a) at query blocks of 1-16, float4 rows where d % 4 ==
# 0 and scalars at d = 383; past 16 the tiled CUDA-core loop (b), with
# ragged query and node blocks; d = 383, and W = 210 (past the loop's shared
# memory), send 40 queries to (a) at 16 a block.
B6_CASES = ((256, R_NODES, DIM, 8, 0, True), (256, R_NODES, DIM, 8, 1, True),
            (1, R_NODES, DIM, 8, 0, True), (1, R_NODES - 1, DIM, 8, 1, False),
            (3, R_NODES - 1, DIM, 8, 0, False), (1, 32768, DIM, 8, 0, True),
            (1, 2048, DIM, 1, 1, True), (8, 4097, DIM, 8, 0, True),
            (16, 3001, 1040, 8, 1, True), (2, 999, 383, 8, 0, True),
            (40, 999, 383, 8, 1, False), (17, 700, DIM, 1, 1, True),
            (300, 1001, DIM, 8, 0, True), (40, 500, DIM, 210, 0, True))


def phase_scoring_kernels(dev, err: dict, card: str) -> None:
    """B6 against its plain version (within 1e-5: the dot's f32 sum runs in
    another order) in both regimes; updates the max abs error in `err`.
    Then both regimes at the same shapes (the plan's choice and the other),
    device time from CUDA-graph replays: the data behind the route rule."""
    from hcrag_tpu_torch.ops import scoring_cuda as sc
    from hcrag_tpu_torch.utils.timing import graph_ms

    err["batch_relevance"] = 0.0
    for b, n, d, w, reduction, llm in B6_CASES:
        args = b6_inputs(b, n, b + n + reduction, dev, w=w, d=d)
        if not llm:
            args[-1] = None
        plan = sc.launch_plan(args[0], args[4], w)
        got = sc.batch_relevance(*args, reduction=reduction)
        want = sc.batch_relevance_plain(*args, reduction=reduction)
        torch.cuda.synchronize()
        e = float((got - want).abs().max())
        if got.shape != (b, n) or not e <= 1e-5:
            raise AssertionError(f"B6 b={b} n={n} d={d} w={w}: max |err| {e} > 1e-5")
        err["batch_relevance"] = max(err["batch_relevance"], e)
        log(f"  B6 b={b} n={n} d={d} w={w} reduction={reduction} llm={llm}: regime "
            f"{plan.regime} ({plan.queries} queries a block, float4 rows {plan.vec}): "
            f"max |err| {e:.3g}")
    kernel = sc._kernel()
    for b, n in ((17, R_NODES), (64, R_NODES), (128, R_NODES), (256, 2048), (256, R_NODES),
                 (256, 32768)):
        args = b6_inputs(b, n, 7, dev)
        out = torch.empty((b, n), dtype=torch.float32, device=dev)
        ptrs = [args[i].data_ptr() for i in (0, 1, 2, 3, 8, 9, 4, 5, 6, 7, 10)]
        ms = {}
        for qpb in (16, sc.TILED_QUERY_BLOCK):
            # The stream is read at each call: a graph captures on its own.
            call = (lambda qpb=qpb: kernel(*ptrs, out.data_ptr(), b, n, DIM, 8, 0, qpb,
                                            int(qpb == 16),
                                            torch.cuda.current_stream(dev).cuda_stream))
            if call():
                raise AssertionError(f"B6 b={b} n={n} at {qpb} queries a block: launch failed")
            ms[qpb] = graph_ms(call, calls=10, replays=5)
        log(f"  B6 regimes at b={b} n={n} d={DIM} (device time, CUDA graph): (a) at 16 "
            f"queries a block {ms[16]:.4f} ms, (b) tiled {ms[128]:.4f} ms; the plan "
            f"takes {sc.launch_plan(args[0], args[4], 8).regime}; {card}")


def brute_force_top_k(emb: np.ndarray, queries: np.ndarray, dev,
                      k: int = TOP_K) -> np.ndarray:
    """The f32 brute-force top-k of the first GATE_QUERIES queries over the
    host rows `emb`, with ties to the lowest index: row chunks of 250k go
    to the card, where the products run in full f32 (TF32 is off)."""
    q = torch.from_numpy(queries[:GATE_QUERIES]).to(dev)
    best_v = torch.full((q.shape[0], k), -float("inf"), device=dev)
    best_i = torch.zeros((q.shape[0], k), dtype=torch.int64, device=dev)
    chunk = 250_000
    for lo in range(0, emb.shape[0], chunk):
        s = q @ torch.from_numpy(emb[lo:lo + chunk]).to(dev).T
        cv, ci = torch.sort(s, dim=1, descending=True, stable=True)
        allv = torch.cat([best_v, cv[:, :k]], dim=1)
        alli = torch.cat([best_i, ci[:, :k] + lo], dim=1)
        order = torch.sort(allv, dim=1, descending=True, stable=True).indices[:, :k]
        best_v, best_i = allv.gather(1, order), alli.gather(1, order)
    return best_i.cpu().numpy()


def recall(ref: np.ndarray, got: np.ndarray) -> float:
    """recall@k of `got` (the first k columns of its first len(ref) rows)
    against `ref` [rows, k]."""
    k = ref.shape[1]
    hits = sum(len(set(got[b, :k].tolist()) & set(ref[b].tolist())) for b in range(len(ref)))
    return hits / (len(ref) * k)


def round_to_bf16(emb: np.ndarray) -> None:
    """Round the host rows to bfloat16 in place (kept as float32: numpy has
    no bfloat16 of its own), in row chunks."""
    t = torch.from_numpy(emb)
    for lo in range(0, emb.shape[0], 1 << 20):
        t[lo:lo + (1 << 20)] = t[lo:lo + (1 << 20)].to(torch.bfloat16).to(torch.float32)


def host_rss_gib() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


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


def profiled(step, steps: int):
    """torch.profiler over `steps` calls of step(): (device-side rows
    [(us, name, count)], device busy us, wall us)."""
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
    return rows, sum(r[0] for r in rows), wall_us


def profile_step(step, card: str, steps: int = 3) -> None:
    """Device time by kernel over a few steps (torch.profiler), and the
    device's busy share of that window's wall time."""
    rows, total, wall_us = profiled(step, steps)
    if not total:
        log("[profile] the profiler saw no device time: not measured")
        return
    log(f"[profile] {steps} steps: device busy {total / 1e3:.3f} ms of "
        f"{wall_us / 1e3:.3f} ms wall ({100 * total / wall_us:.1f}%); {card}")
    for dev_us, key, count in sorted(rows, reverse=True)[:10]:
        log(f"[profile]   {dev_us / steps / 1e3:9.3f} ms/step  "
            f"{100 * dev_us / total:5.1f}%  x{count // steps:<4d} {key[:96]}")


def check_result(res, batch: int, n_rows: int, top_k: int = TOP_K) -> None:
    """Finite outputs of the expected shapes, indices in range, scores
    descending."""
    shapes = {
        "top_scores": (batch, top_k), "top_indices": (batch, top_k),
        "relevance": (batch, top_k), "combined": (batch, top_k),
        "expanded_nodes": (batch, 20), "expanded_counts": (batch,),
        "expanded_relevance": (batch, 20),
    }
    for f, shape in shapes.items():
        a = getattr(res, f)
        if a.shape != shape or not np.isfinite(a).all():
            raise AssertionError(f"{f}: shape {a.shape} (want {shape}) or non-finite")
    if not ((res.top_indices >= 0) & (res.top_indices < n_rows)).all():
        raise AssertionError("top_indices out of range")
    if not ((res.expanded_counts >= 0) & (res.expanded_counts <= 20)).all():
        raise AssertionError("expanded_counts out of range")
    if not (np.diff(res.top_scores, axis=1) <= 0).all():
        raise AssertionError("top_scores not descending")


def _wrappers() -> dict:
    """Every kernel's wrapper, whose `.launches` counts its launches."""
    from hcrag_tpu_torch.ops import scoring_cuda as sc
    from hcrag_tpu_torch.ops import sweep_cuda as sw
    from hcrag_tpu_torch.ops import topk_cuda as tc

    modules = {"batch_relevance": sc, **{name: sw for name in SWEEP_KERNELS}}
    return {name: getattr(modules.get(name, tc), name) for name in KERNELS}


def zero_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in _wrappers().items()}


class Record:
    """What the run keeps for the summary line: each kernel's max error
    against its plain version, its timings per path, and every path's
    launch counts."""

    def __init__(self, max_err: dict):
        self.max_err = max_err
        self.rows = {name: {} for name in KERNELS}  # name -> path -> numbers
        self.launches = {}  # path -> name -> count

    def kernel(self, name, path, ms, plain_ms, bound, library_ms=None, dots_alone_ms=None):
        """A kernel's numbers at a path's shapes; at a shape no path runs
        (`path` not among the driven paths) its launches are None."""
        bound_ms_, by = bound
        self.rows[name][path] = dict(
            launches=self.launches[path][name] if path in self.launches else None,
            ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms_, bound_by=by, library_ms=library_ms)
        if dots_alone_ms is not None:  # a yardstick: the dots alone, not the same function
            self.rows[name][path]["dots_alone_ms"] = dots_alone_ms

    def err(self, name, e):
        self.max_err[name] = max(self.max_err[name], e)


def drive(engine, queries: np.ndarray, counted, label: str, ref: np.ndarray,
          rec: Record, n_rows: int = N_ROWS, min_recall: float = MIN_RECALL,
          top_k: int = TOP_K, depth: int = DEPTH, forbidden=()):
    """One `query_batch` with every launch counter at 0 just before it and
    read just after; every kernel in `counted` must have launched, none in
    `forbidden`.  Returns the result."""
    zero_counts()
    t0 = time.time()
    res = engine.query_batch(queries, top_k=top_k, expansion_depth=depth)
    first_s = time.time() - t0
    launches = read_counts()
    rec.launches[label] = launches
    log(f"[{label}] query_batch B={len(queries)} k={top_k} depth={depth}: first "
        f"call {first_s:.2f} s, launches {launches}")
    for name in counted:
        if launches[name] < 1:
            raise AssertionError(f"path {label} never launched {name}")
    for name in forbidden:
        if launches[name]:
            raise AssertionError(f"path {label} launched {name}")
    check_result(res, len(queries), n_rows, top_k)
    r = recall(ref, res.top_indices)
    log(f"[{label}] recall@{ref.shape[1]} vs f32 brute force ({len(ref)} queries): "
        f"{r:.4f} (gate {min_recall})")
    if r < min_recall:
        raise AssertionError(f"{label}: recall {r} below {min_recall}")
    return res


def time_step(engine, dq, label: str, card: str, reps: int, top_k: int = TOP_K,
              depth: int = DEPTH) -> float:
    step = lambda: engine.query_batch_device(dq, top_k=top_k, expansion_depth=depth)  # noqa: E731
    torch.cuda.reset_peak_memory_stats()
    step_ms = cuda_ms(step, reps=reps)
    log(f"[{label}] step {step_ms:.3f} ms, {len(dq) / step_ms * 1e3:.1f} QPS "
        f"(CUDA events, {reps} steps; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {card})")
    profile_step(step, card)
    return step_ms


def path_mask(n_bank: int, n_rows: int, dev) -> torch.Tensor:
    mask = torch.zeros(n_bank, dtype=torch.bool, device=dev)
    mask[:n_rows] = True
    return mask


SWEEP_KERNELS = ("matmul_only_acc", "matmul_only_wide", "encode_level1")  # B8a-c
KERNELS = ("int8_tile_topk", "packed_candidate_merge", "float_tile_topk",
           "float_packed_tile_topk", "int8_exact_tile_topk", "batch_relevance",
           "float_packed_super_tile_topk", "int8_super_tile_topk", *SWEEP_KERNELS)
SOURCES = {
    "int8_tile_topk": ("hcrag_tpu_torch/csrc/int8_tile_topk.cu",
                       "hcrag_tpu/ops/topk_pallas.py:535"),
    "packed_candidate_merge": ("hcrag_tpu_torch/csrc/packed_candidate_merge.cu",
                               "hcrag_tpu/ops/topk_pallas.py:808"),
    "float_tile_topk": ("hcrag_tpu_torch/csrc/float_tile_topk.cu",
                        "hcrag_tpu/ops/topk_pallas.py:36"),
    "float_packed_tile_topk": ("hcrag_tpu_torch/csrc/float_tile_topk.cu",
                               "hcrag_tpu/ops/topk_pallas.py:441"),
    "int8_exact_tile_topk": ("hcrag_tpu_torch/csrc/int8_tile_topk.cu",
                             "hcrag_tpu/ops/topk_pallas.py:633"),
    "batch_relevance": ("hcrag_tpu_torch/csrc/batch_relevance.cu",
                        "hcrag_tpu/ops/scoring_pallas.py:38"),
    "float_packed_super_tile_topk": ("hcrag_tpu_torch/csrc/float_tile_topk.cu",
                                     "hcrag_tpu/ops/topk_pallas.py:319"),
    "int8_super_tile_topk": ("hcrag_tpu_torch/csrc/int8_tile_topk.cu",
                             "hcrag_tpu/ops/topk_pallas.py:345"),
    "matmul_only_acc": ("hcrag_tpu_torch/csrc/kernel_sweep.cu",
                        "benchmarks/kernel_sweep.py:65"),
    "matmul_only_wide": ("hcrag_tpu_torch/csrc/kernel_sweep.cu",
                         "benchmarks/kernel_sweep.py:101"),
    "encode_level1": ("hcrag_tpu_torch/csrc/kernel_sweep.cu",
                      "benchmarks/kernel_sweep.py:129"),
}


def engine_ready(label: str, index, graph, dev, batch: int, top_k: int = TOP_K, **opts):
    from hcrag_tpu_torch.query.engine import QueryEngine

    t0 = time.time()
    engine = QueryEngine(index, graph, device=dev, ell_max_degree=8, **opts)
    torch.cuda.synchronize()
    log(f"[{label}] engine ready in {time.time() - t0:.1f} s (host set-up); "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card; resolved: "
        f"{json.dumps(engine.resolved_kernel_config(batch, top_k))}")
    return engine


def merge_at_path(vals, idxs, out_k, label, card, rec) -> None:
    """B2 over the path's candidate pool [b, tiles, k] against its plain
    version (bit for bit), then its time beside the plain version's, its
    bound and one `torch.topk` over the flat pool (no tie order)."""
    from hcrag_tpu_torch.ops import topk_cuda as tc

    rec.err("packed_candidate_merge",
            same_bits(*tc.packed_candidate_merge(vals, idxs, out_k),
                      *tc.packed_candidate_merge_plain(vals, idxs, out_k)))
    b, tiles, k = vals.shape
    ms = cuda_ms(lambda: tc.packed_candidate_merge(vals, idxs, out_k), reps=20)
    plain_ms = cuda_ms(lambda: tc.packed_candidate_merge_plain(vals, idxs, out_k), reps=3)
    flat = vals.view(b, tiles * k)
    lib_ms = cuda_ms(lambda: torch.topk(flat, out_k, dim=1), reps=20)
    # B2 reads every value once, gathers out_k indices per query (one
    # 32-byte sector each) and writes (value, index) pairs.
    bound = bound_ms(0.0, "int8", 4 * vals.numel() + 32 * b * out_k + 8 * b * out_k)
    log(f"[{label}] B2 packed_candidate_merge B={b} pool={tiles} x {k} out_k={out_k}: "
        f"bit-equal to its plain version; {ms:.4f} ms (plain {plain_ms:.3f} ms, torch.topk "
        f"{lib_ms:.4f} ms, bound {bound[0]:.4f} ms by bytes; {card})")
    rec.kernel("packed_candidate_merge", label, ms, plain_ms, bound, lib_ms)


def int8_kernels_at_path(engine, dq, label, card, rec, merge_out_k, b1_reps=3):
    """B1 and B2 at the path's shapes against their plain versions (bit for
    bit), then their times beside their plain versions' and bounds."""
    from hcrag_tpu_torch.ops import topk_cuda as tc
    from hcrag_tpu_torch.ops.quantize import quantize_queries

    bank = engine._bank()
    e8, es = bank["emb_int8"], bank["emb_scale"]
    n_bank, b = e8.shape[0], dq.shape[0]
    mask = path_mask(n_bank, engine._n_rows, dq.device)
    q8, qs = quantize_queries(dq)
    k = tc.tile_pick_count(TOP_K, n_bank, 2048, merge_out_k)
    vals, idxs = tc.int8_tile_topk(q8, qs, e8, es, mask, k)
    rec.err("int8_tile_topk",
            same_bits(vals, idxs, *tc.int8_tile_topk_plain(q8, qs, e8, es, mask, k)))
    tiles = vals.shape[1]
    log(f"[{label}] B1 at the path's shapes: bit-equal to its plain version")
    b1_ms = cuda_ms(lambda: tc.int8_tile_topk(q8, qs, e8, es, mask, k), reps=b1_reps)
    b1_plain_ms = cuda_ms(lambda: tc.int8_tile_topk_plain(q8, qs, e8, es, mask, k), reps=1,
                          warmup=0)  # the bit check above warmed it
    b1_bytes = (q8.numel() + 4 * qs.numel() + e8.numel() + 4 * es.numel()
                + mask.numel() + 8 * vals.numel())
    b1_bound = bound_ms(2.0 * b * n_bank * DIM, "int8", b1_bytes)
    log(f"[{label}] B1 int8_tile_topk B={b} N={n_bank} tiles={tiles} k={k}: "
        f"{b1_ms:.3f} ms (plain {b1_plain_ms:.3f} ms, bound {b1_bound[0]:.3f} ms "
        f"by {b1_bound[1]}; {card})")
    rec.kernel("int8_tile_topk", label, b1_ms, b1_plain_ms, b1_bound)
    merge_at_path(vals, idxs, min(max(k, merge_out_k), tiles * k), label, card, rec)


def path_int8(index, graph, queries, ref, dev, card, rec) -> None:
    """The int8 path: int8 select + f32 rescore, B=8192 (B1, B2)."""
    opts = dict(quantize_int8=True, int8_rescore=RESCORE, int8_f32_rescore=True,
                select_lane_t=1)
    engine = engine_ready("int8", index, graph, dev, BATCH, **opts)
    drive(engine, queries, ("int8_tile_topk", "packed_candidate_merge"), "int8", ref, rec)
    check_small_against_cpu(dev, "int8", dict(ell_max_degree=8, **opts), tf32=True)
    dq = torch.from_numpy(queries).to(dev)
    time_step(engine, dq, "int8", card, reps=5)
    int8_kernels_at_path(engine, dq, "int8", card, rec, RESCORE)


def path_f2(index, graph, queries, ref, dev, card, rec) -> None:
    """bench.py's bf16 mode: B5 over a bf16 bank, B2, the f32 rescore,
    B=8192."""
    from hcrag_tpu_torch.ops import topk_cuda as tc
    from hcrag_tpu_torch.testing import check_packed_topk

    opts = dict(exact_rescore=RESCORE, select_lane_t=1)
    engine = engine_ready("F2", index, graph, dev, BATCH, **opts)
    drive(engine, queries, ("float_packed_tile_topk", "packed_candidate_merge"), "F2",
          ref, rec)
    check_small_against_cpu(dev, "F2", dict(ell_max_degree=8, **opts))
    dq = torch.from_numpy(queries).to(dev)
    time_step(engine, dq, "F2", card, reps=3)

    e = engine.d_emb
    n_bank = e.shape[0]
    mask = path_mask(n_bank, N_ROWS, dev)
    qb = dq.to(torch.bfloat16)
    k = tc.tile_pick_count(TOP_K, n_bank, 2048, RESCORE)
    kv, ki = tc.float_packed_tile_topk(qb, e, mask, k)
    pv, pi = tc.float_packed_tile_topk_plain(qb, e, mask, k)
    err, moved = check_packed_topk(kv, ki, pv, pi, qb, e)
    rec.err("float_packed_tile_topk", err)
    log(f"[F2] B5 at the path's shapes: agrees with its plain version "
        f"(max |err| {err:.3g}, {moved} of {kv.shape[0] * kv.shape[1]} tiles next to "
        f"a key-quantum boundary)")
    del pv, pi
    b5_ms = cuda_ms(lambda: tc.float_packed_tile_topk(qb, e, mask, k), reps=2)
    b5_plain_ms = cuda_ms(lambda: tc.float_packed_tile_topk_plain(qb, e, mask, k),
                          reps=1, warmup=0)
    tiles = -(-n_bank // 2048)
    b5_bytes = 2 * qb.numel() + 2 * e.numel() + mask.numel() + 8 * BATCH * tiles * k
    b5_bound = bound_ms(2.0 * BATCH * n_bank * DIM, "bf16", b5_bytes)
    log(f"[F2] B5 float_packed_tile_topk B={BATCH} N={n_bank} tiles={tiles} bf16: "
        f"{b5_ms:.3f} ms (plain {b5_plain_ms:.3f} ms, bound {b5_bound[0]:.3f} ms by "
        f"{b5_bound[1]}; {card})")
    rec.kernel("float_packed_tile_topk", "F2", b5_ms, b5_plain_ms, b5_bound)
    merge_at_path(kv, ki, RESCORE, "F2", card, rec)


SUPER_PATHS = {  # label -> (engine options, B7 kernel, supertile factor run)
    "S1": (dict(exact_rescore=RESCORE, pallas_super=SUPER_FLOAT),
           "float_packed_super_tile_topk", SUPER_FLOAT),
    "S2": (dict(quantize_int8=True, int8_rescore=RESCORE, int8_f32_rescore=True,
                pallas_super=SUPER_INT8), "int8_super_tile_topk", SUPER_INT8),
    "S3": (dict(quantize_int8=True, int8_residual=True, int8_rescore=RESCORE,
                pallas_super=SUPER_INT8), "int8_super_tile_topk", SUPER_INT8),
}


def path_super(label, index, graph, queries, ref, dev, card, rec, n_rows=N_ROWS,
               step_reps=3) -> None:
    """A supertile path: the step launches its B7 kernel and B2 (never B1
    or B5); then B7 at the path's shapes against its plain version (B7i bit
    for bit, B7f by `testing.py`'s rule for an 8192-row lane field), and
    B2 over the supertile pool."""
    from hcrag_tpu_torch.ops import topk_cuda as tc
    from hcrag_tpu_torch.ops.quantize import quantize_queries
    from hcrag_tpu_torch.testing import check_packed_topk

    opts, kernel, spt = SUPER_PATHS[label]
    opts = dict(opts, select_lane_t=1)
    b = len(queries)
    engine = engine_ready(label, index, graph, dev, b, **opts)
    cfg = engine.resolved_kernel_config(b, TOP_K)
    lbits, k_sub = cfg["tile_n"] * cfg["super_tiles"], cfg["tile_k"]
    if not cfg["kernel"].startswith(kernel) or (cfg["super_tiles"], lbits, k_sub) != (
            spt, 8192, 16):
        raise AssertionError(f"{label} resolved {cfg}")
    drive(engine, queries, (kernel, "packed_candidate_merge"), label, ref, rec,
          n_rows=n_rows, forbidden=("int8_tile_topk", "float_packed_tile_topk"))
    check_small_against_cpu(dev, label, dict(ell_max_degree=8, **opts))
    dq = torch.from_numpy(queries).to(dev)
    time_step(engine, dq, label, card, reps=step_reps)

    bank = engine._bank()
    int8 = engine.quantize_int8
    e = bank["emb_int8"] if int8 else bank["emb"]
    n_bank = e.shape[0]
    mask = path_mask(n_bank, n_rows, dev)
    args = (*quantize_queries(dq), e, bank["emb_scale"], mask) if int8 else (
        dq.to(e.dtype), e, mask)
    fn, plain = getattr(tc, kernel), getattr(tc, kernel + "_plain")
    vals, idxs = fn(*args, k_sub, lbits)
    pv, pi = plain(*args, k_sub, lbits)
    if int8:
        err, how = same_bits(vals, idxs, pv, pi), "bit-equal to its plain version"
    else:
        torch.cuda.synchronize()
        err, moved = check_packed_topk(vals, idxs, pv, pi, *args[:2], lane_bits=lbits)
        how = (f"agrees with its plain version (max |err| {err:.3g}, {moved} of "
               f"{vals.shape[0] * vals.shape[1]} supertiles next to a key-quantum boundary)")
    rec.err(kernel, err)
    del pv, pi
    num_super = vals.shape[1]
    ms = cuda_ms(lambda: fn(*args, k_sub, lbits), reps=2)
    plain_ms = cuda_ms(lambda: plain(*args, k_sub, lbits), reps=1, warmup=0)
    nbytes = sum(a.numel() * a.element_size() for a in args) + 8 * b * num_super * k_sub
    if e.dtype not in (torch.int8, torch.bfloat16):
        raise AssertionError(f"{label}: a {e.dtype} selection bank")
    bound = bound_ms(2.0 * b * n_bank * DIM, "int8" if int8 else "bf16", nbytes)
    log(f"[{label}] B7 {kernel} B={b} N={n_bank} supertiles={num_super} x {lbits} rows "
        f"k_sub={k_sub}: {how}; {ms:.3f} ms (plain {plain_ms:.3f} ms, bound "
        f"{bound[0]:.3f} ms by {bound[1]}; {card})")
    rec.kernel(kernel, label, ms, plain_ms, bound)
    merge_at_path(vals, idxs, min(RESCORE, num_super * k_sub), label, card, rec)


def path_x(index, queries, dev, card, rec) -> None:
    """The expansion-heavy deployment: top_k=100, depth 3, B=256 over the
    1M rows with a degree-8 graph, `exact_rescore=32` (B5 at per-tile k =
    100, B2 over 489 x 100 -> 100); then the breakdown that the JAX repo's
    `benchmarks/expansion_heavy.py` records, each part held against the CPU
    on a few rows, and B5 and B2 at the path's shapes."""
    from hcrag_tpu_torch.ops import expand as ex
    from hcrag_tpu_torch.ops import topk_cuda as tc
    from hcrag_tpu_torch.query.engine import QueryEngine
    from hcrag_tpu_torch.testing import check_packed_topk
    from hcrag_tpu_torch.utils.synthetic import synthetic_graph

    t0 = time.time()
    graph = synthetic_graph(N_ROWS, X_DEGREE)
    log(f"[X] degree-{X_DEGREE} graph over {N_ROWS} nodes built in {time.time() - t0:.1f} s "
        f"(host)")
    xq = np.ascontiguousarray(queries[:X_BATCH])
    ref10 = brute_force_top_k(index.emb, xq, dev)
    ref100 = brute_force_top_k(index.emb, xq, dev, k=X_TOP_K)
    opts = dict(exact_rescore=RESCORE, select_lane_t=1)
    engine = engine_ready("X", index, graph, dev, X_BATCH, top_k=X_TOP_K, **opts)
    res = drive(engine, xq, ("float_packed_tile_topk", "packed_candidate_merge"), "X", ref10,
                rec, top_k=X_TOP_K, depth=X_DEPTH)
    log(f"[X] recall@{X_TOP_K} vs f32 brute force ({GATE_QUERIES} queries): "
        f"{recall(ref100, res.top_indices):.4f} (not gated)")
    dq = torch.from_numpy(xq).to(dev)
    step_ms = time_step(engine, dq, "X", card, reps=5, top_k=X_TOP_K, depth=X_DEPTH)

    # The breakdown: retrieval only, expansion only over random seeds, the
    # dedup alone over random candidates shaped like depth 3's.
    rng = np.random.default_rng(13)
    seeds = torch.from_numpy(rng.integers(0, N_ROWS, (X_BATCH, X_TOP_K)).astype(np.int32))
    c = X_TOP_K * (X_DEGREE + X_DEGREE**2 + X_DEGREE**3)
    cand = torch.from_numpy(rng.integers(-1, N_ROWS, (X_BATCH, c)).astype(np.int32))
    nb, nb2 = engine.d_neighbors, engine.d_neighbors_hop2
    seeds_d, cand_d = seeds.to(dev), cand.to(dev)
    parts = {
        "retrieval": lambda: engine.retrieve_batch_device(dq, top_k=X_TOP_K),
        "expand_batch": lambda: ex.expand_batch(nb, seeds_d, depth=X_DEPTH, max_nodes=20,
                                                hop2_neighbors=nb2),
        "dedup": lambda: ex._ordered_unique_mask(cand_d, N_ROWS),
        "step_depth1": lambda: engine.query_batch_device(dq, top_k=X_TOP_K,
                                                         expansion_depth=1),
    }
    part_ms = {name: cuda_ms(fn, reps=5) for name, fn in parts.items()}
    log(f"[X] breakdown, ms per batch of {X_BATCH} (CUDA events, 5 reps; {card}): full step "
        f"(depth {X_DEPTH}) {step_ms:.3f}; retrieval only (k={X_TOP_K}) "
        f"{part_ms['retrieval']:.3f}; expand_batch depth {X_DEPTH} over random seeds "
        f"[{X_BATCH}, {X_TOP_K}] {part_ms['expand_batch']:.3f}; dedup alone at C={c} "
        f"{part_ms['dedup']:.3f}; full step at depth 1 {part_ms['step_depth1']:.3f}")

    rows = 4
    cpu = QueryEngine(index, graph, device="cpu", ell_max_degree=8, **opts)
    gv, gi = (t[:rows].cpu() for t in parts["retrieval"]())
    cv, ci = cpu.retrieve_batch_device(torch.from_numpy(xq[:rows]), top_k=X_TOP_K)
    if not torch.equal(gi, ci) or float((gv - cv).abs().max()) > 1e-5:
        raise AssertionError("X: retrieval on the card differs from the CPU's")
    g_out = [t[:rows].cpu() for t in parts["expand_batch"]()]
    c_out = ex.expand_batch(cpu.d_neighbors, seeds[:rows], depth=X_DEPTH, max_nodes=20,
                            hop2_neighbors=cpu.d_neighbors_hop2)
    if not all(torch.equal(g, w) for g, w in zip(g_out, c_out)):
        raise AssertionError("X: expand_batch on the card differs from the CPU's")
    if not torch.equal(parts["dedup"]()[:rows].cpu(),
                       ex._ordered_unique_mask(cand[:rows], N_ROWS)):
        raise AssertionError("X: the dedup on the card differs from the CPU's")
    log(f"[X] retrieval, expand_batch and the dedup on the card equal the CPU's on {rows} rows")
    del cpu

    e = engine.d_emb
    n_bank = e.shape[0]
    mask = path_mask(n_bank, N_ROWS, dev)
    qb = dq.to(torch.bfloat16)
    k = tc.tile_pick_count(X_TOP_K, n_bank, 2048, 0)
    kv, ki = tc.float_packed_tile_topk(qb, e, mask, k)
    pv, pi = tc.float_packed_tile_topk_plain(qb, e, mask, k)
    err, moved = check_packed_topk(kv, ki, pv, pi, qb, e)
    rec.err("float_packed_tile_topk", err)
    del pv, pi
    ms = cuda_ms(lambda: tc.float_packed_tile_topk(qb, e, mask, k), reps=3)
    plain_ms = cuda_ms(lambda: tc.float_packed_tile_topk_plain(qb, e, mask, k), reps=1)
    tiles = kv.shape[1]
    bound = bound_ms(2.0 * X_BATCH * n_bank * DIM, "bf16",
                     2 * qb.numel() + 2 * e.numel() + mask.numel() + 8 * kv.numel())
    log(f"[X] B5 float_packed_tile_topk B={X_BATCH} N={n_bank} tiles={tiles} k={k}: agrees "
        f"with its plain version (max |err| {err:.3g}, {moved} tiles next to a key-quantum "
        f"boundary); {ms:.3f} ms (plain {plain_ms:.3f} ms, bound {bound[0]:.3f} ms by "
        f"{bound[1]}; {card})")
    rec.kernel("float_packed_tile_topk", "X", ms, plain_ms, bound)
    merge_at_path(kv, ki, X_TOP_K, "X", card, rec)


SELECTION_KERNELS = ("int8_tile_topk", "int8_exact_tile_topk", "int8_super_tile_topk",
                     "float_tile_topk", "float_packed_tile_topk",
                     "float_packed_super_tile_topk", "packed_candidate_merge")
LARGE_K_PATHS = {  # label -> (engine options, recall@256 gate)
    "L1": (dict(), MIN_RECALL),
    # int8 scores pick the 256 that the f32 rescore orders: quantization
    # noise moves rows across the 256th place.
    "L2": (dict(quantize_int8=True, int8_rescore=RESCORE, int8_f32_rescore=True),
           LARGE_K_MIN_RECALL_INT8),
}


def path_large_k(index, graph, queries, dev, card, rec) -> None:
    """top_k = 256, more than a per-tile list holds, through the JAX
    engine's route off the TPU (`ops/similarity.py`): the default f32
    engine (L1) and the int8 + f32 rescore engine (L2), B=64 over the 1M
    rows, streamed in 2^17-row chunks.  No selection kernel may launch;
    recall@256 against f32 brute force, the card against the CPU on 4
    rows, and the step's time."""
    from hcrag_tpu_torch.query.engine import QueryEngine

    lq = np.ascontiguousarray(queries[:LARGE_K_BATCH])
    ref = brute_force_top_k(index.emb, lq, dev, k=LARGE_K)
    for label, (opts, gate) in LARGE_K_PATHS.items():
        engine = engine_ready(label, index, graph, dev, LARGE_K_BATCH, top_k=LARGE_K, **opts)
        drive(engine, lq, (), label, ref, rec, top_k=LARGE_K, min_recall=gate,
              forbidden=SELECTION_KERNELS)
        rows = 4
        cpu = QueryEngine(index, graph, device="cpu", ell_max_degree=8, **opts)
        rc = cpu.query_batch(lq[:rows], top_k=LARGE_K)
        rg = engine.query_batch(lq[:rows], top_k=LARGE_K)
        if not np.array_equal(rg.top_indices, rc.top_indices) or \
                np.abs(rg.top_scores - rc.top_scores).max() > 1e-5:
            raise AssertionError(f"{label}: the card's top-{LARGE_K} differs from the CPU's")
        log(f"[{label}] top-{LARGE_K} on the card equals the CPU's on {rows} rows "
            f"(indices; scores within 1e-5)")
        del cpu
        time_step(engine, torch.from_numpy(lq).to(dev), label, card, reps=5, top_k=LARGE_K)
        del engine
        free(label)


def path_f1(index, graph, ref, dev, card, rec) -> None:
    """The default engine: B4 over the f32 bank, B=1024, and the host API
    over it."""
    from hcrag_tpu_torch.ops import topk_cuda as tc
    from hcrag_tpu_torch.query.engine import QueryEngine
    from hcrag_tpu_torch.testing import check_exact_topk

    t0 = time.time()
    engine = QueryEngine(index, graph, ell_max_degree=8)  # the default: cuda, f32
    torch.cuda.synchronize()
    log(f"[F1] engine ready in {time.time() - t0:.1f} s (host set-up); resolved: "
        f"{json.dumps(engine.resolved_kernel_config(F1_BATCH, TOP_K))}")
    rng = np.random.default_rng(8)
    queries = rng.standard_normal((F1_BATCH, DIM)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    drive(engine, queries, ("float_tile_topk",), "F1", ref, rec)

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
    mask = path_mask(n_bank, N_ROWS, dev)
    kv, ki = tc.float_tile_topk(dq, e, mask, TOP_K)
    pv, pi = tc.float_tile_topk_plain(dq, e, mask, TOP_K)
    err, moved = check_exact_topk(kv, ki, pv, pi, dq, e, mask)
    rec.err("float_tile_topk", err)
    log(f"[F1] B4 at the path's shapes: agrees with its plain version "
        f"(max |err| {err:.3g}, {moved} indices at near-ties)")
    b4_ms = cuda_ms(lambda: tc.float_tile_topk(dq, e, mask, TOP_K), reps=3)
    b4_plain_ms = cuda_ms(lambda: tc.float_tile_topk_plain(dq, e, mask, TOP_K), reps=1)
    # The yardstick: the same f32 dots alone, one [B, N] product in full f32
    # (TF32 is off), not the same function.
    dots_ms = cuda_ms(lambda: torch.matmul(dq, e.T), reps=3)
    tiles = -(-n_bank // 2048)
    b4_bytes = 4 * dq.numel() + 4 * e.numel() + mask.numel() + 8 * F1_BATCH * tiles * TOP_K
    b4_bound = bound_ms(2.0 * F1_BATCH * n_bank * DIM, "f32", b4_bytes)
    log(f"[F1] B4 float_tile_topk B={F1_BATCH} N={n_bank} tiles={tiles} f32: "
        f"{b4_ms:.3f} ms (plain {b4_plain_ms:.3f} ms, bound {b4_bound[0]:.3f} ms by "
        f"{b4_bound[1]}; dots alone, not the same function: torch.matmul in f32 "
        f"{dots_ms:.3f} ms; launches on the path {rec.launches['F1']['float_tile_topk']}; "
        f"{card})")
    rec.kernel("float_tile_topk", "F1", b4_ms, b4_plain_ms, b4_bound, dots_alone_ms=dots_ms)
    return engine


def vocab_texts(words, n: int, seed: int, lo: int = 2, hi: int = 150):
    """`n` texts of lo..hi words drawn from the committed vocabulary."""
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(words, size=k)) for k in rng.integers(lo, hi, n)]


def path_m(engine, index, graph, dev, card, rec) -> None:
    """The MiniLM query encoder on the card over F1's engine: the distilled
    weights loaded and attached; 1024 texts encoded at max_len 64 and 192
    (the forward timed with CUDA events, tokenization on the host clock),
    the card against the CPU on 8 texts; their embeddings through
    `query_batch` (one B4 launch); `process_query` on text; then the
    encoder confidence (`with_confidence`'s auto rule) over a 100,000-row
    slice of the index."""
    from hcrag_tpu_torch.core.dense_index import DenseIndex
    from hcrag_tpu_torch.models.minilm import load_distilled_embedder
    from hcrag_tpu_torch.query.engine import QueryEngine

    t0 = time.time()
    enc = load_distilled_embedder()
    if enc is None or enc.device.type != "cuda":
        raise AssertionError("M: the distilled encoder did not load onto the card")
    engine.attach_device_encoder(enc)
    log(f"[M] distilled MiniLM (vocab {enc.cfg.vocab_size}, {enc.cfg.num_layers} layers, "
        f"hidden {enc.dim}) on the card in {time.time() - t0:.1f} s (host set-up)")
    words = [w for w in enc.tokenizer.vocab if w.isalpha()]
    texts = vocab_texts(words, M_TEXTS, seed=21)
    cpu = load_distilled_embedder(device="cpu")
    embs = {}
    for max_len in (64, 192):
        t0 = time.perf_counter()
        ids, mask = enc.tokenizer.encode_batch(texts, max_len=max_len)
        tok_s = time.perf_counter() - t0
        d_ids = torch.from_numpy(ids).to(dev, torch.int64)
        d_mask = torch.from_numpy(mask).to(dev)
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            fwd_ms = cuda_ms(lambda: enc.model(d_ids, d_mask), reps=3)
        peak = torch.cuda.max_memory_allocated() / 2**30
        t0 = time.perf_counter()
        embs[max_len] = enc.encode(texts, max_len=max_len)
        encode_s = time.perf_counter() - t0
        e = embs[max_len]
        if e.shape != (M_TEXTS, DIM) or not np.isfinite(e).all() or \
                np.abs(np.linalg.norm(e, axis=1) - 1).max() > 1e-5:
            raise AssertionError(f"M: bad embeddings at max_len {max_len}")
        diff = float(np.abs(enc.encode(texts[:8], max_len=max_len)
                            - cpu.encode(texts[:8], max_len=max_len)).max())
        if not diff <= 1e-4:
            raise AssertionError(f"M: card and CPU encoders differ by {diff} > 1e-4")
        log(f"[M] encode {M_TEXTS} texts at max_len {max_len} ({int(mask.sum())} tokens): "
            f"forward {fwd_ms:.3f} ms per batch (CUDA events), "
            f"{M_TEXTS / fwd_ms * 1e3:.0f} texts/s; tokenization {tok_s * 1e3:.1f} ms "
            f"(host); encode() {encode_s * 1e3:.1f} ms (host clock); peak device memory "
            f"{peak:.2f} GiB; card vs CPU on 8 texts max |diff| {diff:.3g} (gate 1e-4); "
            f"{card}")
    zero_counts()
    t0 = time.perf_counter()
    res = engine.query_batch(embs[64], top_k=TOP_K)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    rec.launches["M"] = read_counts()
    if rec.launches["M"]["float_tile_topk"] != 1:
        raise AssertionError(f"M: query_batch launched B4 {rec.launches['M']['float_tile_topk']}"
                             " times, not once")
    check_result(res, M_TEXTS, N_ROWS)
    log(f"[M] query_batch of the {M_TEXTS} embeddings (max_len 64): {step_s * 1e3:.1f} ms "
        f"(host clock), launches {rec.launches['M']}")
    for text in ("red mountain bike frame", texts[5]):
        t0 = time.perf_counter()
        out = engine.process_query(text, top_k=TOP_K)
        dt = time.perf_counter() - t0
        if "encoder_confidence" in out or out["query_embedding"].shape != (DIM,):
            raise AssertionError("M: process_query over 1M rows gave a confidence or a bad "
                                 "embedding")
        log(f"[M] process_query({text[:40]!r}): {dt * 1e3:.1f} ms (host clock); "
            f"{out['summary']}")
    # The auto rule's limit: confidence over at most 100,000 rows.
    rows = slice(0, M_CONF_ROWS)
    part = DenseIndex(emb=index.emb[rows], type_ids=index.type_ids[rows],
                      entity_bits=index.entity_bits[rows],
                      entity_counts=index.entity_counts[rows],
                      graph_ids=index.graph_ids[rows], metadata=index.metadata[rows],
                      texts=index.texts[rows], vocab=index.vocab)
    # No graph: its nodes link rows past the slice.
    small = QueryEngine(part, None, embedder=enc)
    for text in ("red mountain bike frame", texts[5]):
        t0 = time.perf_counter()
        out = small.process_query(text, top_k=TOP_K)
        dt = time.perf_counter() - t0
        conf = out.get("encoder_confidence")
        if conf is None or not all(np.isfinite(v) for v in conf.values()) or \
                not 0.0 <= conf["score"] <= 1.0:
            raise AssertionError(f"M: encoder confidence over {M_CONF_ROWS} rows: {conf}")
        log(f"[M] process_query({text[:40]!r}) over {M_CONF_ROWS} rows with the encoder "
            f"confidence (auto rule): {dt * 1e3:.1f} ms (host clock); confidence "
            f"{json.dumps({k: round(v, 6) for k, v in conf.items()})}")


def path_refresh(index, graph, dev, card, rec) -> None:
    """`refresh_index` at scale: the int8 + f32 rescore engine over the 1M
    rows, 10,000 rows appended to the index, the engine refreshed (the
    int8 banks quantized again on the card); a query equal to an appended
    row must return that row first."""
    from hcrag_tpu_torch.query.engine import QueryEngine

    opts = dict(quantize_int8=True, int8_rescore=RESCORE, int8_f32_rescore=True)
    engine = QueryEngine(index, graph, device=dev, ell_max_degree=8, **opts)
    n0, bank0 = engine._n_rows, engine._n_bank
    rng = np.random.default_rng(31)
    new = rng.standard_normal((REFRESH_ROWS, DIM)).astype(np.float32)
    meta = [{"id": f"new_{i}", "type": "database_table", "table_name": "Synthetic",
             "row_index": n0 + i} for i in range(REFRESH_ROWS)]
    t0 = time.perf_counter()
    index.append(new, meta, [f"appended row {i}" for i in range(REFRESH_ROWS)])
    append_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine.refresh_index()
    torch.cuda.synchronize()
    refresh_s = time.perf_counter() - t0
    picks = np.array([0, 1, REFRESH_ROWS // 2, REFRESH_ROWS - 1])
    q = np.concatenate([new[picks], rng.standard_normal((60, DIM))]).astype(np.float32)
    zero_counts()
    res = engine.query_batch(q, top_k=TOP_K)
    rec.launches["refresh"] = read_counts()
    check_result(res, len(q), n0 + REFRESH_ROWS)
    if res.top_indices[:len(picks), 0].tolist() != (n0 + picks).tolist():
        raise AssertionError(f"refresh: appended rows {n0 + picks} came back as "
                             f"{res.top_indices[:len(picks), 0]}")
    log(f"[refresh] {REFRESH_ROWS} rows appended to {n0} in {append_s:.2f} s (host), "
        f"refresh_index {refresh_s:.2f} s (host clock, to the card's last write); bank "
        f"{bank0} -> {engine._n_bank} rows; queries on 4 appended rows found each first; "
        f"launches {rec.launches['refresh']}; {card}")


def path_d3(index, graph, queries, ref, dev, card, rec) -> None:
    """bench.py's BENCH_INT8_MODE="" mode over the bf16-rounded rows: B1,
    B2, the rescore from the bf16 copy, B=8192."""
    opts = dict(quantize_int8=True, int8_rescore=RESCORE, select_lane_t=1)
    engine = engine_ready("D3", index, graph, dev, BATCH, **opts)
    drive(engine, queries, ("int8_tile_topk", "packed_candidate_merge"), "D3", ref, rec,
          min_recall=D3_MIN_RECALL)
    check_small_against_cpu(dev, "D3", dict(ell_max_degree=8, **opts))
    dq = torch.from_numpy(queries).to(dev)
    time_step(engine, dq, "D3", card, reps=5)
    int8_kernels_at_path(engine, dq, "D3", card, rec, RESCORE, b1_reps=1)


def r_inputs(n: int):
    """Path R's query and `n` seeded nodes (D=384, 256 entities: 8 bit
    words, six node types, word-overlap texts)."""
    from hcrag_tpu_torch.core.types import NodeInput, QueryInput, QueryIntent

    rng = np.random.default_rng(12)
    words = np.array(["red", "road", "bike", "frame", "manual", "helmet", "chain", "the"])
    types = ["product", "document", "specification", "annotation", "category", "unknown"]
    ents = [f"ent{i}" for i in range(256)]
    embs = rng.standard_normal((n, DIM)).astype(np.float32)
    n_ents = rng.integers(0, 5, n)
    ent_ids = rng.integers(0, 256, (n, 4))
    text_ids = rng.integers(0, len(words), (n, 6))
    nodes = [NodeInput(" ".join(words[text_ids[i]]), embs[i], {}, types[i % 6],
                       [ents[j] for j in ent_ids[i, :n_ents[i]]])
             for i in range(n)]
    query = QueryInput("red road bike frame", rng.standard_normal(DIM).astype(np.float32),
                       ["ent3", "ent17", "ent200"], QueryIntent.PRODUCT_SEARCH)
    return query, nodes


def path_r_routes(dev, card) -> None:
    """The route data of `batch_isRelevant`'s composite scoring on the card:
    the fused route (B6) and the unfused one from the same judge column at
    R_ROUTE_NODES node counts, ten calls each in turns (host clock), and the
    device's busy share of one call of each (the rest is the host's)."""
    from hcrag_tpu_torch.config import RuntimeConfig
    from hcrag_tpu_torch.core.types import DEFAULT_COMPOSITE_WEIGHTS, ScorerType
    from hcrag_tpu_torch.pipeline import isrelevant as isr
    from hcrag_tpu_torch.pipeline.llm import LLMClient

    t0 = time.time()
    query, all_nodes = r_inputs(max(R_ROUTE_NODES))
    client = LLMClient(RuntimeConfig(llm_base_url=""))
    log(f"[R routes] {len(all_nodes)} nodes built in {time.time() - t0:.1f} s (host set-up)")
    routes = {"fused": isr._fused_device_scores, "unfused": isr._unfused_device_scores}
    for n in R_ROUTE_NODES:
        nodes = all_nodes[:n]
        llm = isr._batch_process_with_llm(query, nodes, 10, client)
        calls = {name: (lambda fn=fn: fn(query, nodes, ScorerType.COMPOSITE,
                                         DEFAULT_COMPOSITE_WEIGHTS, llm=llm, device=dev))
                 for name, fn in routes.items()}
        for call in calls.values():
            call()  # warm-up
        ms = {name: [] for name in calls}
        for i in range(10):
            for name in (("fused", "unfused") if i % 2 == 0 else ("unfused", "fused")):
                t0 = time.perf_counter()
                calls[name]()
                ms[name].append((time.perf_counter() - t0) * 1e3)
        busy = {}
        for name, call in calls.items():
            _, busy_us, wall_us = profiled(call, 1)
            busy[name] = (100 * busy_us / wall_us, wall_us / 1e3)
        log(f"[R routes] {n} nodes, composite, 10 calls each in turns (host clock; {card}): "
            + "; ".join(f"{name} median {np.median(v):.2f} ms (min {min(v):.2f}, max "
                        f"{max(v):.2f}), device busy {busy[name][0]:.1f}% of one "
                        f"{busy[name][1]:.2f} ms call (host share "
                        f"{100 - busy[name][0]:.1f}%)" for name, v in ms.items()))


def path_r(dev, card, rec) -> None:
    """`batch_isRelevant` over R_NODES nodes for the six multi-metric
    strategies: one launch of B6 per call."""
    from hcrag_tpu_torch.config import RuntimeConfig
    from hcrag_tpu_torch.core.types import (
        DEFAULT_COMPOSITE_WEIGHTS, ScorerType, scorer_needs_llm,
    )
    from hcrag_tpu_torch.ops import scoring_cuda as sc
    from hcrag_tpu_torch.pipeline import isrelevant as isr
    from hcrag_tpu_torch.pipeline.llm import LLMClient

    t0 = time.time()
    query, nodes = r_inputs(R_NODES)
    client = LLMClient(RuntimeConfig(llm_base_url=""))
    scorers = (ScorerType.COMPOSITE, ScorerType.PARALLEL, ScorerType.ROUTER,
               ScorerType.ROUTER_ALL, ScorerType.ROUTER_TWO_SEM_LLM,
               ScorerType.ROUTER_TWO_ENT_TYPE)
    log(f"[R] {R_NODES} nodes (D={DIM}) built in {time.time() - t0:.1f} s (host set-up)")
    isr.batch_isRelevant(query, nodes, ScorerType.COMPOSITE, client=client)  # warm-up

    zero_counts()
    got, host_s = {}, {}
    for st in scorers:
        before = sc.batch_relevance.launches
        t0 = time.perf_counter()
        got[st] = isr.batch_isRelevant(query, nodes, st, client=client)
        host_s[st] = time.perf_counter() - t0
        if sc.batch_relevance.launches != before + 1:
            raise AssertionError(f"R: {st} launched B6 {sc.batch_relevance.launches - before} times")
    rec.launches["R"] = read_counts()
    log(f"[R] batch_isRelevant x {len(scorers)} strategies: launches {rec.launches['R']}")

    worst = 0.0
    for st in scorers:
        llm = isr._batch_process_with_llm(query, nodes, 10, client) \
            if scorer_needs_llm(st) else None
        plain = isr._fused_device_scores(query, nodes, st, DEFAULT_COMPOSITE_WEIGHTS,
                                         llm=llm, device="cpu")
        cpu_route = isr.batch_isRelevant(query, nodes, st, client=client, device="cpu")
        # The two routes on the card from the same judge column, in turns
        # (fused, unfused, unfused, fused), on the host clock.
        route_ms = {isr._fused_device_scores: [], isr._unfused_device_scores: []}
        for fn in (isr._fused_device_scores, isr._unfused_device_scores) * 2:
            t0 = time.perf_counter()
            out = fn(query, nodes, st, DEFAULT_COMPOSITE_WEIGHTS, llm=llm, device=dev)
            route_ms[fn].append((time.perf_counter() - t0) * 1e3)
            e = float(np.abs(np.subtract(got[st], out)).max())
            worst = max(worst, e)
        e = max(worst, float(np.abs(np.subtract(got[st], plain)).max()),
                float(np.abs(np.subtract(got[st], cpu_route)).max()))
        if not e <= 1e-5:
            raise AssertionError(f"R: {st} differs from the plain route by {e}")
        worst = e
        fused, unfused = (route_ms[isr._fused_device_scores],
                          route_ms[isr._unfused_device_scores])
        log(f"[R]   {st.value}: batch_isRelevant {host_s[st] * 1e3:.2f} ms; from the "
            f"same judge column, fused route {fused[0]:.2f} / {fused[1]:.2f} ms, "
            f"unfused route on the card {unfused[0]:.2f} / {unfused[1]:.2f} ms "
            f"(host clock; {card})")
    log(f"[R] scores within {worst:.3g} of the plain B6 on the CPU, the CPU's unfused "
        f"route and both routes on the card (gate 1e-5)")
    rec.err("batch_relevance", worst)
    profile_step(lambda: isr.batch_isRelevant(query, nodes, ScorerType.COMPOSITE,
                                              client=client), card)

    llm = isr._batch_process_with_llm(query, nodes, 10, client)
    args, reduction = isr._fused_inputs(query, nodes, ScorerType.COMPOSITE,
                                        DEFAULT_COMPOSITE_WEIGHTS, llm, dev)
    e = float((sc.batch_relevance(*args, reduction=reduction)
               - sc.batch_relevance_plain(*args, reduction=reduction)).abs().max())
    rec.err("batch_relevance", e)
    b6_at(args, reduction, "R", "B=1 N=8192 (the path's operands)", card, rec)
    # B6 at path R's route sizes and at the JAX ablation's shape
    # (benchmarks/scoring_ablation.py: 256 queries x 8192 nodes).
    for label, b, n, llm_on in (("R@2048", 1, 2048, True), ("R@32768", 1, 32768, True),
                                ("ablation", 256, R_NODES, True),
                                ("ablation, no llm", 256, R_NODES, False)):
        big = b6_inputs(b, n, 99 + n, dev)
        if not llm_on:
            big[-1] = None
        b6_at(big, 0, label, f"B={b} N={n} llm={llm_on}", card, rec)


def b6_at(args, reduction, label, shape, card, rec) -> None:
    """B6's device time on `args` (CUDA-graph replays: at b = 1 a launch
    takes less time than the host takes to issue it), its plain version's
    (CUDA events), its bound, and the dots alone (one f32 product of the
    same operands, TF32 off: not the same function), recorded under
    `label`."""
    from hcrag_tpu_torch.ops import scoring_cuda as sc
    from hcrag_tpu_torch.utils.bounds import scoring_work
    from hcrag_tpu_torch.utils.timing import graph_ms

    q, e = args[0], args[4]
    b, n, w = q.shape[0], e.shape[0], args[1].shape[1]
    ms = graph_ms(lambda: sc.batch_relevance(*args, reduction=reduction), calls=20, replays=10)
    plain_ms = cuda_ms(lambda: sc.batch_relevance_plain(*args, reduction=reduction), reps=5)
    dots = (lambda: torch.mv(e, q[0])) if b == 1 else (lambda: torch.matmul(q, e.T))
    dots_ms = graph_ms(dots, calls=20, replays=10)
    work = scoring_work(b, n, q.shape[1], w, llm=args[10] is not None)
    bound = bound_ms(work["ops"], "f32", work["bytes"])
    plan = sc.launch_plan(q, e, w)
    log(f"[R] B6 batch_relevance {shape} W={w} ({plan.regime}, {plan.queries} queries a "
        f"block): {ms:.4f} ms (plain {plain_ms:.4f} ms, bound {bound[0]:.4f} ms by "
        f"{bound[1]}, {100 * bound[0] / ms:.0f}% of it; dots alone, not the same function: "
        f"{'torch.mv' if b == 1 else 'torch.matmul'} in f32 {dots_ms:.4f} ms; {card})")
    rec.kernel("batch_relevance", label, ms, plain_ms, bound, dots_alone_ms=dots_ms)


def path_d1(index, graph, queries, ref, dev, card, rec) -> None:
    """The 10M one-chip deployment: int8 selection and the rescore from the
    int8 + residual reconstruction, B=2048; then kernel B3e over its bank
    through `cosine_top_k_int8(packed_select=False)`."""
    from hcrag_tpu_torch.ops import topk_cuda as tc
    from hcrag_tpu_torch.ops.quantize import quantize_queries

    opts = dict(quantize_int8=True, int8_residual=True, int8_rescore=RESCORE,
                select_lane_t=1)
    engine = engine_ready("D1", index, graph, dev, D_BATCH, **opts)
    log(f"[D1] peak host RSS {host_rss_gib():.1f} GiB")
    drive(engine, queries, ("int8_tile_topk", "packed_candidate_merge"), "D1", ref, rec,
          n_rows=N_10M)
    check_small_against_cpu(dev, "D1", dict(ell_max_degree=8, **opts))
    dq = torch.from_numpy(queries).to(dev)
    time_step(engine, dq, "D1", card, reps=3)
    int8_kernels_at_path(engine, dq, "D1", card, rec, RESCORE, b1_reps=2)

    bank = engine._bank()
    e8, es = bank["emb_int8"], bank["emb_scale"]
    n_bank = e8.shape[0]
    mask = path_mask(n_bank, N_10M, dev)
    zero_counts()
    v, i = tc.cosine_top_k_int8(dq, e8, es, mask, TOP_K, packed_select=False)
    torch.cuda.synchronize()
    rec.launches["D1x"] = read_counts()
    log(f"[D1x] cosine_top_k_int8(packed_select=False) B={D_BATCH} over D1's bank: "
        f"launches {rec.launches['D1x']}; recall@{TOP_K} of the exact int8 selection "
        f"(no rescore) {recall(ref, i.cpu().numpy()):.4f}")
    if rec.launches["D1x"]["int8_exact_tile_topk"] < 1:
        raise AssertionError("D1x never launched int8_exact_tile_topk")
    q8, qs = quantize_queries(dq)
    kv, ki = tc.int8_exact_tile_topk(q8, qs, e8, es, mask, TOP_K)
    rec.err("int8_exact_tile_topk",
            same_bits(kv, ki, *tc.int8_exact_tile_topk_plain(q8, qs, e8, es, mask, TOP_K)))
    del kv, ki
    ms = cuda_ms(lambda: tc.int8_exact_tile_topk(q8, qs, e8, es, mask, TOP_K), reps=2)
    plain_ms = cuda_ms(lambda: tc.int8_exact_tile_topk_plain(q8, qs, e8, es, mask, TOP_K),
                       reps=1, warmup=0)
    # The yardstick: the same int8 dots alone, torch._int_mm in 1M-row
    # chunks (the [B, N] int32 product would not fit), not the same function.
    chunk = 1_000_000

    def int8_dots():  # each chunk's product is dropped before the next
        for lo in range(0, n_bank, chunk):
            torch._int_mm(q8, e8[lo:lo + chunk].T)

    dots_ms = cuda_ms(int8_dots, reps=1)
    tiles = -(-n_bank // 2048)
    nbytes = (q8.numel() + 4 * qs.numel() + e8.numel() + 4 * es.numel() + mask.numel()
              + 8 * D_BATCH * tiles * TOP_K)
    bound = bound_ms(2.0 * D_BATCH * n_bank * DIM, "int8", nbytes)
    log(f"[D1x] B3e int8_exact_tile_topk B={D_BATCH} N={n_bank} tiles={tiles}: bit-equal "
        f"to its plain version; {ms:.3f} ms (plain {plain_ms:.3f} ms, bound "
        f"{bound[0]:.3f} ms by {bound[1]}; dots alone, not the same function: "
        f"torch._int_mm in {chunk}-row chunks {dots_ms:.3f} ms; launches on the path "
        f"{rec.launches['D1x']['int8_exact_tile_topk']}; {card})")
    rec.kernel("int8_exact_tile_topk", "D1x", ms, plain_ms, bound, dots_alone_ms=dots_ms)


def path_d2(index, graph, queries, ref, dev, card, rec) -> None:
    """int8-only residency (no rescore) over the bf16-rounded 10M rows:
    B1 at per-tile k = top_k (B3's k-pass packed contract) and B2,
    B=2048."""
    from hcrag_tpu_torch.ops import topk_cuda as tc
    from hcrag_tpu_torch.ops.quantize import quantize_queries

    opts = dict(quantize_int8=True, int8_only=True, int8_rescore=RESCORE,
                select_lane_t=1)
    engine = engine_ready("D2", index, graph, dev, D_BATCH, **opts)
    res = drive(engine, queries, ("int8_tile_topk", "packed_candidate_merge"), "D2", ref,
                rec, n_rows=N_10M, min_recall=D2_MIN_RECALL)
    bank = engine._bank()
    e8, es = bank["emb_int8"], bank["emb_scale"]
    mask = path_mask(e8.shape[0], N_10M, dev)
    q8, qs = quantize_queries(torch.from_numpy(queries[:GATE_QUERIES]).to(dev))
    pv, pi = tc.packed_candidate_merge_plain(
        *tc.int8_tile_topk_plain(q8, qs, e8, es, mask, TOP_K), TOP_K)
    if not (np.array_equal(pi.cpu().numpy(), res.top_indices[:GATE_QUERIES])
            and np.array_equal(pv.cpu().numpy().view(np.int32),
                               res.top_scores[:GATE_QUERIES].view(np.int32))):
        raise AssertionError("D2: the engine's top-10 differs from the plain route's")
    log(f"[D2] top-{TOP_K} of the {GATE_QUERIES} gate queries equals the plain route's "
        f"(plain B1 + plain B2 on the card), bits and indices")
    check_small_against_cpu(dev, "D2", dict(ell_max_degree=8, **opts))
    dq = torch.from_numpy(queries).to(dev)
    time_step(engine, dq, "D2", card, reps=3)
    int8_kernels_at_path(engine, dq, "D2", card, rec, 0, b1_reps=2)


def path_k(dev, card, rec) -> None:
    """The kernel sweep at the JAX sweep's shapes over its own bank: each
    row's launches, the JSON line, the attribution of B5's time, B8a's time
    per dot at 128- against 2048-row tiles; then B8a-c against their plain
    versions at these shapes, with their plain times and bounds, B4 alone
    over the bf16 bank (`testing.check_exact_topk`), and B1 (bit for bit)
    over the bank quantized on the card, beside torch._int_mm of the same
    int8 operands."""
    from hcrag_tpu_torch.benchmarks import kernel_sweep as ks
    from hcrag_tpu_torch.ops import sweep_cuda as sw
    from hcrag_tpu_torch.ops import topk_cuda as tc
    from hcrag_tpu_torch.ops.quantize import quantize_bank, quantize_queries

    t0 = time.time()
    q, e = ks.sweep_data(dev)
    torch.cuda.synchronize()
    b, n = q.shape[0], e.shape[0]
    log(f"[K] sweep data: {n} x {DIM} bf16 rows, B={b} built in {time.time() - t0:.1f} s "
        f"(host draws, copied to the card)")
    zero_counts()
    t0 = time.time()
    res = ks.sweep(dev, data=(q, e))
    rec.launches["K"] = read_counts()
    log(f"[K] sweep in {time.time() - t0:.1f} s; launches {rec.launches['K']}")
    calls = res["shapes"]["steps"] + res["shapes"]["warmup"]
    want = {name: {name: calls} for name in SWEEP_KERNELS}
    want.update(matmul_only_acc_tile128={"matmul_only_acc": calls},
                b5_alone={"float_packed_tile_topk": calls},
                b1_alone={"int8_tile_topk": calls}, library_int8_matmul={})
    for row, counts in want.items():
        if res["launches"][row] != counts:
            raise AssertionError(f"K: row {row} launched {res['launches'][row]}, want {counts}")
    log(json.dumps(res))
    a = res["attribution"]
    b5 = res["b5_alone"]
    log(f"[K] the CUDA-core dot loop (B8a-c; B={b}, N={n}; {card}): dots "
        f"{a['dots_ms']:.3f} ms, wide writes {a['writes_ms']:.3f} ms, encode + level-1 "
        f"{a['encode_level1_ms']:.3f} ms; cuBLAS bf16 product of the same dots "
        f"{res['library_matmul']:.3f} ms ({a['library_speedup_over_dots']:.1f}x that loop's "
        f"rate); B8a per dot at 2048- / 128-row tiles {a['acc_2048_over_128']:.3f}.  B5 "
        f"alone (tensor cores, selection in the epilogue) {b5:.3f} ms, "
        f"{a['b5_over_library']:.2f}x the cuBLAS product; B5 + B2 "
        f"{res['full_two_level']:.3f} ms.  B1 alone (int8 tensor cores) {res['b1_alone']:.3f} "
        f"ms, {a['b1_over_library']:.2f}x one torch._int_mm of the same int8 dots "
        f"({res['library_int8_matmul']:.3f} ms)")
    if not 1 / 1.2 <= a["acc_2048_over_128"] <= 1.2:
        raise AssertionError("K: B8a's time per dot at 2048-row tiles is not within 20% of "
                             "its time at 128-row tiles: dots were dropped")

    qb = q.to(torch.bfloat16)
    tiles = n // 2048
    out_bytes = {"matmul_only_acc": 4 * b * 128, "matmul_only_wide": 4 * b * tiles * 128,
                 "encode_level1": 4 * b * 256}
    for name in SWEEP_KERNELS:
        err = check_sweep_kernel(name, qb, e, 2048, exact=False)
        rec.err(name, err)
        plain = getattr(sw, name + "_plain")
        plain_ms = cuda_ms(lambda: plain(qb, e), reps=1)
        bound = bound_ms(2.0 * b * n * DIM, "bf16",
                         2 * qb.numel() + 2 * e.numel() + out_bytes[name])
        log(f"[K] B8 {name} B={b} N={n} tiles={tiles}: agrees with its plain version "
            f"(max |err| {err:.3g}); {res[name]:.3f} ms (plain {plain_ms:.3f} ms, "
            f"dots alone, not the same function: torch.matmul {res['library_matmul']:.3f} ms, "
            f"bound {bound[0]:.3f} ms by {bound[1]}; {card})")
        rec.kernel(name, "K", res[name], plain_ms, bound, res["library_matmul"])

    # B4 alone over the sweep's bf16 bank (f32 sums on the CUDA cores, the
    # loop that B8a-c split), against its plain version.
    from hcrag_tpu_torch.testing import check_exact_topk

    mask = torch.ones(n, dtype=torch.bool, device=dev)
    kv, ki = tc.float_tile_topk(qb, e, mask, TOP_K)
    err, moved = check_exact_topk(kv, ki, *tc.float_tile_topk_plain(qb, e, mask, TOP_K),
                                  qb, e, mask)
    rec.err("float_tile_topk", err)
    del kv, ki
    b4_ms = cuda_ms(lambda: tc.float_tile_topk(qb, e, mask, TOP_K), reps=3)
    plain_ms = cuda_ms(lambda: tc.float_tile_topk_plain(qb, e, mask, TOP_K), reps=1)
    bound = bound_ms(2.0 * b * n * DIM, "f32", 2 * qb.numel() + 2 * e.numel() + n
                     + 8 * b * tiles * TOP_K)
    log(f"[K] B4 float_tile_topk B={b} N={n} tiles={tiles} bf16 bank: agrees with its plain "
        f"version (max |err| {err:.3g}, {moved} indices at near-ties); {b4_ms:.3f} ms "
        f"(plain {plain_ms:.3f} ms, bound {bound[0]:.3f} ms by {bound[1]}; the CUDA-core "
        f"loop's dots alone, B8a, {res['matmul_only_acc']:.3f} ms; {card})")
    rec.kernel("float_tile_topk", "K", b4_ms, plain_ms, bound)

    # B1 at the sweep's shapes over the bank quantized on the card, against
    # its plain version, beside torch._int_mm of the same int8 operands
    # (the dots alone, not the same function).
    q8, qs = quantize_queries(q)
    e8, es = quantize_bank(e, dev)
    args = (q8, qs, e8, es, mask, TOP_K)
    vals, idxs = tc.int8_tile_topk(*args)
    rec.err("int8_tile_topk", same_bits(vals, idxs, *tc.int8_tile_topk_plain(*args)))
    plain_ms = cuda_ms(lambda: tc.int8_tile_topk_plain(*args), reps=1, warmup=0)
    bound = bound_ms(2.0 * b * n * DIM, "int8", q8.numel() + 4 * qs.numel() + e8.numel()
                     + 4 * es.numel() + mask.numel() + 8 * vals.numel())
    log(f"[K] B1 int8_tile_topk B={b} N={n} tiles={tiles} k={TOP_K}: bit-equal to its plain "
        f"version; {res['b1_alone']:.3f} ms (plain {plain_ms:.3f} ms, dots alone, not the "
        f"same function: torch._int_mm {res['library_int8_matmul']:.3f} ms, bound "
        f"{bound[0]:.3f} ms by {bound[1]}; {card})")
    rec.kernel("int8_tile_topk", "K", res["b1_alone"], plain_ms, bound,
               res["library_int8_matmul"])


def free(label: str) -> None:
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"[{label}] freed; {torch.cuda.memory_allocated() / 2**30:.2f} GiB still "
        f"allocated on the card")


def summary(rec: Record) -> dict:
    """One entry per kernel: the numbers of the first path that timed it,
    and every path's."""
    out = []
    for name in KERNELS:
        paths = rec.rows[name]
        if not paths:
            raise AssertionError(f"{name} was never timed at a path's shapes")
        first = next(iter(paths.values()))
        out.append({
            "name": name, "route": "cuda", "source": SOURCES[name][0],
            "replaces": SOURCES[name][1], "path": next(iter(paths)),
            "launches": first["launches"], "max_abs_err": rec.max_err[name],
            "ms": first["ms"], "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
            "library_ms": first["library_ms"],
            "launches_by_path": {path: c[name] for path, c in rec.launches.items()},
            "by_path": paths,
        })
    return {"kernels": out}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    from hcrag_tpu_torch.ops import _build
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
    reports = _build.build(_build.KERNEL_SOURCES)
    log(f"[build] {len(reports)} of {len(_build.KERNEL_SOURCES)} sources built in "
        f"{time.time() - t0:.1f} s (nvcc -gencode arch=compute_90a,code=sm_90a)")
    for name, rep in reports.items():
        for fn, props in _build.ptxas_report(rep):
            log(f"[build] {name}: {fn}: {props}")
            if "0 bytes spill stores, 0 bytes spill loads" not in props:
                raise AssertionError(f"{name}: {fn} spills registers: {props}")
    check_int8_sass(_build)

    # 3. kernels against their plain versions -------------------------------
    log("[kernels] kernel vs plain PyTorch version")
    max_err = phase_kernels(dev)
    max_err.update(float_tile_topk=0.0, float_packed_tile_topk=0.0)
    phase_float_kernels(dev, max_err)
    phase_scoring_kernels(dev, max_err, card)
    phase_super_kernels(dev, max_err)
    phase_sweep_kernels(dev, max_err)
    rec = Record(max_err)

    # 4-7. the paths over one 1M-row index --------------------------------------
    t0 = time.time()
    index, graph = synthetic_setup(N_ROWS, DIM, graph_degree=4)
    log(f"[setup] synthetic index {N_ROWS} x {DIM} + graph built in "
        f"{time.time() - t0:.1f} s (host)")
    rng = np.random.default_rng(7)
    queries = rng.standard_normal((BATCH, DIM)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    ref = brute_force_top_k(index.emb, queries, dev)
    path_int8(index, graph, queries, ref, dev, card, rec)
    free("int8")
    path_f2(index, graph, queries, ref, dev, card, rec)
    free("F2")
    for label in ("S1", "S2"):
        path_super(label, index, graph, queries, ref, dev, card, rec)
        free(label)
    f1_q = np.random.default_rng(8).standard_normal((F1_BATCH, DIM)).astype(np.float32)
    f1_q /= np.linalg.norm(f1_q, axis=1, keepdims=True)
    engine = path_f1(index, graph, brute_force_top_k(index.emb, f1_q, dev), dev, card, rec)
    path_m(engine, index, graph, dev, card, rec)
    del engine
    free("M")
    path_x(index, queries, dev, card, rec)
    free("X")
    path_large_k(index, graph, queries, dev, card, rec)
    round_to_bf16(index.emb)
    path_d3(index, graph, queries, ref, dev, card, rec)
    free("D3")
    path_refresh(index, graph, dev, card, rec)
    free("refresh")
    del index, graph

    # the kernel sweep over its own bank ------------------------------------
    path_k(dev, card, rec)
    free("K")

    # 8. relevance scoring --------------------------------------------------
    path_r(dev, card, rec)
    path_r_routes(dev, card)
    free("R")

    # 9-10. the density paths over one 10M-row index ---------------------------
    t0 = time.time()
    index, graph = synthetic_setup(N_10M, DIM, graph_degree=4)
    log(f"[setup] synthetic index {N_10M} x {DIM} + graph built in "
        f"{time.time() - t0:.1f} s (host); peak host RSS {host_rss_gib():.1f} GiB")
    d_queries = queries[:D_BATCH].copy()
    t0 = time.time()
    ref = brute_force_top_k(index.emb, d_queries, dev)
    log(f"[setup] f32 brute force of {GATE_QUERIES} queries over {N_10M} rows in "
        f"{time.time() - t0:.1f} s")
    path_d1(index, graph, d_queries, ref, dev, card, rec)
    free("D1")
    path_super("S3", index, graph, d_queries, ref, dev, card, rec, n_rows=N_10M)
    free("S3")
    t0 = time.time()
    round_to_bf16(index.emb)
    log(f"[setup] {N_10M} rows rounded to bf16 in {time.time() - t0:.1f} s (host)")
    path_d2(index, graph, d_queries, ref, dev, card, rec)
    free("D2")
    log(f"[done] {time.time() - t_start:.1f} s in all; peak host RSS "
        f"{host_rss_gib():.1f} GiB")

    print(json.dumps(summary(rec)), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
