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
  3b. build  — the offline build path, from corpora written from a seed
               (`testing.write_adventureworks_corpus`), after g++ builds the
               native host libraries:
     path B  — the reference-sized corpus (7 CSVs, 4 PDFs, 6 JSON
               tables, 3 JPGs): the CLI on the card as subprocesses, `build`
               and `extract-graph` at once, then `stats`, `query`, `viz` and
               `graph-html` over the saved artifacts at once, each exiting
               0; then `build_adventureworks` and the default engine in this
               process: `process_query` launches B4 once a call, equals the
               CPU engine (rows exact, scores within 1e-5), and the CLI's
               reloaded artifacts give the same results;
     path G  — `PropertyGraphBuilder("auto")` over that corpus,
               `build_graph_index`, the default engine on the card,
               `query_batch` B=64 with expansion (B4 once), card == CPU;
     path B at scale — the same schema with the order and catalogue
               tables at the AdventureWorks OLTP sample's row counts
               (~155,000 index rows): the graph index build time by stage
               (host clock; the native embedder must have built) and the
               peak host RSS; then 1024 of the index's own texts, encoded by
               the built embedder, through the default engine (B4 once,
               gated by `testing.check_exact_topk` against f32 brute force)
               and the int8 + f32 rescore engine (B1 once; its 760-candidate
               pool takes no B2; equal to the CPU on 64 queries), recall@10
               of each and ms per step (CUDA events), B4 and B1 against their
               plain versions at these shapes;
     path PV — the parity tools (`hcrag_tpu_torch.tools`) on the card over
               path B's corpus and its hashing-embedder pickle:
               `verify_parity` exits 0 (B4 at 1 x 589 rows), then
               `agent_trace_fixture` writes its fixture and `--check`s
               against it (exit 0 and 0); the card's traces equal the CPU's
               (node traces, sampled ids, decisions, final keys; scores
               within 1e-5);
     path EX — the three examples (`hcrag_tpu_torch.examples.*`) on the
               card as subprocesses, at once, `end_to_end` and
               `path_extraction` over path B's corpus, each exiting 0;
     path T  — the query encoder's training path (`hcrag_tpu_torch.tools`):
               a golden set of the corpus's 589 texts with the committed
               distilled encoder's vectors (the teacher), then
               `distill_minilm.main` at full width (batch 128, max_len 192)
               for 200 steps in chunks of 50 (the loss falls; outputs finite
               and unit-norm) and the train step alone (ms by CUDA events,
               steps/s, tokens/s, peak memory, a profile, its bound); the
               run stopped after step 100's checkpoint and resumed to 200
               against the uninterrupted one (parameters bit-equal,
               embeddings within `T_RESUME_TOL`); the held-out mode (100 steps, 20%
               held out, one variant a text) and `encoder_confidence` over
               its encoder (AUC, label balance, the ensemble's lift), loaded
               onto the card; the held-out embeddings through `query_batch`
               over the golden bank (one B4 launch; index sets equal to the
               numpy top-10 where no tie sits at the boundary); 3 steps at
               batch 8 and max_len 64 on the card and the CPU from the same
               weights (losses within 1e-5 relative, embeddings within 1e-4);
     path GE — the driver's entry points (`hcrag_tpu_torch.graft_entry`):
               `entry()`'s step on the card (one B4 launch) equal to the
               CPU's (indices exactly, floats within 1e-5);
               `dryrun_multichip(1)` over NCCL, then 2 and 4 gloo ranks on
               the card (each calls `dryrun_multichip` inside the group):
               every part passes on every rank, the launches counted
               (GE-1, GE-2, GE-4; a shard's pool of 32 takes no B2); B1,
               B4 and B5 at a shard's shapes against their plain versions;
               then the contrastive step at full width (the default
               MiniLMConfig, seq 128, 32 pairs a rank) over NCCL at world
               size 1 and on 2 gloo ranks, 12 steps: ms/step by CUDA
               events (the median and spread of the 10 after 2 warm-up
               steps), the gradient all-reduce's bytes and host ms, peak
               device memory, the loss after 3 updates below the first
               (its ratio logged), a profile of one step at world size 1;
  4. int8 path — `QueryEngine.query_batch` at 1,000,000 x 384, B=8192,
               top_k=10, depth 1 in the int8-select + f32-rescore mode
               (kernels B1, B2);
     path E  — serving over the same engine through `BatchedExecutor`
               (retrieval mode; batch 1024, dispatch sizes 128/256/1024,
               pipeline depth 3, 2 ms wait): Poisson traffic at 2,000,
               5,000, 10,000 and 20,000 req/s for 2 s each (achieved req/s,
               p50/p95/p99 latency from scheduled arrival to resolve, mean
               batch fill, the interpreter's full collections), 20,000
               req/s again with the set-up's objects frozen (`gc.freeze`),
               a saturation row of 65,536 requests and a second one traced
               on the device (busy share), then a full-mode saturation row;
               B1 and B2 launch once per dispatched batch; every saturation
               batch holds 1024 requests whose results equal `query_batch`
               at B=1024 bit for bit, and 256 open-loop requests equal
               `query_batch` (indices exact, scores within 1e-6);
     path RR — the learned re-ranker over the same engine:
               `distill_judge_aware` on the card (512 queries, top_m 20, 30
               epochs of batch 32; training steps/s), `query_batch(rerank=
               True)` at B=1024 (host ms, the re-rank stage's share), the
               card's checkpoint restored on the CPU (scores within 1e-6),
               NDCG@10 against the teacher on 512 held-out queries, re-ranked
               and not (a report);
     path P1 — the sharded engine (`parallel/`) at world size 1 over NCCL
               on the same index and queries: int8 + bf16 rescore (B1, B2
               over the shard's pool) and `exact_rescore=32` (B5, B2), each
               equal to an unsharded engine of the same options bit for
               bit, recall gated, both steps timed in turns (unsharded,
               sharded, sharded, unsharded) with the ratio, the busy share;
               then the int8 engine's checkpoint saved, its banks zeroed,
               restored (seconds, bytes; results equal), 1,024 requests
               through `BatchedExecutor` over it (the rank protocol over
               NCCL), equal to `query_batch`, and a closed-loop saturation
               (65,536 requests in blocks of 1,024) through the executor
               over the unsharded and the sharded engine in turns: req/s of
               each, their ratio (the protocol's cost), every batch equal to
               `query_batch` bit for bit, then the host and wall ms of each
               piece of a dispatch;
  5. path F2 — the same index in `bench.py`'s bf16 mode (`exact_rescore=32`:
               B5 over a bf16 bank, B2, the f32 rescore), B=8192;
     path S1 — the same index, `exact_rescore=32, pallas_super=8` (1024-row
               tiles grouped 8 at a time: 123 supertiles of 8192 rows), B=8192:
               B7f, B2 over the 123 x 16 pool, the f32 rescore;
     path S2 — the same index, `quantize_int8=True, int8_rescore=32,
               int8_f32_rescore=True, pallas_super=4` (2048 x 4 rows),
               B=8192: B7i, B2;
     path P2 — 2 and 4 ranks spawned on the one card over gloo (NCCL
               refuses two ranks on one card), 262,144 x 384, B=1024, in 9
               modes (B4, B5, B7f, B1, B7i) and, at 4 ranks, `shard_graph`
               at depth 2 and a 2 x 2 (batch, rows) mesh: every rank's
               results equal rank 0's bit for bit and the unsharded
               engine's on the card; each mode launches its selection
               kernel and no B2 (pools of 64 or 32 tiles); the ranks' step
               times, which measure no interconnect; then B4, B5, B7f, B1
               and B7i at one shard's shapes (65,536 rows, B=1024) against
               their plain versions;
     path P3 — `BatchedExecutor` over the sharded engine on 2 and 4 gloo
               ranks spawned on the card (rank 0 serves, the others
               follow), P2's index, int8 + rescore (B1) and f32 (B4):
               16,384 requests in blocks of 1,024 and 256 single requests
               from 8 clients (dispatch sizes 128 / 256 / 1024), then 4,096
               in full mode at depth 3; every served batch equals the
               unsharded engine's `query_batch` of it bit for bit, every
               rank steps every batch, the blocks' req/s and the singles'
               p50 / p99 (the ranks share one card: no measure of serving
               across cards); a failure case (2 ranks, 10 s group timeout,
               rank 1's step raises) in which every rank returns within
               the bound; B1 and B4 at 128 and 256 queries a shard against
               their plain versions;
  6. path F1 — the default engine (B4 over the f32 bank), `query_batch` at
               B=1024, then `process_query`, `find_similar_content`,
               `search_by_category` (every 500th row re-typed) and
               `retrieve_batch_device` at B=1024, each of which must launch
               B4;
     path A  — the agents and pipelines over F1's engine, with an embedder
               that encodes a row's text to its row (`testing.
               RowLookupEmbedder`) and the offline LLM client:
               `RetrievalAgent.run` on 3 questions, `ImprovedRetrievalAgent`
               with a thread id and its journal read back by a fresh
               `MemorySaver`, `EnhancedRAG`, `GraphRelevanceScorer`, five
               `QueryInterface` modes and `answer_graph_question` (host ms
               and B4 launches per call; no scoring fallback and no failure
               shape taken); then the same runs over a 20,000-row engine on
               the card and on the CPU agree (traces, sampled ids, node
               order, scores within 1e-5);
     path M  — the MiniLM query encoder on the card over F1's engine: the
               distilled weights (`tools/minilm_distilled*`) loaded and
               attached (`attach_device_encoder`), 1024 texts of the
               committed vocabulary encoded at max_len 64 and 192 (forward
               ms per batch by CUDA events, texts/s, peak memory; the card
               within 1e-4 of the CPU on 8 texts), their embeddings through
               `query_batch` (one B4 launch), `process_query` on text, and
               the encoder confidence over a 100,000-row slice (the auto
               rule's limit), on the host clock; the WordPiece tokenizer's
               texts/s on the same texts, native and Python (ids equal);
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

Path BM runs the root benchmark scripts of the port
(`hcrag_tpu_torch/benchmarks/`), each through its `run()` on the card at
the JAX script's size, every launch counter at 0 just before and read just
after, with the script's own checks, then every kernel it launches at its
shapes against its plain version (B1, B2, B3e bit for bit; B4, B5 by the
rules of `testing.py`; B6 within 1e-5), timed beside its bound: over the
1M rows, right after paths L1/L2, `ablation` (the bf16 rows, B=1024: the
dots, the streaming selection, B4, the step at max_expanded 20 and 1; B4
must agree with the streaming selection) and `expansion_heavy` (path X's
graph and engine: the step, retrieval, expansion, dedup); after path R,
`hbm_bandwidth` (read and copy rates), `dispatch_floor` (B5 at 2^17-2^20
rows, B2 at 2^20, the fit a + dN on both clocks), `merge_micro` (B2,
`torch.topk`, argmax32 over [512, 4890]; B2's sets against torch.topk's
within one key quantum), `scoring_ablation` (B6 against the plain route
at 128, 1,024 and 8,192 nodes), `twolevel_ablation` (B1 + B2, B4, B5 + B2,
B3e over 1M rows, B=512; the f32 top-10 inside the int8 merge-32 gated at
0.998), `reranker_eval` (the seeded corpus, NDCG@10), `sharded_traffic`
(2 and 4 gloo ranks on the card: bytes per collective equal to the model,
every rank's top-10 equal to the f32 brute force; B4 in the ranks) and
`sharded_10m` cut to 1,048,576 rows over 2 ranks, both modes (recall@10
gated at 0.998, self-retrieval, the per-rank memory; B5 and B1 in the
ranks, whose launches the script returns).

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

import contextlib
import gc
import json
import os
import resource
import subprocess
import sys
import threading
import time
import warnings

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
E_BATCH, E_SIZES, E_DEPTH, E_WAIT_MS = 1024, (128, 256, 1024), 3, 2.0  # the JAX harness's
E_RATES, E_SECONDS, E_SAT = (2000.0, 5000.0, 10000.0, 20000.0), 3.0, 65536
E_WAIT_S = 60.0  # the most one served request may take before the phase fails
RR_QUERIES, RR_TOP_M, RR_EPOCHS, RR_BATCH = 512, 20, 30, 32
A_SEED, A_SMALL_ROWS = 42, 20_000  # the agents' sampling seed; the card-vs-CPU engine
P2_ROWS, P2_BATCH, P2_REPS = 262_144, 1024, 2  # path P2: ranks sharing the one card
P2_WORLDS = (2, 4)
BM_SHARDS = (2, 4)  # path BM: sharded_traffic's ranks
BM_10M_ROWS, BM_10M_RANKS = 1_048_576, 2  # path BM: sharded_10m cut to one 1M bank
EXAMPLES = ("end_to_end", "configurable_weights", "path_extraction")  # path EX


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


def profiled(step, steps: int, host_ops: bool = True):
    """torch.profiler over `steps` calls of step(): (device-side rows
    [(us, name, count)], device busy us, wall us).  Without `host_ops` it
    traces the device alone, which costs the host less."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU] if host_ops else []
    with profile(activities=acts + [ProfilerActivity.CUDA]) as prof:
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
        counts = self.launches.get(path)
        self.rows[name][path] = dict(
            launches=counts[name] if counts is not None else None,
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


def b1_at(q8, qs, e8, es, mask, k, label, card, rec, reps=3):
    """B1 on these operands against its plain version (bit for bit), then
    its time beside the plain version's and its bound; returns its
    candidates."""
    from hcrag_tpu_torch.ops import topk_cuda as tc

    vals, idxs = tc.int8_tile_topk(q8, qs, e8, es, mask, k)
    rec.err("int8_tile_topk",
            same_bits(vals, idxs, *tc.int8_tile_topk_plain(q8, qs, e8, es, mask, k)))
    (b, d), n_bank, tiles = q8.shape, e8.shape[0], vals.shape[1]
    log(f"[{label}] B1 at the path's shapes: bit-equal to its plain version")
    b1_ms = cuda_ms(lambda: tc.int8_tile_topk(q8, qs, e8, es, mask, k), reps=reps)
    b1_plain_ms = cuda_ms(lambda: tc.int8_tile_topk_plain(q8, qs, e8, es, mask, k), reps=1,
                          warmup=0)  # the bit check above warmed it
    b1_bytes = (q8.numel() + 4 * qs.numel() + e8.numel() + 4 * es.numel()
                + mask.numel() + 8 * vals.numel())
    b1_bound = bound_ms(2.0 * b * n_bank * d, "int8", b1_bytes)
    log(f"[{label}] B1 int8_tile_topk B={b} N={n_bank} tiles={tiles} k={k}: "
        f"{b1_ms:.3f} ms (plain {b1_plain_ms:.3f} ms, bound {b1_bound[0]:.3f} ms "
        f"by {b1_bound[1]}; {card})")
    rec.kernel("int8_tile_topk", label, b1_ms, b1_plain_ms, b1_bound)
    return vals, idxs


def int8_kernels_at_path(engine, dq, label, card, rec, merge_out_k, b1_reps=3,
                         with_merge=True):
    """B1 and B2 at the path's shapes against their plain versions (bit for
    bit), then their times beside their plain versions' and bounds; B2 only
    `with_merge` (a pool under 4096 candidates takes no kernel)."""
    from hcrag_tpu_torch.ops import topk_cuda as tc
    from hcrag_tpu_torch.ops.quantize import quantize_queries

    bank = engine._bank()
    e8, es = bank["emb_int8"], bank["emb_scale"]
    mask = path_mask(e8.shape[0], engine._n_rows, dq.device)
    q8, qs = quantize_queries(dq)
    k = tc.tile_pick_count(TOP_K, e8.shape[0], 2048, merge_out_k)
    vals, idxs = b1_at(q8, qs, e8, es, mask, k, label, card, rec, reps=b1_reps)
    tiles = vals.shape[1]
    if with_merge:
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
    return engine


def _e_queries(n: int = E_SAT) -> np.ndarray:
    rng = np.random.default_rng(7)  # the JAX harness's query pool
    q = rng.standard_normal((n, DIM)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return q


def int8_per_batch(engine) -> set:
    """The kernels an int8 engine launches once per served batch: B1, and
    B2 where a dispatch size's merge takes it."""
    return {"int8_tile_topk"} | {
        "packed_candidate_merge" for s in E_SIZES
        if engine.resolved_kernel_config(s, TOP_K)["merge"].startswith("packed")}


def check_per_batch(counts: dict, per_batch, batches: int, label: str) -> None:
    """Each kernel of `per_batch` launched once per dispatched batch, and no
    other kernel."""
    for name, n in counts.items():
        want = batches if name in per_batch else 0
        if n != want:
            raise AssertionError(f"{label}: {name} launched {n} times for {batches} batches")


def _check_served_batches(engine, futs, queries, label, full=False) -> int:
    """Every batch of the saturation row holds 1024 consecutive requests,
    and each request's result equals `query_batch` of those 1024 queries:
    indices exact, scores bit for bit (full mode: every field)."""
    batches = {}
    for i, f in enumerate(futs):
        batches.setdefault(id(f._batch), []).append((f._slot, i))
    for members in batches.values():
        slots, reqs = zip(*members)
        lo = reqs[0]
        if len(members) != E_BATCH or list(slots) != list(range(E_BATCH)) or \
                list(reqs) != list(range(lo, lo + E_BATCH)):
            raise AssertionError(f"{label}: a saturation batch holds {len(members)} requests")
        ref = engine.query_batch(queries[lo:lo + E_BATCH], top_k=TOP_K)
        for slot, i in members:
            r = futs[i].result(timeout=1)
            if full:
                got = [r.top_scores, r.top_indices, r.relevance, r.combined, r.expanded_nodes,
                       np.int32(r.expanded_count), r.expanded_relevance]
                want = [ref.top_scores[slot], ref.top_indices[slot], ref.relevance[slot],
                        ref.combined[slot], ref.expanded_nodes[slot],
                        ref.expanded_counts[slot], ref.expanded_relevance[slot]]
            else:
                got, want = [r[0], r[1]], [ref.top_scores[slot], ref.top_indices[slot]]
            for a, b in zip(got, want):
                if not np.array_equal(np.asarray(a), np.asarray(b)):
                    raise AssertionError(f"{label}: request {i} differs from query_batch")
    return len(batches)


@contextlib.contextmanager
def collections(frozen: bool):
    """Record the interpreter's full (generation-2) collections inside the
    block, each one's seconds appended to the list it yields.  With
    `frozen`, every object alive at entry (the set-up: the index's 1M
    metadata dicts and texts) is moved out of the collector's reach
    (`gc.freeze`) until the block ends."""
    pauses, stamp = [], {}

    def on_gc(phase, info):
        if phase == "start":
            stamp["t"] = time.perf_counter()
        elif info["generation"] == 2:
            pauses.append(time.perf_counter() - stamp["t"])

    if frozen:
        gc.collect()
        gc.freeze()
    gc.callbacks.append(on_gc)
    try:
        yield pauses
    finally:
        gc.callbacks.remove(on_gc)
        if frozen:
            gc.unfreeze()


def path_e(engine, dev, card, rec) -> None:
    """Serving through `BatchedExecutor` over the int8 path's engine, with
    the JAX harness's defaults (batch 1024, sizes 128/256/1024, pipeline
    depth 3, 2 ms wait, top_k 10): Poisson traffic at four rates for 3 s
    each, then the highest rate again with the set-up's objects frozen
    (`collections`), a saturation row (65,536 requests through
    `submit_many`, frozen too), the device's busy share over a second
    saturation run traced on the device, and a full-mode saturation row.
    B1 and B2 must each launch once per dispatched batch."""
    from hcrag_tpu_torch.benchmarks import serving_openloop as so
    from hcrag_tpu_torch.query.executor import BatchedExecutor

    t_phase = time.time()
    queries = _e_queries()
    launches = {}
    for mode in ("retrieval", "full"):
        label = "E" if mode == "retrieval" else "E-full"
        zero_counts()
        ex = BatchedExecutor(engine, batch_size=E_BATCH, batch_sizes=E_SIZES,
                             pipeline_depth=E_DEPTH, max_wait_ms=E_WAIT_MS, top_k=TOP_K,
                             mode=mode)
        try:
            for s in E_SIZES:  # one batch of each size first
                ex.submit_many(queries[:s])[-1].result(timeout=E_WAIT_S)
            open_futs = []
            rows = [(r, False) for r in E_RATES] + [(E_RATES[-1], True)]
            for rate, frozen in rows if mode == "retrieval" else ():
                futs = []
                with collections(frozen) as pauses:
                    st = so.run_rate(ex, queries, rate, E_SECONDS, futs, timeout=E_WAIT_S)
                open_futs.append(futs)
                log(f"[E] offered {rate:.0f} req/s for {E_SECONDS:.0f} s"
                    f"{' (set-up objects frozen)' if frozen else ''}: achieved "
                    f"{st['achieved_rps']:.1f} req/s, latency p50 / p95 / p99 "
                    f"{st['latency_ms_p50']:.3f} / {st['latency_ms_p95']:.3f} / "
                    f"{st['latency_ms_p99']:.3f} ms (scheduled arrival -> resolve), mean "
                    f"batch fill so far {so.mean_fill(ex):.1f}; full collections "
                    f"{len(pauses)}, longest {max(pauses, default=0) * 1e3:.1f} ms; {card}")
                time.sleep(0.5)
            before = ex.batches_dispatched
            sat_futs = []
            with collections(True) as pauses:
                sat = so.run_saturation(ex, queries, E_SAT, sat_futs, timeout=E_WAIT_S)
                sat_batches = ex.batches_dispatched - before
                _, busy_us, wall_us = profiled(
                    lambda: so.run_saturation(ex, queries, E_SAT, timeout=E_WAIT_S), 1,
                    host_ops=False)
        finally:
            ex.shutdown()
        launches[label] = counts = read_counts()
        sat_ms = E_SAT / sat["requests_per_s"] * 1e3
        log(f"[{label}] saturation (set-up objects frozen; full collections {len(pauses)}): "
            f"{E_SAT} requests in {sat_batches} batches, {sat['requests_per_s']:.1f} req/s "
            f"({sat_ms:.1f} ms); a second run traced on the device: {busy_us / 1e3:.3f} ms of "
            f"device time in {wall_us / 1e3:.3f} ms ({100 * busy_us / wall_us:.1f}% busy); "
            f"{card}")
        log(f"[{label}] {ex.batches_dispatched} batches dispatched, mean fill "
            f"{so.mean_fill(ex):.1f}; launches {counts}")
        check_per_batch(counts, int8_per_batch(engine), ex.batches_dispatched, label)
        n = _check_served_batches(engine, sat_futs, queries, label, full=mode == "full")
        log(f"[{label}] the {n} saturation batches of 1024 equal query_batch at B=1024 "
            f"on the same queries, bit for bit")
        if mode == "retrieval":
            flat = [(i, f) for futs in open_futs for i, f in enumerate(futs)]
            pick = np.random.default_rng(3).choice(len(flat), 256, replace=False)
            idx = np.array([flat[p][0] % len(queries) for p in pick])
            ref = engine.query_batch(queries[idx], top_k=TOP_K)
            err = 0.0
            for j, p in enumerate(pick):
                scores, indices = flat[p][1].result(timeout=1)
                if not np.array_equal(indices, ref.top_indices[j]):
                    raise AssertionError(f"E: open-loop request {p} differs from query_batch")
                err = max(err, float(np.abs(scores - ref.top_scores[j]).max()))
            if err > 1e-6:
                raise AssertionError(f"E: open-loop scores differ by {err} > 1e-6")
            log(f"[E] 256 open-loop requests against query_batch at B=256: indices equal, "
                f"scores within {err:.3g} (gate 1e-6)")
    rec.launches.update(launches)
    log(f"[E] phase {time.time() - t_phase:.1f} s")


def path_rr(engine, index, dev, card, rec) -> None:
    """The learned re-ranker over the int8 path's engine: `distill_judge_aware`
    on the card (512 queries, top_m 20, 30 epochs, batch 32), then
    `query_batch(rerank=True)` at B=1024; the card's checkpoint restored on
    the CPU scores the same features within 1e-6; NDCG@10 against the
    teacher on 512 held-out queries, re-ranked and not (a report)."""
    import tempfile

    from hcrag_tpu_torch.models import reranker as rr
    from hcrag_tpu_torch.utils.timing import GLOBAL_TIMER

    t_phase = time.time()
    rng = np.random.default_rng(17)
    ids = rng.choice(N_ROWS, 2 * RR_QUERIES, replace=False)
    embs = index.emb[ids] + 0.05 * rng.standard_normal((len(ids), DIM)).astype(np.float32)
    texts = [index.texts[i] for i in ids]
    model = rr.Reranker(seed=0, device=dev)
    fit, train_s = model.fit_distill, []

    def timed_fit(*a, **k):  # the training loop's own time, query_batch apart
        t0 = time.perf_counter()
        out = fit(*a, **k)
        torch.cuda.synchronize()
        train_s.append(time.perf_counter() - t0)
        return out

    model.fit_distill = timed_fit
    zero_counts()
    t0 = time.perf_counter()
    out = rr.distill_judge_aware(engine, model, texts[:RR_QUERIES], embs[:RR_QUERIES],
                                 top_m=RR_TOP_M, epochs=RR_EPOCHS, seed=0)
    dt = time.perf_counter() - t0
    del model.fit_distill
    steps = RR_EPOCHS * -(-RR_QUERIES // RR_BATCH)
    losses = out["losses"]
    if len(losses) != RR_EPOCHS or not np.isfinite(losses).all():
        raise AssertionError(f"RR: losses {losses}")
    log(f"[RR] distill_judge_aware on the card: {RR_QUERIES} queries, top_m {RR_TOP_M}, "
        f"{RR_EPOCHS} epochs of batch {RR_BATCH} ({steps} steps) in {dt:.2f} s (host clock), "
        f"of which training {train_s[0]:.2f} s: {steps / train_s[0]:.1f} training steps/s; "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; {card}")
    q = _e_queries(E_BATCH)
    engine.set_reranker(model)
    try:
        engine.query_batch(q, top_k=TOP_K, rerank=True)  # first call
        GLOBAL_TIMER.reset()
        t0 = time.perf_counter()
        res = engine.query_batch(q, top_k=TOP_K, rerank=True)
        total = time.perf_counter() - t0
        stage = GLOBAL_TIMER.totals["query_batch/rerank"]
    finally:
        engine.set_reranker(None)
    plain = engine.query_batch(q, top_k=TOP_K)
    launches = read_counts()
    rec.launches["RR"] = launches
    check_result(plain, E_BATCH, N_ROWS)
    if res.rerank_scores is None or not (np.diff(res.rerank_scores, axis=1) <= 0).all() or \
            not np.array_equal(np.sort(res.top_indices, 1), np.sort(plain.top_indices, 1)):
        raise AssertionError("RR: the re-ranked result is not its top-k ordered by its scores")
    log(f"[RR] query_batch(rerank=True) B={E_BATCH}: {total * 1e3:.1f} ms (host clock), "
        f"the re-rank stage {stage * 1e3:.1f} ms ({100 * stage / total:.1f}%); launches "
        f"during the phase {launches}; {card}")
    with tempfile.TemporaryDirectory() as tmp:
        model.save(f"{tmp}/reranker.npz", step=steps)
        host = rr.Reranker(seed=5, device="cpu")
        if host.restore(f"{tmp}/reranker.npz") != steps:
            raise AssertionError("RR: the checkpoint's step did not round-trip")
    feats = out["features"][:64]
    err = float(np.abs(host.score(feats) - model.score(feats)).max())
    if not err <= 1e-6:
        raise AssertionError(f"RR: the card's checkpoint scores {err} away on the CPU")
    held = rr.distill_judge_aware(engine, rr.Reranker(seed=1, device=dev), texts[RR_QUERIES:],
                                  embs[RR_QUERIES:], top_m=RR_TOP_M, epochs=0)
    plain = rr.ndcg_at_k(np.tile(np.arange(RR_TOP_M), (RR_QUERIES, 1)), held["labels"], 10)
    order = np.argsort(-model.score(held["features"]), axis=1, kind="stable")
    learned = rr.ndcg_at_k(order, held["labels"], 10)
    log(f"[RR] the card's checkpoint restored on the CPU: scores within {err:.3g} (gate "
        f"1e-6); NDCG@10 against the teacher on {RR_QUERIES} held-out queries (no gate): "
        f"engine order {plain:.4f}, re-ranked {learned:.4f}")
    log(f"[RR] phase {time.time() - t_phase:.1f} s")




def path_f2(index, graph, queries, ref, dev, card, rec) -> None:
    """bench.py's bf16 mode: B5 over a bf16 bank, B2, the f32 rescore,
    B=8192."""
    opts = dict(exact_rescore=RESCORE, select_lane_t=1)
    engine = engine_ready("F2", index, graph, dev, BATCH, **opts)
    drive(engine, queries, ("float_packed_tile_topk", "packed_candidate_merge"), "F2",
          ref, rec)
    check_small_against_cpu(dev, "F2", dict(ell_max_degree=8, **opts))
    dq = torch.from_numpy(queries).to(dev)
    time_step(engine, dq, "F2", card, reps=3)
    kv, ki = b5_at_path(engine, dq, "F2", card, rec)
    merge_at_path(kv, ki, RESCORE, "F2", card, rec)


def b5_at(qb, e, mask, k, label, card, rec, reps=2):
    """B5 on these operands (bf16 queries and bank) against its plain
    version by `testing.py`'s rule, then its time beside the plain
    version's and its bound; returns its candidates."""
    from hcrag_tpu_torch.ops import topk_cuda as tc
    from hcrag_tpu_torch.testing import check_packed_topk

    (b, d), n_bank = qb.shape, e.shape[0]
    kv, ki = tc.float_packed_tile_topk(qb, e, mask, k)
    pv, pi = tc.float_packed_tile_topk_plain(qb, e, mask, k)
    err, moved = check_packed_topk(kv, ki, pv, pi, qb, e)
    rec.err("float_packed_tile_topk", err)
    log(f"[{label}] B5 at the path's shapes: agrees with its plain version "
        f"(max |err| {err:.3g}, {moved} of {kv.shape[0] * kv.shape[1]} tiles next to "
        f"a key-quantum boundary)")
    del pv, pi
    b5_ms = cuda_ms(lambda: tc.float_packed_tile_topk(qb, e, mask, k), reps=reps)
    b5_plain_ms = cuda_ms(lambda: tc.float_packed_tile_topk_plain(qb, e, mask, k),
                          reps=1, warmup=0)
    tiles = kv.shape[1]
    b5_bytes = 2 * qb.numel() + 2 * e.numel() + mask.numel() + 8 * kv.numel()
    b5_bound = bound_ms(2.0 * b * n_bank * d, "bf16", b5_bytes)
    log(f"[{label}] B5 float_packed_tile_topk B={b} N={n_bank} tiles={tiles} k={k} bf16: "
        f"{b5_ms:.3f} ms (plain {b5_plain_ms:.3f} ms, bound {b5_bound[0]:.3f} ms by "
        f"{b5_bound[1]}; {card})")
    rec.kernel("float_packed_tile_topk", label, b5_ms, b5_plain_ms, b5_bound)
    return kv, ki


def b5_at_path(engine, dq, label, card, rec):
    """B5 at the path's shapes (the engine's bf16 bank, queries `dq`, the
    rescore's merge_k; `b5_at`); returns its candidates."""
    from hcrag_tpu_torch.ops import topk_cuda as tc

    e = engine.d_emb
    mask = path_mask(e.shape[0], engine._n_rows, dq.device)
    k = tc.tile_pick_count(TOP_K, e.shape[0], 2048, RESCORE)
    return b5_at(dq.to(torch.bfloat16), e, mask, k, label, card, rec)


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
    vals, idxs, k_sub = super_at_path(engine, dq, kernel, label, card, rec)
    merge_at_path(vals, idxs, min(RESCORE, vals.shape[1] * k_sub), label, card, rec)


def super_at_path(engine, dq, kernel, label, card, rec):
    """The engine's B7 kernel at the path's shapes (its resolved supertile
    and per-supertile k) against its plain version (B7i bit for bit, B7f by
    `testing.py`'s rule for the supertile's lane field), then its time
    beside the plain version's and its bound; returns (values, indices,
    k_sub)."""
    from hcrag_tpu_torch.ops import topk_cuda as tc
    from hcrag_tpu_torch.ops.quantize import quantize_queries
    from hcrag_tpu_torch.testing import check_packed_topk

    b = dq.shape[0]
    cfg = engine.resolved_kernel_config(b, TOP_K)
    lbits, k_sub = cfg["tile_n"] * cfg["super_tiles"], cfg["tile_k"]
    bank = engine._bank()
    int8 = engine.quantize_int8
    e = bank["emb_int8"] if int8 else bank["emb"]
    n_bank = e.shape[0]
    mask = path_mask(n_bank, engine._n_rows, dq.device)
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
    return vals, idxs, k_sub


def path_x(index, queries, dev, card, rec):
    """The expansion-heavy deployment: top_k=100, depth 3, B=256 over the
    1M rows with a degree-8 graph, `exact_rescore=32` (B5 at per-tile k =
    100, B2 over 489 x 100 -> 100); then the breakdown that the JAX repo's
    `benchmarks/expansion_heavy.py` records, each part held against the CPU
    on a few rows, and B5 and B2 at the path's shapes.  Returns the graph
    (path BM's expansion script runs over it)."""
    from hcrag_tpu_torch.ops import expand as ex
    from hcrag_tpu_torch.ops import topk_cuda as tc
    from hcrag_tpu_torch.query.engine import QueryEngine
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
    k = tc.tile_pick_count(X_TOP_K, e.shape[0], 2048, 0)
    kv, ki = b5_at(dq.to(torch.bfloat16), e, path_mask(e.shape[0], N_ROWS, dev), k, "X",
                   card, rec, reps=3)
    merge_at_path(kv, ki, X_TOP_K, "X", card, rec)
    return graph


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
    b4_at_path(engine, dq, "F1", card, rec)
    return engine


def b4_at(q, e, mask, label, card, rec, k=TOP_K, reps=3) -> None:
    """B4 on these operands (f32, or bf16 queries and bank) against its
    plain version by `testing.check_exact_topk`, then its time beside the
    plain version's, its bound and the dots alone."""
    from hcrag_tpu_torch.ops import topk_cuda as tc
    from hcrag_tpu_torch.testing import check_exact_topk

    (b, d), n_bank = q.shape, e.shape[0]
    kv, ki = tc.float_tile_topk(q, e, mask, k)
    pv, pi = tc.float_tile_topk_plain(q, e, mask, k)
    err, moved = check_exact_topk(kv, ki, pv, pi, q, e, mask)
    rec.err("float_tile_topk", err)
    log(f"[{label}] B4 at the path's shapes: agrees with its plain version "
        f"(max |err| {err:.3g}, {moved} indices at near-ties)")
    b4_ms = cuda_ms(lambda: tc.float_tile_topk(q, e, mask, k), reps=reps)
    b4_plain_ms = cuda_ms(lambda: tc.float_tile_topk_plain(q, e, mask, k), reps=1)
    # The yardstick: the same dots alone, one [B, N] product (in full f32
    # for an f32 bank: TF32 is off), not the same function.
    dots_ms = cuda_ms(lambda: torch.matmul(q, e.T), reps=3)
    tiles = kv.shape[1]
    nbytes = (q.element_size() * q.numel() + e.element_size() * e.numel() + mask.numel()
              + 8 * kv.numel())
    # The peak of the operands' type: bf16 queries and bank take the bf16
    # rate, though B4 sums them in f32 on the CUDA cores.
    kind = "bf16" if q.dtype == e.dtype == torch.bfloat16 else "f32"
    b4_bound = bound_ms(2.0 * b * n_bank * d, kind, nbytes)
    log(f"[{label}] B4 float_tile_topk B={b} N={n_bank} tiles={tiles} k={k} {e.dtype}: "
        f"{b4_ms:.3f} ms (plain {b4_plain_ms:.3f} ms, bound {b4_bound[0]:.3f} ms by "
        f"{b4_bound[1]}; dots alone, not the same function: torch.matmul "
        f"{dots_ms:.3f} ms; launches on the path "
        f"{rec.launches.get(label, {}).get('float_tile_topk')}; {card})")
    rec.kernel("float_tile_topk", label, b4_ms, b4_plain_ms, b4_bound, dots_alone_ms=dots_ms)


def b4_at_path(engine, dq, label, card, rec, category_filter=None) -> None:
    """B4 at the path's shapes (the engine's f32 bank, queries `dq`, the
    mask of `category_filter` where one is given; `b4_at`)."""
    e = engine.d_emb
    mask = path_mask(e.shape[0], engine._n_rows, dq.device)
    if category_filter:
        mask[:engine._n_rows] = engine._type_mask(category_filter)
    b4_at(dq, e, mask, label, card, rec)


def _agent_questions(graph, seed: int, index):
    """Texts of two rows the agent samples (each passes the semantic gate on
    its own node through `RowLookupEmbedder`), and one that names none."""
    import random

    rng = random.Random(seed)
    ids = [rng.randint(0, graph.num_nodes - 1) for _ in range(20)]
    return [index.texts[int(graph.node_to_row[ids[0]])],
            index.texts[int(graph.node_to_row[ids[7]])], "completely absurd query zzzxqwy"]


def run_pipelines(engine, graph, index, tmp: str, timed=None) -> dict:
    """Every pipeline over `engine` with the offline client and seed
    A_SEED; returns what the card-vs-CPU check compares.  `timed(label,
    fn)` wraps each call (the phase times them)."""
    from hcrag_tpu_torch import config as cfg
    from hcrag_tpu_torch.pipeline.agent import RetrievalAgent
    from hcrag_tpu_torch.pipeline.enhanced import EnhancedRAG
    from hcrag_tpu_torch.pipeline.improved_agent import ImprovedRetrievalAgent, MemorySaver
    from hcrag_tpu_torch.pipeline.integration import GraphRelevanceScorer
    from hcrag_tpu_torch.pipeline.llm import LLMClient
    from hcrag_tpu_torch.query.graph_query import answer_graph_question
    from hcrag_tpu_torch.query.interface import QueryInterface

    timed = timed or (lambda label, fn: fn())
    conf = cfg.RuntimeConfig(random_seed=A_SEED, llm_base_url="")
    client = LLMClient(conf)
    out = {"agent": []}
    questions = _agent_questions(graph, A_SEED, index)
    agent = RetrievalAgent(engine, client=client, config=conf)
    out["sampled"] = agent.sample_nodes({})["sampled_nodes"]
    for i, question in enumerate(questions):
        r = timed(f"RetrievalAgent.run(question {i})", lambda: agent.run(question))
        if r.node_trace[-1] != "generate_answer" or not r.final_answer:
            raise AssertionError(f"A: agent run {i} did not answer")
        if i < 2:
            # The scoring stage's fallback keeps the top-5 semantic nodes and
            # sets no expanded scored nodes; batch_isRelevant scores all.
            n_all = len(r.semantic_scored_nodes) + len(r.expanded_scored_nodes)
            if not r.expanded_scored_nodes or len(r.final_relevant_nodes) != min(15, n_all):
                raise AssertionError(f"A: agent run {i} took the scoring fallback")
        out["agent"].append((r.node_trace, [n.text for n in r.final_relevant_nodes],
                             [n.score for n in r.final_relevant_nodes]))
    saver = MemorySaver(persist_dir=f"{tmp}/journal")
    improved = ImprovedRetrievalAgent(engine, client=client, config=conf, checkpointer=saver)
    ri = timed("ImprovedRetrievalAgent.run", lambda: improved.run(
        questions[1], thread_id="smoke", user_id="u"))
    resumed = MemorySaver(persist_dir=f"{tmp}/journal")
    if resumed.latest("smoke")["node"] != "generate_answer" or \
            len(resumed.get("smoke")) != len(ri.node_trace) or not ri.expanded_scored_nodes:
        raise AssertionError("A: the improved agent's journal did not resume")
    out["improved"] = (ri.node_trace, [n.score for n in ri.final_relevant_nodes])
    rag = timed("EnhancedRAG.query (first: builds the metadata-id map)",
                lambda: EnhancedRAG(engine, client=client).query(questions[0], top_k=5))
    rag = timed("EnhancedRAG.query", lambda: EnhancedRAG(engine, client=client).query(
        questions[0], top_k=5))
    if "error" in rag.metadata or not rag.context_used:
        raise AssertionError(f"A: EnhancedRAG failed: {rag.metadata}")
    out["rag"] = ([c["content"] for c in rag.context_used], rag.relevance_scores)
    grs = timed("GraphRelevanceScorer.score_query_against_graph",
                lambda: GraphRelevanceScorer(engine, client=client).score_query_against_graph(
                    questions[0], top_k=5))
    if "error" in grs or not grs["nodes_found"]:
        raise AssertionError(f"A: GraphRelevanceScorer failed: {grs.get('error')}")
    out["grs"] = {k: [s["relevance_score"] for s in v] for k, v in grs["results"].items()}
    iface = timed("QueryInterface(...) (token table)",
                  lambda: QueryInterface(engine, llm=client))
    out["iface"] = {}
    for mode in ("vector", "keyword", "context", "default", "auto"):
        r = timed(f"QueryInterface.query(mode={mode})", lambda: iface.query(questions[0], mode))
        if r["answer"].startswith("Query failed") or not r["metadata"].get("results"):
            raise AssertionError(f"A: QueryInterface mode {mode} failed: {r['answer']}")
        out["iface"][mode] = [(h["content"], h["similarity_score"])
                              for h in r["metadata"]["results"]]
    g = timed("answer_graph_question", lambda: answer_graph_question(
        graph, "Show products for n12", client))
    if not g["match_count"]:
        raise AssertionError("A: answer_graph_question matched nothing")
    out["graph"] = g["matches"]
    return out


def path_a(engine, index, graph, dev, card, rec) -> None:
    """The agents and pipelines over F1's engine (f32, 1M rows; B4 in
    `process_query`), with `RowLookupEmbedder` so questions naming a row
    find it: each call's host time and B4 launches; no fallback taken.
    Then the same runs over a 20,000-row engine on the card and on the CPU
    must agree."""
    import tempfile

    from hcrag_tpu_torch.ops import topk_cuda as tc
    from hcrag_tpu_torch.query.engine import QueryEngine
    from hcrag_tpu_torch.testing import RowLookupEmbedder
    from hcrag_tpu_torch.utils.synthetic import synthetic_setup

    t_phase = time.time()
    engine.attach_device_encoder(RowLookupEmbedder(index))

    def timed(label, fn):
        b4 = tc.float_tile_topk.launches
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        log(f"[A] {label}: {(time.perf_counter() - t0) * 1e3:.1f} ms (host clock), "
            f"B4 launches {tc.float_tile_topk.launches - b4}")
        return out

    zero_counts()
    b4 = tc.float_tile_topk.launches
    out = engine.process_query(index.texts[4321], top_k=TOP_K)
    if tc.float_tile_topk.launches - b4 != 1 or out["results"][0]["content"] != index.texts[4321]:
        raise AssertionError("A: process_query did not launch B4 once or find its row")
    with tempfile.TemporaryDirectory() as tmp:
        run_pipelines(engine, graph, index, tmp, timed)
    rec.launches["A"] = read_counts()
    log(f"[A] launches over the phase {rec.launches['A']}; {card}")

    small_index, small_graph = synthetic_setup(A_SMALL_ROWS, DIM, graph_degree=4)
    got = []
    for d in (dev, "cpu"):
        eng = QueryEngine(small_index, small_graph, device=d, ell_max_degree=8,
                          embedder=RowLookupEmbedder(small_index))
        with tempfile.TemporaryDirectory() as tmp:
            got.append(run_pipelines(eng, small_graph, small_index, tmp))
    compare_pipelines(*got)
    log(f"[A] {A_SMALL_ROWS:,}-row engine: card == CPU (node traces, sampled ids, final "
        f"node order, every score within 1e-5) over the agent, the improved agent, "
        f"EnhancedRAG, GraphRelevanceScorer, five QueryInterface modes and a graph query")
    log(f"[A] phase {time.time() - t_phase:.1f} s")


def compare_pipelines(card, cpu) -> None:
    def close(a, b, what):
        if len(a) != len(b) or (len(a) and float(np.abs(np.subtract(a, b)).max()) > 1e-5):
            raise AssertionError(f"A: card and CPU differ in {what}")

    if card["sampled"] != cpu["sampled"]:
        raise AssertionError("A: card and CPU sampled other ids")
    for (tg, ng, sg), (tc_, nc, sc) in zip(card["agent"], cpu["agent"]):
        if tg != tc_ or ng != nc:
            raise AssertionError("A: card and CPU agent traces or node orders differ")
        close(sg, sc, "agent scores")
    if card["improved"][0] != cpu["improved"][0]:
        raise AssertionError("A: improved agent traces differ")
    close(card["improved"][1], cpu["improved"][1], "improved agent scores")
    if card["rag"][0] != cpu["rag"][0]:
        raise AssertionError("A: EnhancedRAG contexts differ")
    close(card["rag"][1], cpu["rag"][1], "EnhancedRAG scores")
    for k in cpu["grs"]:
        close(card["grs"][k], cpu["grs"][k], f"GraphRelevanceScorer {k}")
    for mode, hits in cpu["iface"].items():
        if [h[0] for h in card["iface"][mode]] != [h[0] for h in hits]:
            raise AssertionError(f"A: QueryInterface {mode} hits differ")
        close([h[1] for h in card["iface"][mode]], [h[1] for h in hits], f"QueryInterface {mode}")
    if card["graph"] != cpu["graph"]:
        raise AssertionError("A: graph query matches differ")


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
    tok = enc.tokenizer
    if tok._native_tokenizer() is None:
        raise AssertionError("M: the native WordPiece tokenizer did not build")
    t0 = time.perf_counter()
    ids_n, mask_n = tok.encode_batch(texts, max_len=64)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ids_p, mask_p = tok._encode_batch_py(texts, 64)
    py_s = time.perf_counter() - t0
    if not (np.array_equal(ids_n, ids_p) and np.array_equal(mask_n, mask_p)):
        raise AssertionError("M: native and Python WordPiece ids differ")
    log(f"[M] WordPiece on {M_TEXTS} texts at max_len 64: native {M_TEXTS / native_s:.0f} "
        f"texts/s, Python {M_TEXTS / py_s:.0f} texts/s (host clock), ids equal")
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
    log(f"[{label}] B6 batch_relevance {shape} W={w} ({plan.regime}, {plan.queries} queries a "
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
    b3e_at(q8, qs, e8, es, mask, TOP_K, "D1x", card, rec, dots_chunk=1_000_000)


def b3e_at(q8, qs, e8, es, mask, k, label, card, rec, dots_chunk=0) -> None:
    """B3e on these operands against its plain version (bit for bit), then
    its time beside the plain version's and its bound; with `dots_chunk`,
    also the same int8 dots alone as a yardstick."""
    from hcrag_tpu_torch.ops import topk_cuda as tc

    (b, d), n_bank = q8.shape, e8.shape[0]
    kv, ki = tc.int8_exact_tile_topk(q8, qs, e8, es, mask, k)
    rec.err("int8_exact_tile_topk",
            same_bits(kv, ki, *tc.int8_exact_tile_topk_plain(q8, qs, e8, es, mask, k)))
    tiles = kv.shape[1]
    del kv, ki
    ms = cuda_ms(lambda: tc.int8_exact_tile_topk(q8, qs, e8, es, mask, k), reps=2)
    plain_ms = cuda_ms(lambda: tc.int8_exact_tile_topk_plain(q8, qs, e8, es, mask, k),
                       reps=1, warmup=0)
    dots_ms, dots = None, ""
    if dots_chunk:
        # The yardstick: the same int8 dots alone, torch._int_mm in row
        # chunks (the [B, N] int32 product would not fit), not the same
        # function.
        def int8_dots():  # each chunk's product is dropped before the next
            for lo in range(0, n_bank, dots_chunk):
                torch._int_mm(q8, e8[lo:lo + dots_chunk].T)

        dots_ms = cuda_ms(int8_dots, reps=1)
        dots = (f"; dots alone, not the same function: torch._int_mm in {dots_chunk}-row "
                f"chunks {dots_ms:.3f} ms")
    nbytes = (q8.numel() + 4 * qs.numel() + e8.numel() + 4 * es.numel() + mask.numel()
              + 8 * b * tiles * k)
    bound = bound_ms(2.0 * b * n_bank * d, "int8", nbytes)
    log(f"[{label}] B3e int8_exact_tile_topk B={b} N={n_bank} tiles={tiles} k={k}: "
        f"bit-equal to its plain version; {ms:.3f} ms (plain {plain_ms:.3f} ms, bound "
        f"{bound[0]:.3f} ms by {bound[1]}{dots}; launches on the path "
        f"{rec.launches[label]['int8_exact_tile_topk']}; {card})")
    rec.kernel("int8_exact_tile_topk", label, ms, plain_ms, bound, dots_alone_ms=dots_ms)


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
    # loop that B8a-c split; its bound at the bf16 rate of its operands),
    # against its plain version.
    from hcrag_tpu_torch.testing import check_exact_topk

    mask = torch.ones(n, dtype=torch.bool, device=dev)
    kv, ki = tc.float_tile_topk(qb, e, mask, TOP_K)
    err, moved = check_exact_topk(kv, ki, *tc.float_tile_topk_plain(qb, e, mask, TOP_K),
                                  qb, e, mask)
    rec.err("float_tile_topk", err)
    del kv, ki
    b4_ms = cuda_ms(lambda: tc.float_tile_topk(qb, e, mask, TOP_K), reps=3)
    plain_ms = cuda_ms(lambda: tc.float_tile_topk_plain(qb, e, mask, TOP_K), reps=1)
    bound = bound_ms(2.0 * b * n * DIM, "bf16", 2 * qb.numel() + 2 * e.numel() + n
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


# ---------------------------------------------------------------------------
# The offline build path: corpus -> graph + index -> CLI and engine
# ---------------------------------------------------------------------------

B_QUERY = "mountain bike frame"
B_SCALE_QUERIES = 1024  # path B at scale: the index's own texts, encoded


def run_cli_group(commands, label: str, timeout: float = 300.0,
                  module: str = "hcrag_tpu_torch.cli") -> None:
    """Run `python -m <module> <args>` (the CLI by default) for each
    argument list at once, each on its default device, the card; every one
    must exit 0.  With `module=None` each list starts with its module."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.time()
    commands = [[module, *args] if module else args for args in commands]
    procs = [(args, subprocess.Popen(
        [sys.executable, "-m", *args], cwd=root, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)) for args in commands]
    failed = []
    for args, proc in procs:
        try:
            out, err = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
        lines = out.strip().splitlines()
        name = " ".join(a.rsplit(".", 1)[-1] for a in args[:2])
        log(f"[{label}] {name}: exit {proc.returncode}; "
            f"{len(lines)} lines; first: {lines[0][:150] if lines else ''!r}")
        if proc.returncode != 0:
            failed.append((name, err[-2000:]))
    log(f"[{label}] {len(commands)} processes in {time.time() - t0:.1f} s (wall, in parallel)")
    if failed:
        raise AssertionError(f"{label}: commands failed: {failed}")


def same_results(got, want, label: str, atol: float = 1e-5) -> None:
    """Two `process_query` outputs: the same rows in the same order,
    similarity scores within `atol`."""
    gr = [r["metadata"]["id"] for r in got["results"]]
    wr = [r["metadata"]["id"] for r in want["results"]]
    if gr != wr:
        raise AssertionError(f"{label}: rows {gr} != {wr}")
    diff = max((abs(a["similarity_score"] - b["similarity_score"])
                for a, b in zip(got["results"], want["results"])), default=0.0)
    if not diff <= atol:
        raise AssertionError(f"{label}: scores differ by {diff} > {atol}")


def same_batch(got, want, label: str, atol: float = 1e-5) -> None:
    """Two `query_batch` results: integer fields equal, float fields
    within `atol` (0.0: equal)."""
    for f in ("top_indices", "expanded_nodes", "expanded_counts"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f"{label} {f}")
    for f in ("top_scores", "relevance", "combined", "expanded_relevance"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f), atol=atol, rtol=0,
                                   err_msg=f"{label} {f}")


def path_b(dev, card, rec, tmp: str) -> None:
    """Path B: the reference-sized corpus (written from a seed) through the
    CLI on the card, `build` and `extract-graph` first, then `stats`,
    `query`, `viz` and `graph-html` over the saved artifacts; then in this
    process `build_adventureworks` and the default engine on the card:
    `process_query` launches B4 once a call and equals the same engine on
    the CPU; the artifacts reloaded give the same results."""
    from hcrag_tpu_torch.core.dense_index import DenseIndex
    from hcrag_tpu_torch.core.graph import CsrGraph
    from hcrag_tpu_torch.ingest.adventureworks import build_adventureworks
    from hcrag_tpu_torch.query.engine import QueryEngine
    from hcrag_tpu_torch.testing import REFERENCE_ROWS, write_adventureworks_corpus

    data = write_adventureworks_corpus(f"{tmp}/b_corpus", seed=0, rows=REFERENCE_ROWS)
    art = f"{tmp}/b_artifacts"
    run_cli_group([["build", "--data", str(data), "--out", art],
                   ["extract-graph", "--data", str(data), "--out", f"{tmp}/b_extract"]], "B")
    run_cli_group([["stats", "--artifacts", art],
                   ["query", B_QUERY, "--artifacts", art, "--threshold", "0.0"],
                   ["viz", B_QUERY, "--artifacts", art, "--out", f"{tmp}/b_viz.html"],
                   ["graph-html", "--artifacts", art, "--out", f"{tmp}/b_kg.html"]], "B")

    t0 = time.time()
    bundle = build_adventureworks(data)
    build_s = time.time() - t0
    engine = QueryEngine(bundle.index, bundle.graph, device=dev)
    cpu = QueryEngine(bundle.index, bundle.graph, device="cpu")
    log(f"[B] build_adventureworks: {bundle.index.n} rows x {bundle.index.dim}, graph "
        f"{bundle.graph.statistics()['nodes']}, {bundle.graph.num_edges} directed edges, "
        f"{build_s:.2f} s (host)")
    questions = [B_QUERY, "red helmet", "Jersey Care Guide sizes", bundle.index.texts[7]]
    zero_counts()
    outs = [engine.process_query(q, top_k=TOP_K, similarity_threshold=0.0) for q in questions]
    rec.launches["B"] = read_counts()
    if rec.launches["B"]["float_tile_topk"] != len(questions):
        raise AssertionError(f"B: {len(questions)} process_query calls launched B4 "
                             f"{rec.launches['B']['float_tile_topk']} times")
    for q, out in zip(questions, outs):
        same_results(out, cpu.process_query(q, top_k=TOP_K, similarity_threshold=0.0),
                     f"B card vs CPU {q[:30]!r}")
    if not all(out["results"] for out in outs):
        raise AssertionError("B: a process_query call found nothing at threshold 0")
    log(f"[B] process_query x{len(questions)} on the card: B4 once a call "
        f"(launches {rec.launches['B']}); card == CPU (rows exact, scores within 1e-5); "
        f"{outs[0]['summary']}")
    loaded = QueryEngine(DenseIndex.load(art), CsrGraph.load(art), device=dev)
    for q, out in zip(questions, outs):
        same_results(loaded.process_query(q, top_k=TOP_K, similarity_threshold=0.0), out,
                     f"B reloaded {q[:30]!r}", atol=0.0)
    log(f"[B] the CLI's saved artifacts reloaded: the same results as the in-memory "
        f"bundle; {card}")


def path_b_scale(dev, card, rec, tmp: str) -> None:
    """Path B at scale: the same schema with the order and catalogue tables
    at the AdventureWorks OLTP sample's row counts; the graph index build
    timed by stage (host clock), then 1024 of the index's own texts through
    the default engine (B4) and the int8 + f32 rescore engine (B1; the pool
    of 76 tiles x 10 is under B2's 4096 candidates), recall@10 against f32
    brute force and ms per step by CUDA events."""
    from hcrag_tpu_torch import native
    from hcrag_tpu_torch.core.dense_index import DenseIndex
    from hcrag_tpu_torch.core.graph import CsrGraph
    from hcrag_tpu_torch.ingest import adventureworks as aw
    from hcrag_tpu_torch.models.embedder import HashingEmbedder, embedder_from_index
    from hcrag_tpu_torch.query.engine import QueryEngine
    from hcrag_tpu_torch.testing import OLTP_ROWS, check_exact_topk, write_adventureworks_corpus

    t0 = time.time()
    data = write_adventureworks_corpus(f"{tmp}/bs_corpus", seed=1, rows=OLTP_ROWS)
    log(f"[Bs] corpus written in {time.time() - t0:.1f} s (host): {OLTP_ROWS}")
    if not native.available():
        raise AssertionError("Bs: the native host library did not build")
    stages = {}

    def stage(name, fn):
        t = time.perf_counter()
        out = fn()
        stages[name] = time.perf_counter() - t
        return out

    csv_data = stage("load_csv", lambda: aw.load_csv_data(data))
    docs = stage("documents", lambda: aw.analyze_ingested_documents(data))
    graph = stage("build_graph", lambda: aw.build_graph(csv_data, docs))
    texts, metadata = stage("process_corpus", lambda: aw.process_corpus(data))
    embedder = HashingEmbedder()
    emb = stage("embed", lambda: embedder.fit(texts).encode(texts))
    graph_ids, node_to_row = stage("link", lambda: aw.link_index_and_graph(metadata, graph))
    graph.node_to_row = node_to_row
    info = {"embedder_state": embedder.state_dict(), "model_name": "HashingEmbedder.encode",
            "total_entries": len(texts), "embedding_dimension": int(emb.shape[1])}
    index = stage("DenseIndex.build", lambda: DenseIndex.build(
        emb, metadata, texts, graph_ids=graph_ids, generation_info=info))

    def save_load():
        index.save(f"{tmp}/bs_artifacts")
        graph.save(f"{tmp}/bs_artifacts")
        return DenseIndex.load(f"{tmp}/bs_artifacts"), CsrGraph.load(f"{tmp}/bs_artifacts")

    index, graph = stage("save+load", save_load)

    def engine_on_card():
        e = QueryEngine(index, graph, device=dev)
        torch.cuda.synchronize()
        return e

    engine = stage("engine on the card", engine_on_card)
    total = sum(stages.values())
    log(f"[Bs] graph index build time {total:.3f} s (host clock) for {index.n} rows x "
        f"{index.dim}, {graph.num_nodes} graph nodes, {graph.num_edges} directed edges "
        f"({graph.statistics()['relationships']}); peak host RSS {host_rss_gib():.2f} GiB; {card}")
    for name, sec in stages.items():
        log(f"[Bs]   {name:20s} {sec:8.3f} s  {100 * sec / total:5.1f}%")
    log(f"[Bs]   embedding: {len(texts) / stages['embed']:.0f} texts/s (native fit + encode)")

    rng = np.random.default_rng(3)
    rows = np.sort(rng.choice(index.n, size=B_SCALE_QUERIES, replace=False))
    q_texts = [index.texts[int(r)] for r in rows]
    queries = embedder_from_index(index).encode(q_texts).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    d_emb = torch.from_numpy(np.asarray(index.emb, np.float32)).to(dev)
    dq = torch.from_numpy(queries).to(dev)
    s = dq @ d_emb.T
    order = torch.sort(s, dim=1, descending=True, stable=True).indices[:, :TOP_K]
    ref_v, ref_i = s.gather(1, order), order
    del s

    zero_counts()
    res = engine.query_batch(queries, top_k=TOP_K)
    rec.launches["Bs"] = read_counts()
    if rec.launches["Bs"]["float_tile_topk"] != 1:
        raise AssertionError(f"Bs: query_batch launched B4 "
                             f"{rec.launches['Bs']['float_tile_topk']} times, not once")
    check_result(res, B_SCALE_QUERIES, index.n)
    mask = torch.ones(index.n, dtype=torch.bool, device=dev)
    err, moved = check_exact_topk(
        torch.from_numpy(res.top_scores).to(dev), torch.from_numpy(res.top_indices).to(dev),
        ref_v, ref_i, dq, d_emb, mask)
    r = recall(ref_i.cpu().numpy(), res.top_indices)
    step_ms = cuda_ms(lambda: engine.query_batch_device(dq, top_k=TOP_K), reps=5)
    log(f"[Bs] default engine (B4): recall@10 {r:.4f} against f32 brute force over "
        f"{B_SCALE_QUERIES} queries; equal to brute force by testing.check_exact_topk "
        f"(max |err| {err:.3g}, {moved} indices at near-ties); step {step_ms:.3f} ms "
        f"(CUDA events, B={B_SCALE_QUERIES}); launches {rec.launches['Bs']}; {card}")
    b4_at_path(engine, dq, "Bs", card, rec)
    del engine
    free("Bs default engine")

    opts = dict(quantize_int8=True, int8_rescore=RESCORE, int8_f32_rescore=True)
    engine = QueryEngine(index, graph, device=dev, **opts)
    zero_counts()
    res8 = engine.query_batch(queries, top_k=TOP_K)
    rec.launches["Bs8"] = read_counts()
    if rec.launches["Bs8"]["int8_tile_topk"] != 1 or rec.launches["Bs8"]["packed_candidate_merge"]:
        raise AssertionError(f"Bs8: launches {rec.launches['Bs8']}: B1 once and no B2 "
                             "(a pool under 4096 candidates) expected")
    check_result(res8, B_SCALE_QUERIES, index.n)
    cpu8 = QueryEngine(index, graph, device="cpu", **opts).query_batch(queries[:64], top_k=TOP_K)
    card8 = engine.query_batch(queries[:64], top_k=TOP_K)
    same_batch(card8, cpu8, "Bs8 card vs CPU")
    r8 = recall(ref_i.cpu().numpy(), res8.top_indices)
    step8_ms = cuda_ms(lambda: engine.query_batch_device(dq, top_k=TOP_K), reps=5)
    log(f"[Bs8] int8 + f32 rescore engine (B1): recall@10 {r8:.4f} against f32 brute force "
        f"over {B_SCALE_QUERIES} queries (no gate: a finding); card == CPU plain route on 64 "
        f"queries; step {step8_ms:.3f} ms (CUDA events); launches {rec.launches['Bs8']}; {card}")
    int8_kernels_at_path(engine, dq, "Bs8", card, rec, RESCORE, with_merge=False)
    del engine, d_emb, dq


def path_g(dev, card, rec, tmp: str) -> None:
    """Path G: the offline path-extraction graph over the reference-sized
    corpus (`PropertyGraphBuilder("auto")`), `build_graph_index`, the
    default engine on the card over it and `query_batch` with expansion
    (B4 once), equal to the CPU engine."""
    from hcrag_tpu_torch.ingest.path_extract import PropertyGraphBuilder, build_graph_index
    from hcrag_tpu_torch.query.engine import QueryEngine

    data = f"{tmp}/b_corpus"  # path B's
    t0 = time.perf_counter()
    store = PropertyGraphBuilder("auto").build(data)
    extract_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    index, csr, names = build_graph_index(store)
    index_s = time.perf_counter() - t0
    log(f"[G] PropertyGraphBuilder('auto'): {store.num_nodes} nodes, {store.num_triples} "
        f"triples, {len(names)} relation types in {extract_s:.2f} s; build_graph_index: "
        f"{index.n} rows x {index.dim} in {index_s:.2f} s (host)")
    engine = QueryEngine(index, csr, device=dev)
    rng = np.random.default_rng(4)
    rows = rng.choice(index.n, size=64, replace=False)
    queries = np.asarray(index.emb, np.float32)[rows]
    zero_counts()
    res = engine.query_batch(queries, top_k=TOP_K, expansion_depth=1)
    rec.launches["G"] = read_counts()
    if rec.launches["G"]["float_tile_topk"] != 1:
        raise AssertionError(f"G: launches {rec.launches['G']}")
    check_result(res, len(rows), index.n)
    if (res.top_scores[:, 0] < 1 - 1e-5).any() or not res.expanded_counts.any():
        raise AssertionError("G: a node's own row did not score 1 first, or nothing "
                             "was expanded")
    same_batch(res, QueryEngine(index, csr, device="cpu").query_batch(
        queries, top_k=TOP_K, expansion_depth=1), "G card vs CPU")
    log(f"[G] query_batch B=64 depth 1 on the card: B4 once (launches {rec.launches['G']}), "
        f"{int(res.expanded_counts.sum())} nodes expanded; card == CPU; {card}")


def path_ex(tmp: str) -> None:
    """Path EX: the port's three examples on the card as subprocesses, at
    once, `end_to_end` and `path_extraction` over path B's corpus; each
    must exit 0."""
    data = f"{tmp}/b_corpus"  # path B's
    run_cli_group([[f"hcrag_tpu_torch.examples.{name}"]
                   + ([] if name == "configurable_weights" else [data])
                   for name in EXAMPLES], "EX", module=None)


T_BATCH, T_MAX_LEN, T_STEPS, T_CHUNK, T_LR = 128, 192, 200, 50, 4e-4  # path T
T_RESUME_AT, T_HOLDOUT_STEPS, T_TIMED_STEPS = 100, 100, 10
T_PARITY = dict(rows=64, steps=3, batch=8, max_len=64)  # path T-parity, card vs CPU
# An interrupted and resumed run against the uninterrupted one: bit-equal
# parameters, and output embeddings equal up to this (far below the
# training's own movement, ~1e-1 a chunk).
T_RESUME_TOL = 1e-4
T_PARITY_LOSS_RTOL, T_PARITY_EMB_TOL = 1e-5, 1e-4


def _nondeterministic_flags(fn) -> list:
    """The operations torch warns about, while `fn` runs on the card under
    `use_deterministic_algorithms(True, warn_only=True)`."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            fn()
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
    return sorted({str(w.message).split(" does not have")[0].split(". ")[0][:120]
                   for w in caught if "determinis" in str(w.message).lower()})


def _interrupt_after(dm, step: int):
    """Make `dm.save_train_state` raise once it has written the checkpoint
    of `step` (a run stopped there); returns the exception type and the
    function to restore."""
    real = dm.save_train_state

    class Interrupted(Exception):
        pass

    def save(path, params, opt_state, at):
        real(path, params, opt_state, at)
        if at >= step:
            raise Interrupted

    dm.save_train_state = save
    return Interrupted, lambda: setattr(dm, "save_train_state", real)


def path_t(dev, card, rec, tmp: str) -> None:
    """Path T: the query encoder's training path on the card.  The golden
    set is the seeded reference-sized corpus's 589 texts, each paired with
    the committed distilled encoder's vector (the teacher), pickled in the
    reference layout (`testing.write_golden_set`); then through the tools'
    `main`:
      T-train   — `distill_minilm` at full width (batch 128, max_len 192)
                  for 200 steps in chunks of 50: the last chunk's loss below
                  the first's, every output finite and unit-norm; then the
                  train step alone: ms by CUDA events, steps/s, tokens/s
                  (padded and valid), peak device memory, a profile of one
                  step and its bound (`utils/bounds.minilm_train_work`);
      T-resume  — the same run stopped after the checkpoint of step 100 and
                  resumed to 200, against the uninterrupted run;
      T-holdout — `--holdout-frac 0.2 --augment 1` for 100 steps, then
                  `encoder_confidence` over its held-out encoder (AUC, label
                  balance, the ensemble's lift), the artifacts loaded onto
                  the card;
      T-parity  — 3 steps at batch 8 and max_len 64 over 64 pairs from the
                  same initial weights on the card and on the CPU;
      T-serve   — the held-out encoder's embeddings of its held-out texts
                  through `QueryEngine.query_batch` over the golden bank
                  (f32: one B4 launch), against the trainer's numpy top-10."""
    from hcrag_tpu_torch.core.dense_index import DenseIndex
    from hcrag_tpu_torch.models.minilm import load_distilled_embedder
    from hcrag_tpu_torch.query.engine import QueryEngine
    from hcrag_tpu_torch.testing import write_golden_pairs, write_golden_set
    from hcrag_tpu_torch.tools import distill_minilm as dm
    from hcrag_tpu_torch.tools import encoder_confidence as ec
    from hcrag_tpu_torch.utils.bounds import minilm_train_work

    t_path = time.time()
    pk = write_golden_set(f"{tmp}/t_golden", device=dev)
    texts, gold = dm.load_pairs(pk)
    n = len(texts)
    log(f"[T] golden set: {n} corpus texts with the committed encoder's vectors on the "
        f"card, in {time.time() - t_path:.1f} s (host clock)")
    common = ["--pickle", pk, "--batch", str(T_BATCH), "--max-len", str(T_MAX_LEN),
              "--scan-chunk", str(T_CHUNK), "--lr", str(T_LR)]

    # T-train ---------------------------------------------------------------
    t0 = time.time()
    full = dm.main(common + ["--steps", str(T_STEPS), "--out", f"{tmp}/t_full"])
    train_s = time.time() - t0
    reports = full["reports"]
    if [r["step"] for r in reports] != list(range(T_CHUNK, T_STEPS + 1, T_CHUNK)):
        raise AssertionError(f"T-train: chunks {[r['step'] for r in reports]}")
    if not reports[-1]["loss"] < reports[0]["loss"]:
        raise AssertionError(f"T-train: the loss did not fall: {reports}")
    emb = full["embedder"]
    if emb.device.type != dev.type:
        raise AssertionError(f"T-train: the trainer did not run on {dev}")
    out = emb.encode(texts)
    if out.shape != (n, DIM) or not np.isfinite(out).all() or \
            np.abs(np.linalg.norm(out, axis=1) - 1).max() > 1e-5:
        raise AssertionError("T-train: outputs not finite and unit-norm")
    log(f"[T-train] {T_STEPS} steps in {train_s:.1f} s with {len(reports)} evaluations "
        f"(host clock); "
        f"loss {reports[0]['loss']:.6f} -> {reports[-1]['loss']:.6f}; cos_mean "
        f"{reports[-1]['cos_mean']:.6f}, cos_min {reports[-1]['cos_min']:.6f}")
    tok = emb.tokenizer
    ids, mask = tok.encode_batch(texts)
    trainer = dm.Distiller(emb.model, ids, mask, gold, lr=T_LR, steps=12000)
    rows = torch.from_numpy(np.random.default_rng(1).choice(n, T_BATCH, replace=False)).to(dev)
    step = lambda: trainer.step(rows)  # noqa: E731
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = cuda_ms(step, reps=T_TIMED_STEPS, warmup=2)
    peak = torch.cuda.max_memory_allocated() / 2**30
    work = minilm_train_work(T_BATCH, T_MAX_LEN)
    valid = int(mask[rows.cpu().numpy()].sum())
    b_ms, b_by = bound_ms(work["ops"], work["kind"], work["bytes"])
    log(f"[T-train] train step (B={T_BATCH}, max_len {T_MAX_LEN}, full width): "
        f"{step_ms:.3f} ms/step (CUDA events, {T_TIMED_STEPS} steps), "
        f"{1e3 / step_ms:.2f} steps/s, {work['tokens'] / step_ms * 1e3:.0f} padded tokens/s, "
        f"{valid / step_ms * 1e3:.0f} valid tokens/s "
        f"({valid} of {work['tokens']}); peak device memory {peak:.2f} GiB; "
        f"bound {b_ms:.3f} ms ({b_by}: {work['ops'] / 1e12:.3f} TFLOP f32, "
        f"{work['bytes'] / 1e9:.2f} GB), {100 * b_ms / step_ms:.1f}% of it; {card}")
    profile_step(step, card, steps=1)
    rows_, busy_us, _ = profiled(step, 1)
    gemm_us = sum(us for us, key, _ in rows_ if "gemm" in key.lower())
    log(f"[T-train] one step's device time: matrix products (cuBLAS / CUTLASS gemm "
        f"kernels) {gemm_us / 1e3:.3f} ms of {busy_us / 1e3:.3f} ms "
        f"({100 * gemm_us / max(busy_us, 1e-9):.1f}%), the rest (element-wise, "
        f"reductions, softmax, copies, AdamW) {(busy_us - gemm_us) / 1e3:.3f} ms")
    # What torch flags as not deterministic in one step, read only if the
    # probe first flags operations known to be so (CUDA histc, index_add_).
    x = torch.rand(4096, device=dev)
    control = _nondeterministic_flags(lambda: (
        torch.histc(x, bins=16), torch.zeros(16, device=dev).index_add_(
            0, torch.arange(4096, device=dev) % 16, x)))
    flagged = _nondeterministic_flags(step)
    log(f"[T-train] use_deterministic_algorithms(warn_only) probe, "
        f"CUBLAS_WORKSPACE_CONFIG={os.environ.get('CUBLAS_WORKSPACE_CONFIG')!r}: control "
        f"(histc, index_add_) flagged {control or 'none'}; one train step flagged "
        f"{flagged or 'none'}" + ("" if control else " (the probe is blind: no conclusion)"))
    del trainer, step
    free("T-train")

    # T-resume --------------------------------------------------------------
    ck = f"{tmp}/t_ckpt.npz"
    interrupted, restore = _interrupt_after(dm, T_RESUME_AT)
    try:
        dm.main(common + ["--steps", str(T_STEPS), "--out", f"{tmp}/t_resume", "--resume", ck])
        raise AssertionError("T-resume: the first run was not stopped")
    except interrupted:
        pass
    finally:
        restore()
    resumed = dm.main(common + ["--steps", str(T_STEPS), "--out", f"{tmp}/t_resume",
                                "--resume", ck])
    if [r["step"] for r in resumed["reports"]] != \
            list(range(T_RESUME_AT + T_CHUNK, T_STEPS + 1, T_CHUNK)):
        raise AssertionError(f"T-resume: chunks {[r['step'] for r in resumed['reports']]}")
    with np.load(f"{tmp}/t_full.npz") as a, np.load(f"{tmp}/t_resume.npz") as b:
        leaf_diff = {k: float(np.abs(a[k] - b[k]).max()) for k in a.files}
    p_diff, bitwise = max(leaf_diff.values()), not any(leaf_diff.values())
    differ = sorted((d, k) for k, d in leaf_diff.items() if d)[::-1]
    e_diff = float(np.abs(resumed["embedder"].encode(texts) - out).max())
    r_diff = max(abs(x[k] - y[k]) for x, y in zip(resumed["reports"],
                                                  reports[T_RESUME_AT // T_CHUNK:])
                 for k in ("loss", "cos_mean", "cos_min"))
    log(f"[T-resume] stopped after step {T_RESUME_AT}'s checkpoint, resumed to {T_STEPS}: "
        f"parameters {'bit-equal' if bitwise else 'not bit-equal'} to the uninterrupted "
        f"run (max |diff| {p_diff:.3g}), output embeddings max |diff| {e_diff:.3g} (gate "
        f"{T_RESUME_TOL}), reports max |diff| {r_diff:.3g}; {len(differ)} of "
        f"{len(leaf_diff)} leaves differ, the largest "
        f"{[(k.replace('params/', ''), f'{d:.3g}') for d, k in differ[:4]]}")
    if not e_diff <= T_RESUME_TOL:
        raise AssertionError(f"T-resume: embeddings differ by {e_diff} > {T_RESUME_TOL}")
    if not bitwise:
        raise AssertionError(f"T-resume: parameters not bit-equal, {differ[:4]}")
    del full, resumed, emb
    free("T-resume")

    # T-holdout ---------------------------------------------------------------
    t0 = time.time()
    hold = dm.main(common + ["--steps", str(T_HOLDOUT_STEPS), "--holdout-frac", "0.2",
                             "--augment", "1", "--out", f"{tmp}/t_hold"])["holdout"]
    conf = ec.main(["--base", f"{tmp}/t_hold", "--pickle", pk, "--out", f"{tmp}/t_conf"])
    for suffix in ("_holdout.npz", "_holdout_vocab.txt", "_holdout_meta.json",
                   "_holdout_report.json"):
        if not os.path.exists(f"{tmp}/t_hold{suffix}"):
            raise AssertionError(f"T-holdout: no {suffix}")
    for suffix in ("_calibration.json", "_report.json"):
        if not os.path.exists(f"{tmp}/t_conf{suffix}"):
            raise AssertionError(f"T-holdout: no calibration {suffix}")
    student = load_distilled_embedder(f"{tmp}/t_hold_holdout", device=dev)
    if student is None or student.device.type != dev.type:
        raise AssertionError(f"T-holdout: the held-out encoder did not load onto {dev}")
    ens = conf["ensemble_encoding"]
    log(f"[T-holdout] {hold['n_train']} train / {hold['n_holdout']} held-out pairs, "
        f"{hold['n_train_examples']} examples, {T_HOLDOUT_STEPS} steps + calibration in "
        f"{time.time() - t0:.1f} s (host clock): held-out cos mean "
        f"{hold['holdout_cos_mean']:.4f}, top-10 agreement {hold['holdout_top10_agreement_mean']:.4f}, "
        f"paraphrases {hold['paraphrase_top10_agreement_mean']:.4f}, hash ensemble "
        f"{json.dumps(hold['ensemble_top10_agreement'])}; calibration AUC "
        f"{conf['auc_combined_heldout_split']:.4f} (max_sim {conf['auc_max_sim_only']:.4f}, "
        f"agreement {conf['auc_agreement_only']:.4f}), label balance "
        f"{conf['label_positive_frac']:.3f}, ensemble encoding "
        f"{ens['holdout_agreement_single']:.4f} -> {ens['holdout_agreement_ensemble']:.4f}")

    # T-serve -----------------------------------------------------------------
    with open(f"{tmp}/t_hold_holdout_meta.json") as f:
        held = json.load(f)["holdout_idx"]
    q = student.encode([texts[i] for i in held])
    engine = QueryEngine(DenseIndex.from_reference_pickle(pk), None, device=dev)
    zero_counts()
    res = engine.query_batch(q, top_k=TOP_K)
    rec.launches["T-serve"] = read_counts()
    launched = {k: v for k, v in rec.launches["T-serve"].items() if v}
    if launched != {"float_tile_topk": 1}:
        raise AssertionError(f"T-serve: launches {launched}, not one B4")
    qn = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
    sims = qn @ gold.T
    want = np.argsort(-sims, axis=1, kind="stable")[:, :TOP_K]
    srt = -np.sort(-sims, axis=1)
    clear = srt[:, TOP_K - 1] - srt[:, TOP_K] > 1e-5  # no tie at the boundary
    same = [set(res.top_indices[i]) == set(want[i]) for i in range(len(q)) if clear[i]]
    log(f"[T-serve] {len(q)} held-out embeddings through query_batch over the {n}-row "
        f"golden bank: launches {launched}; index sets equal the trainer's numpy top-10 on "
        f"{sum(same)} of {len(same)} rows without a tie at the boundary")
    if not all(same):
        raise AssertionError("T-serve: index sets differ from the numpy top-10")
    del engine, student

    # T-parity ----------------------------------------------------------------
    pp = T_PARITY
    small = write_golden_pairs(f"{tmp}/t_small.pkl", texts[:pp["rows"]], gold[:pp["rows"]])
    argv = ["--pickle", small, "--steps", str(pp["steps"]), "--scan-chunk", "1",
            "--batch", str(pp["batch"]), "--max-len", str(pp["max_len"])]
    on_card = dm.main(argv + ["--out", f"{tmp}/t_par_card"])
    on_cpu = dm.main(argv + ["--out", f"{tmp}/t_par_cpu", "--device", "cpu"])
    loss_rel = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                   for a, b in zip(on_card["reports"], on_cpu["reports"]))
    emb_diff = float(np.abs(on_card["embedder"].encode(texts[:pp["rows"]])
                            - on_cpu["embedder"].encode(texts[:pp["rows"]])).max())
    log(f"[T-parity] {pp['steps']} steps at batch {pp['batch']}, max_len {pp['max_len']} "
        f"from the same initial weights: losses card "
        f"{[round(r['loss'], 7) for r in on_card['reports']]} vs CPU "
        f"{[round(r['loss'], 7) for r in on_cpu['reports']]} (max relative diff "
        f"{loss_rel:.3g}, gate {T_PARITY_LOSS_RTOL}); output embeddings max |diff| "
        f"{emb_diff:.3g} (gate {T_PARITY_EMB_TOL})")
    if not (loss_rel <= T_PARITY_LOSS_RTOL and emb_diff <= T_PARITY_EMB_TOL):
        raise AssertionError("T-parity: card and CPU trainers differ")
    log(f"[T] path T in {time.time() - t_path:.1f} s")


def path_pv(dev, card, rec, tmp: str) -> None:
    """Path PV: the parity tools on the card over path B's corpus, with its
    texts' hashing-embedder vectors as the pickle (`testing.
    write_corpus_pairs`): `verify_parity` exits 0, `agent_trace_fixture`
    writes its fixture and checks against it (0 and 0), launches counted
    over both; the card's traces against the CPU's; B4 at the tools'
    shapes."""
    import contextlib
    import io

    from hcrag_tpu_torch.ingest.adventureworks import build_adventureworks
    from hcrag_tpu_torch.query.engine import QueryEngine
    from hcrag_tpu_torch.testing import write_corpus_pairs
    from hcrag_tpu_torch.tools import agent_trace_fixture as atf
    from hcrag_tpu_torch.tools import verify_parity

    t0 = time.time()
    data = f"{tmp}/b_corpus"
    pk = write_corpus_pairs(data, f"{tmp}/pv_pairs.pkl")
    src = ["--data", data, "--pickle", pk]
    fixture = f"{tmp}/pv_fixture.json"
    zero_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        codes = (verify_parity.main(src), atf.main(src + ["--out", fixture]),
                 atf.main(src + ["--check", "--fixture", fixture]))
    rec.launches["PV"] = read_counts()
    lines = buf.getvalue().splitlines()
    log(f"[PV] verify_parity, agent_trace_fixture, --check: exit codes {codes}; "
        f"{sum('[PASS]' in x for x in lines)} checks passed, skipped "
        f"{[x.split('] ')[1].split(' (')[0] for x in lines if '[SKIP]' in x]}; "
        f"launches {rec.launches['PV']}")
    if codes != (0, 0, 0):
        raise AssertionError("PV: a tool failed:\n" + "\n".join(lines[-40:]))
    launched = {k: v for k, v in rec.launches["PV"].items() if v}
    if set(launched) != {"float_tile_topk"} or launched["float_tile_topk"] < 64:
        raise AssertionError(f"PV: launches {launched}, not B4 for each of 64 queries and more")
    with open(fixture) as f:
        card_traces = json.load(f)
    cpu_traces = json.loads(json.dumps(atf.run_traces(data, pk, "cpu")))
    for q in atf.QUESTIONS:
        a, b = card_traces[q], cpu_traces[q]
        for field in ("node_trace", "decision", "final_node_keys", "revision_history"):
            if a[field] != b[field]:
                raise AssertionError(f"PV: {q!r} {field} differs from the CPU's")
        for sa, sb in zip(a["steps"], b["steps"], strict=True):
            if sa["sampled"] != sb["sampled"] or sa["decision"] != sb["decision"]:
                raise AssertionError(f"PV: {q!r} step {sa['node']} differs from the CPU's")
            for key in ("semantic_scores", "final_scores"):
                if len(sa[key]) != len(sb[key]) or any(
                        abs(x - y) > 1e-5 for x, y in zip(sa[key], sb[key])):
                    raise AssertionError(f"PV: {q!r} {key} differ from the CPU's")
    engine = QueryEngine(build_adventureworks(data, reference_pickle=pk).index, None,
                         device=dev)
    q = torch.from_numpy(np.asarray(engine.index.emb[:1], np.float32)).to(dev)
    b4_at_path(engine, torch.nn.functional.normalize(q, dim=1), "PV", card, rec)
    log(f"[PV] card traces == CPU traces (node traces, sampled ids, decisions, final keys; "
        f"scores within 1e-5); path PV in {time.time() - t0:.1f} s; {card}")


GE_FULL = dict(pairs_per_rank=32, seq=128)  # the contrastive step at full width
# One run of 12 steps: the loss after 3 updates (before step 4) must be
# below the first; ms/step is the median of the 10 steps after 2 warm-up
# steps, with its spread.
GE_GATE_STEP, GE_WARMUP, GE_TIMED_STEPS = 3, 2, 10
GE_FULL_STEPS = GE_WARMUP + GE_TIMED_STEPS


def ge_rank(rank, world):
    """One gloo rank of GE-2 / GE-4 (every rank on the one card):
    `dryrun_multichip` inside the spawned group, its launches counted."""
    from hcrag_tpu_torch import graft_entry as ge

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    zero_counts()
    out = ge.dryrun_multichip(world)
    return {"launches": read_counts(), "status": out["status"], "seconds": out["seconds"],
            "agent": out["agent"], "mesh": out["mesh"], "batches": out["batches"],
            "losses": out["contrastive"]["losses"]}


def ge_contrastive(mesh) -> dict:
    """`contrastive_train` at full width on this rank: its result, each
    `_collective` call's (kind, bytes, host ms) and the peak device
    memory."""
    from hcrag_tpu_torch import graft_entry as ge
    from hcrag_tpu_torch.models.minilm import MiniLMConfig

    calls = []
    real = ge._collective

    def timed(kind, tensor, group):
        t0 = time.perf_counter()
        out = real(kind, tensor, group)
        calls.append((kind, tensor.numel() * tensor.element_size(),
                      1e3 * (time.perf_counter() - t0)))
        return out

    ge._collective = timed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        res = ge.contrastive_train(mesh, steps=GE_FULL_STEPS, cfg=MiniLMConfig(), **GE_FULL)
    finally:
        ge._collective = real
    peak = torch.cuda.max_memory_allocated() / 2**30
    del res["model"], res["grads"]
    return dict(res, calls=calls, peak_gib=peak)


def ge_contrastive_rank(rank, world):
    from hcrag_tpu_torch.parallel import make_row_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return ge_contrastive(make_row_mesh(device="cuda"))


def ge_kernels_at_shard(rows: int, label: str, dev, card, rec) -> None:
    """B4 (f32), B5 (bf16 + exact rescore, at the dry run's 8 queries and
    the executor's 256) and B1 (int8 + rescore) at one shard's shapes of
    the dry run (its first `rows` rows) against their plain versions."""
    from hcrag_tpu_torch import graft_entry as ge
    from hcrag_tpu_torch.query.engine import QueryEngine
    from hcrag_tpu_torch.utils.synthetic import synthetic_setup

    index, graph = synthetic_setup(rows, ge.DRYRUN_DIM)
    rng = np.random.default_rng(1)
    q = rng.standard_normal((ge.DRYRUN_BATCH, ge.DRYRUN_DIM)).astype(np.float32)
    sq = rng.standard_normal((ge.DRYRUN_REQUESTS, ge.DRYRUN_DIM)).astype(np.float32)
    dq = torch.nn.functional.normalize(torch.from_numpy(q).to(dev), dim=1)
    dsq = torch.nn.functional.normalize(torch.from_numpy(sq[:256]).to(dev), dim=1)
    log(f"[{label}] kernels at a shard's shapes: {rows} rows x {ge.DRYRUN_DIM}")
    b4_at_path(QueryEngine(index, graph, device=dev), dq, label, card, rec)
    engine = QueryEngine(index, graph, device=dev, exact_rescore=32)
    b5_at_path(engine, dq, label, card, rec)
    b5_at_path(engine, dsq, f"{label}@256", card, rec)
    engine = QueryEngine(index, graph, device=dev, quantize_int8=True, int8_rescore=32)
    int8_kernels_at_path(engine, dq, label, card, rec, engine._rescore_m(), with_merge=False)


def path_ge(dev, card, rec) -> None:
    """Path GE: `graft_entry.entry()` and `dryrun_multichip` on the card,
    then the contrastive step at full width (see the module's
    docstring)."""
    import torch.distributed as dist

    from hcrag_tpu_torch import graft_entry as ge
    from hcrag_tpu_torch.models.minilm import MiniLMConfig
    from hcrag_tpu_torch.parallel import make_row_mesh
    from hcrag_tpu_torch.parallel.launch import run_ranks

    t_path = time.time()
    step, args = ge.entry()
    zero_counts()
    got = step(*args)
    torch.cuda.synchronize()
    rec.launches["GE-entry"] = read_counts()
    launched = {k: v for k, v in rec.launches["GE-entry"].items() if v}
    if launched != {"float_tile_topk": 1}:
        raise AssertionError(f"GE-entry: launches {launched}, not one B4")
    cpu_step, cpu_args = ge.entry("cpu")
    want = cpu_step(*cpu_args)
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        g = g.cpu()
        if g.dtype.is_floating_point:
            if not float((g - w).abs().max()) <= 1e-5:
                raise AssertionError(f"GE-entry: output {i} differs from the CPU's")
        elif not torch.equal(g, w):
            raise AssertionError(f"GE-entry: output {i} differs from the CPU's")
    log(f"[GE-entry] entry()'s step on the card: outputs {[tuple(o.shape) for o in got]} "
        f"equal the CPU's (integers exactly, floats within 1e-5); launches {launched}")
    bank = args[7]["emb"]
    b4_at(args[0], bank, path_mask(bank.shape[0], 2048, dev), "GE-entry", card, rec)

    for world in (1, 2, 4):
        label, t0 = f"GE-{world}", time.time()
        if world == 1:
            zero_counts()
            outs = [ge.dryrun_multichip(1)]
            counts = read_counts()
            if dist.is_initialized():
                raise AssertionError("GE-1: the one-rank group outlived the dry run")
        else:
            outs = run_ranks(ge_rank, world, timeout_s=600)
            counts = outs[0]["launches"]
            for r, out in enumerate(outs[1:], 1):
                if out["agent"] != outs[0]["agent"] or out["batches"] != outs[0]["batches"]:
                    raise AssertionError(f"{label}: rank {r} differs from rank 0")
        rec.launches[label] = counts
        launched = {k: v for k, v in counts.items() if v}
        if set(launched) != {"int8_tile_topk", "float_tile_topk", "float_packed_tile_topk"}:
            raise AssertionError(f"{label}: launches {launched}")
        log(f"[{label}] {outs[0]['status']}")
        log(f"[{label}] {world} rank(s) in {time.time() - t0:.1f} s (host clock, with any "
            f"spawn); rank 0's parts (s): "
            f"{ {k: round(v, 2) for k, v in outs[0]['seconds'].items()} }; launches on "
            f"rank 0 {launched} (no B2: a shard's pool of 32 stays under 4,096); {card}")
    ge_kernels_at_shard(ge.DRYRUN_ROWS, "GE-1", dev, card, rec)
    # GE-4's (2, 2) mesh splits the rows in two as GE-2 does: the same shapes.
    ge_kernels_at_shard(ge.DRYRUN_ROWS // 2, "GE-2", dev, card, rec)

    t0 = time.time()
    mesh = make_row_mesh()
    try:
        full = {1: ge_contrastive(mesh)}
        rows_, busy_us, wall_us = profiled(lambda: ge.contrastive_train(
            mesh, steps=1, cfg=MiniLMConfig(), **GE_FULL), 1)
    finally:
        dist.destroy_process_group()
    gemm_us = sum(us for us, key, _ in rows_ if "gemm" in key.lower())
    log(f"[GE-contrastive] one step at world size 1 profiled (the encoder's set-up "
        f"included): device busy {busy_us / 1e3:.3f} ms of {wall_us / 1e3:.3f} ms wall, "
        f"matrix products (gemm kernels) {gemm_us / 1e3:.3f} ms; largest "
        f"{[(key[:60], round(us / 1e3, 3), n) for us, key, n in sorted(rows_, reverse=True)[:6]]}")
    full[2] = run_ranks(ge_contrastive_rank, 2, timeout_s=600)[0]
    for world, res in full.items():
        losses, timed = res["losses"], res["step_ms"][GE_WARMUP:]
        reduces = [c[2] for c in res["calls"]
                   if c[0] == "all_reduce" and c[1] == res["reduce_bytes"]][GE_WARMUP:]
        log(f"[GE-contrastive] world {world} ({'NCCL' if world == 1 else 'gloo, one card'}): "
            f"MiniLM 6 x 384, seq {GE_FULL['seq']}, {GE_FULL['pairs_per_rank']} pairs a "
            f"rank: losses {[round(x, 6) for x in losses]}; the gate's loss after "
            f"{GE_GATE_STEP} updates / the first {losses[GE_GATE_STEP] / losses[0]:.4f}; "
            f"ms/step (CUDA events) {[round(x, 3) for x in res['step_ms']]}, median of "
            f"steps {GE_WARMUP + 1}-{GE_FULL_STEPS} {float(np.median(timed)):.3f} (min "
            f"{min(timed):.3f}, max {max(timed):.3f}); gradient all-reduce "
            f"{res['reduce_bytes']} bytes, host ms over those steps median "
            f"{float(np.median(reduces)):.3f} (min {min(reduces):.3f}, max "
            f"{max(reduces):.3f}); {len(res['calls'])} collectives; peak device "
            f"{res['peak_gib']:.2f} GiB; {card}")
        if not all(np.isfinite(losses)) or not losses[GE_GATE_STEP] < losses[0]:
            raise AssertionError(f"GE-contrastive world {world}: the loss did not fall")
    log(f"[GE] path GE in {time.time() - t_path:.1f} s (contrastive "
        f"{time.time() - t0:.1f} s)")


#: label -> (engine options, recall gate): path P1's modes.  The int8
#: mode rescores from bf16 rows, which cannot order f32 near-ties (D3's gate).
P1_MODES = {
    "P1-int8": (dict(quantize_int8=True, int8_rescore=RESCORE), D3_MIN_RECALL),
    "P1-rescore": (dict(exact_rescore=RESCORE), MIN_RECALL),
}
P1_KERNELS = {"P1-int8": "int8_tile_topk", "P1-rescore": "float_packed_tile_topk"}


def path_p1(index, graph, queries, ref, dev, card, rec) -> None:
    """Path P1: the sharded engine at world size 1 over NCCL on the int8
    path's index and queries (1M x 384, B=8192), in two modes, each against
    an unsharded engine of the same options: results equal bit for bit (the
    rescore shares `candidate_dots`), recall gated, step times of both in
    turns (unsharded, sharded, sharded, unsharded); then, on the int8
    mode, a checkpoint round trip (the banks zeroed between save and
    restore), 1,024 requests through `BatchedExecutor` (the rank protocol
    over NCCL) and the closed-loop saturation of `p1_saturation`."""
    import tempfile
    from pathlib import Path

    from hcrag_tpu_torch.parallel import ShardedQueryEngine, make_row_mesh
    from hcrag_tpu_torch.parallel.checkpoint import (
        restore_sharded_index,
        save_sharded_index,
    )
    from hcrag_tpu_torch.query.executor import BatchedExecutor

    t_phase = time.time()
    mesh = make_row_mesh()
    if mesh.size != 1 or mesh.backend != "nccl":
        raise AssertionError(f"P1: want one rank over NCCL, got {mesh}")
    log(f"[P1] mesh {mesh.shape} over {mesh.backend} on {mesh.device}")
    dq = torch.from_numpy(queries).to(dev)
    for label, (opts, gate) in P1_MODES.items():
        plain = engine_ready(f"{label} unsharded", index, graph, dev, BATCH, **opts)
        t0 = time.time()
        sharded = ShardedQueryEngine(index, graph, mesh=mesh, ell_max_degree=8, **opts)
        torch.cuda.synchronize()
        log(f"[{label}] sharded engine ready in {time.time() - t0:.1f} s (host set-up); "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card with both engines")
        res = drive(sharded, queries, (P1_KERNELS[label], "packed_candidate_merge"), label,
                    ref, rec, min_recall=gate)
        same_batch(res, plain.query_batch(queries, top_k=TOP_K, expansion_depth=DEPTH),
                   label, atol=0.0)
        log(f"[{label}] sharded == unsharded, every field bit for bit")
        steps = {"unsharded": lambda: plain.query_batch_device(dq, top_k=TOP_K,
                                                               expansion_depth=DEPTH),
                 "sharded": lambda: sharded.query_batch_device(dq, top_k=TOP_K,
                                                              expansion_depth=DEPTH)}
        torch.cuda.reset_peak_memory_stats()
        ms = {k: [] for k in steps}
        for k in ("unsharded", "sharded", "sharded", "unsharded"):
            ms[k].append(cuda_ms(steps[k], reps=3))
        u, sh = (float(np.mean(ms[k])) for k in ("unsharded", "sharded"))
        log(f"[{label}] step: unsharded {u:.3f} ms ({BATCH / u * 1e3:.1f} QPS; runs "
            f"{ms['unsharded']}), sharded {sh:.3f} ms ({BATCH / sh * 1e3:.1f} QPS; runs "
            f"{ms['sharded']}), sharded / unsharded {sh / u:.4f} (CUDA events, 3 steps a "
            f"run; peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
            f"with both engines resident; {card})")
        profile_step(steps["sharded"], card)
        if label == "P1-int8":
            with tempfile.TemporaryDirectory() as tmp:
                t0 = time.time()
                save_sharded_index(sharded, tmp)
                save_s = time.time() - t0
                nbytes = sum(f.stat().st_size for f in Path(tmp).iterdir())
                for t in (sharded.d_emb_int8, sharded.d_emb_scale, sharded.d_emb):
                    t.zero_()
                t0 = time.time()
                restore_sharded_index(sharded, tmp)
                torch.cuda.synchronize()
                restore_s = time.time() - t0
            same_batch(sharded.query_batch(queries, top_k=TOP_K, expansion_depth=DEPTH),
                       res, f"{label} restored", atol=0.0)
            log(f"[{label}] checkpoint: saved {nbytes / 2**30:.3f} GiB in {save_s:.2f} s, "
                f"restored in {restore_s:.2f} s (host clock; the banks zeroed between); "
                f"results after the restore equal those before, bit for bit")
            q = queries[:E_BATCH]
            ex = BatchedExecutor(sharded, batch_size=E_BATCH, top_k=TOP_K)
            try:
                served = [f.result(timeout=E_WAIT_S) for f in ex.submit_many(q)]
            finally:
                ex.shutdown()
            want = sharded.query_batch(q, top_k=TOP_K)
            if not (np.array_equal(np.stack([i for _, i in served]), want.top_indices)
                    and np.array_equal(np.stack([v for v, _ in served]), want.top_scores)):
                raise AssertionError(f"{label}: served results differ from query_batch")
            log(f"[{label}] BatchedExecutor over the sharded engine (the rank protocol over "
                f"NCCL): {E_BATCH} requests in {ex.batches_dispatched} batch(es), equal to "
                f"query_batch bit for bit")
            p1_saturation(plain, sharded, card, rec)
        del plain, sharded
        free(label)
    torch.distributed.destroy_process_group()  # the one-rank group make_row_mesh made
    log(f"[P1] phase {time.time() - t_phase:.1f} s")


def p1_saturation(plain, sharded, card, rec) -> None:
    """Closed-loop saturation through `BatchedExecutor` (path E's settings):
    `E_SAT` requests submitted at once in blocks of `E_BATCH`, over the
    unsharded int8 engine and over the sharded one (the rank protocol over
    NCCL at world size 1), in turns (unsharded, sharded, sharded,
    unsharded), the set-up's objects frozen.  Each kernel of the int8
    engine launches once per batch; every batch of the first turn of each
    holds 1024 requests whose results equal the unsharded `query_batch` of
    them bit for bit.  The ratio of the two rates is the protocol's cost."""
    from hcrag_tpu_torch.benchmarks import serving_openloop as so
    from hcrag_tpu_torch.query.executor import BatchedExecutor

    queries = _e_queries()
    rps = {"unsharded": [], "sharded": []}
    for turn in ("unsharded", "sharded", "sharded", "unsharded"):
        engine = plain if turn == "unsharded" else sharded
        label = "P1-E" if turn == "sharded" else "P1-E-unsharded"
        zero_counts()
        ex = BatchedExecutor(engine, batch_size=E_BATCH, batch_sizes=E_SIZES,
                             pipeline_depth=E_DEPTH, max_wait_ms=E_WAIT_MS, top_k=TOP_K)
        futs = []
        try:
            with collections(True):
                st = so.run_saturation(ex, queries, E_SAT, futs, timeout=E_WAIT_S,
                                       block=E_BATCH)
        finally:
            ex.shutdown()
        counts = read_counts()
        check_per_batch(counts, int8_per_batch(engine), ex.batches_dispatched, label)
        if not rps[turn]:
            rec.launches[label] = counts
            n = _check_served_batches(plain, futs, queries, label)
            log(f"[{label}] {n} saturation batches of {E_BATCH}, each equal to the "
                f"unsharded query_batch at B={E_BATCH} bit for bit; launches {counts}")
        rps[turn].append(st["requests_per_s"])
    u, sh = (float(np.mean(rps[k])) for k in ("unsharded", "sharded"))
    per_batch_ms = (1 / sh - 1 / u) * E_BATCH * 1e3
    log(f"[P1-E] closed-loop saturation, {E_SAT} requests in blocks of {E_BATCH} (set-up "
        f"objects frozen): unsharded {u:.1f} req/s (runs {rps['unsharded']}), sharded "
        f"{sh:.1f} req/s (runs {rps['sharded']}), sharded / unsharded {sh / u:.4f}: the "
        f"rank protocol's cost {per_batch_ms:.3f} ms a batch of {E_BATCH} (host clock); "
        f"{card}")
    p1_dispatch_pieces(plain, sharded, queries[:E_BATCH], card)


def p1_dispatch_pieces(plain, sharded, q, card, reps: int = 64) -> None:
    """The pieces of one dispatch at B=`E_BATCH`, each called `reps` times
    back to back: host ms a call to issue them, and wall ms a call once the
    card has finished them.  A piece whose issue takes its wall time holds
    the host until the card is done with it."""
    import torch.distributed as dist

    def host_batch():  # as the dispatcher makes it (`BatchedExecutor._queries`)
        host = torch.zeros((E_BATCH, DIM), dtype=torch.float32, pin_memory=True)
        norms = np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
        np.divide(q, norms, out=host.numpy())
        return host.to(plain.device, non_blocking=True)

    ctrl = dist.new_group(backend="gloo")
    header = torch.zeros(3, dtype=torch.int64)
    dq = host_batch()
    pieces = {
        "host batch (normalize, pinned copy)": host_batch,
        "header (gloo broadcast)": lambda: dist.broadcast(header, src=0, group=ctrl),
        "batch (NCCL broadcast)": lambda: dist.broadcast(dq, src=0, group=sharded.mesh.world),
        "unsharded step": lambda: plain.retrieve_batch_device(dq, top_k=TOP_K),
        "sharded step": lambda: sharded.retrieve_batch_device(dq, top_k=TOP_K),
    }
    try:
        out = []
        for name, fn in pieces.items():
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            out.append(f"{name} {(t1 - t0) / reps * 1e3:.3f} / {(t2 - t0) / reps * 1e3:.3f}")
    finally:
        dist.destroy_process_group(ctrl)
    log(f"[P1-E] a dispatch's pieces, host ms to issue / wall ms a call ({reps} calls "
        f"back to back): {'; '.join(out)}; {card}")


#: label -> (engine options, query options, the selection kernel): path
#: P2's modes (the CPU tests' engine modes but top_k = 200, plus the int8
#: supertiles); the last two run at 4 ranks only.
P2_MODES = {
    "f32": (dict(), dict(), "float_tile_topk"),
    "rescore": (dict(exact_rescore=RESCORE), dict(), "float_packed_tile_topk"),
    "rescore_super": (dict(exact_rescore=RESCORE, pallas_super=4), dict(),
                      "float_packed_super_tile_topk"),
    "int8": (dict(quantize_int8=True, int8_rescore=RESCORE), dict(), "int8_tile_topk"),
    "int8_super": (dict(quantize_int8=True, int8_rescore=RESCORE, pallas_super=4), dict(),
                   "int8_super_tile_topk"),
    "residual": (dict(quantize_int8=True, int8_residual=True, int8_rescore=24), dict(),
                 "int8_tile_topk"),
    "int8_only": (dict(quantize_int8=True, int8_only=True), dict(), "int8_tile_topk"),
    "filter": (dict(), dict(category_filter="json_table"), "float_tile_topk"),
    "dynamic": (dict(), dict(dynamic=True), "float_tile_topk"),
    "graph_split_depth2": (dict(shard_graph=True), dict(expansion_depth=2), "float_tile_topk"),
    "batch_mesh": (dict(shard_queries=True), dict(), "float_tile_topk"),
}
P2_FOUR_ONLY = ("graph_split_depth2", "batch_mesh")


def p2_setup(n_rows=P2_ROWS):
    """P2's index of `n_rows` (every third row re-typed, for the filter),
    graph and queries, the same in every process."""
    import dataclasses

    from hcrag_tpu_torch.utils.synthetic import synthetic_setup

    index, graph = synthetic_setup(n_rows, DIM, graph_degree=4)
    meta = [dict(m, type="json_table" if r % 3 == 0 else "database_table")
            for r, m in enumerate(index.metadata)]
    q = np.random.default_rng(9).standard_normal((P2_BATCH, DIM)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return dataclasses.replace(index, metadata=meta), graph, q


def p2_query_kwargs(qopts):
    kw = dict(qopts, top_k=TOP_K)
    if kw.pop("dynamic", False):
        from hcrag_tpu_torch.pipeline.scorer_designs import canonical_dynamic_weight_tensor

        kw["dynamic_weight_tensor"] = canonical_dynamic_weight_tensor()
    return kw


def p2_rank(rank, world, labels):
    """One rank of path P2 (gloo; every rank on the one card): per mode,
    the result, the launches of one query_batch (counts at 0 just before)
    and the step's ms (CUDA events)."""
    from hcrag_tpu_torch.parallel import (
        ShardedQueryEngine,
        make_batch_row_mesh,
        make_row_mesh,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    meshes = {"rows": make_row_mesh(device="cuda")}
    if "batch_mesh" in labels:
        meshes["batch"] = make_batch_row_mesh(2, world // 2, device="cuda")
    index, graph, queries = p2_setup()
    dq = torch.from_numpy(queries).to(meshes["rows"].device)
    out = {}
    for label in labels:
        opts, qopts, _ = P2_MODES[label]
        mesh = meshes["batch" if opts.get("shard_queries") else "rows"]
        engine = ShardedQueryEngine(index, graph, mesh=mesh, ell_max_degree=8, **opts)
        kw = p2_query_kwargs(qopts)
        zero_counts()
        res = engine.query_batch(queries, **kw)
        counts = read_counts()
        ms = cuda_ms(lambda: engine.query_batch_device(dq, **kw), reps=P2_REPS)
        out[label] = (res, counts, ms)
        del engine
        torch.cuda.empty_cache()
    return out


def path_p2(dev, card, rec) -> None:
    """Path P2: the sharded engine on 2 and 4 ranks spawned on the one card
    over gloo (NCCL refuses two ranks on one card), 262,144 x 384, B=1024:
    every rank's results equal rank 0's bit for bit and the unsharded
    engine's on the card; each mode launches its selection kernel and no B2
    (pools of 64 or 32 tiles x 10 stay under 4,096 candidates).  The step
    times are the ranks' on a shared card: no measure of collectives."""
    from hcrag_tpu_torch.parallel.launch import run_ranks
    from hcrag_tpu_torch.query.engine import QueryEngine

    t_phase = time.time()
    index, graph, queries = p2_setup()
    want = {}
    for label, (opts, qopts, _) in P2_MODES.items():
        plain_opts = {k: v for k, v in opts.items() if k not in ("shard_graph", "shard_queries")}
        engine = QueryEngine(index, graph, device=dev, ell_max_degree=8, **plain_opts)
        want[label] = engine.query_batch(queries, **p2_query_kwargs(qopts))
        del engine
    log(f"[P2] unsharded results of {len(P2_MODES)} modes on the card "
        f"({P2_ROWS} x {DIM}, B={P2_BATCH}) in {time.time() - t_phase:.1f} s")
    for world in P2_WORLDS:
        t0 = time.time()
        labels = [m for m in P2_MODES if world == 4 or m not in P2_FOUR_ONLY]
        ranks = run_ranks(p2_rank, world, args=(labels,), timeout_s=600)
        total = {name: 0 for name in KERNELS}
        for label in labels:
            res, counts, _ = ranks[0][label]
            for r in range(1, world):
                same_batch(ranks[r][label][0], res, f"P2 {world} ranks {label} rank {r}",
                           atol=0.0)
            same_batch(res, want[label], f"P2 {world} ranks {label}",
                       atol=1e-5 if label == "batch_mesh" else 0.0)
            kernel = P2_MODES[label][2]
            if counts[kernel] < 1 or counts["packed_candidate_merge"]:
                raise AssertionError(f"P2 {world} ranks {label}: launches {counts}")
            if label == "batch_mesh":  # other shapes: a shard of (batch, rows)
                rec.launches[f"P2-{world}-batch"] = counts
                continue
            for name, n in counts.items():
                total[name] += n
        rec.launches[f"P2-{world}"] = total
        times = ", ".join(f"{label} {ranks[0][label][2]:.1f}" for label in labels)
        log(f"[P2] {world} ranks (gloo, one card; {time.time() - t0:.1f} s with the "
            f"spawn): every rank == rank 0 bit for bit == the unsharded engine (batch "
            f"mesh: scores within 1e-5); no B2 launched; rank 0's launches over the row-"
            f"mesh modes {total}"
            + (f", over the batch mesh {ranks[0]['batch_mesh'][1]}"
               if "batch_mesh" in labels else ""))
        log(f"[P2] {world} ranks: step ms (ranks share one card; not a measure of "
            f"collectives): {times}; {card}")
    for world in P2_WORLDS:
        p2_kernels_at_shard(P2_ROWS // world, [(f"P2-{world}", queries)], dev, card, rec)
    # the 2 x 2 (batch, rows) mesh: each rank selects its 512 queries over
    # 131,072 rows (B4; its other modes are not run on that mesh)
    p2_kernels_at_shard(P2_ROWS // 2, [("P2-4-batch", queries[:P2_BATCH // 2])], dev, card,
                        rec, modes=("f32",))
    log(f"[P2] phase {time.time() - t_phase:.1f} s")


def p2_kernels_at_shard(rows, shapes, dev, card, rec, modes=None) -> None:
    """P2's selection kernels at one shard's shapes (`rows` rows, the first
    shard's, with P2's filter types; each (label, queries) of `shapes`)
    against their plain versions, in each P2 mode of `modes` (by default
    all but those whose
    kernel inputs repeat another's: `dynamic` and `graph_split_depth2` hand
    B4 what `f32` does): B4 (`b4_at_path`; `filter` with its category
    mask), B5 (`b5_at_path`), B1 (`int8_kernels_at_path` at the mode's own
    pool, `int8_rescore` or none in `int8_only`; 64 or 32 tiles x 10 take
    no B2), B7f and B7i (`super_at_path`).  A kernel run in several modes
    keeps the last mode's times in the summary."""
    from hcrag_tpu_torch.query.engine import QueryEngine

    index, graph, _ = p2_setup(rows)
    modes = modes or ("filter", "f32", "rescore", "rescore_super", "residual", "int8_only",
                      "int8", "int8_super")
    for mode in modes:
        opts, qopts, kernel = P2_MODES[mode]
        engine = QueryEngine(index, graph, device=dev, ell_max_degree=8, **opts)
        for label, queries in shapes:
            dq = torch.from_numpy(queries).to(dev)
            log(f"[{label}] mode {mode}: {rows} rows per shard, B={len(queries)}")
            if kernel == "float_tile_topk":
                b4_at_path(engine, dq, label, card, rec, qopts.get("category_filter"))
            elif kernel == "float_packed_tile_topk":
                b5_at_path(engine, dq, label, card, rec)
            elif kernel == "int8_tile_topk":
                int8_kernels_at_path(engine, dq, label, card, rec, engine._rescore_m(),
                                     with_merge=False)
            else:
                super_at_path(engine, dq, kernel, label, card, rec)
        del engine


#: Path P3: serving over 2 and 4 gloo ranks sharing the one card, P2's
#: index, the int8 + rescore (B1) and f32 (B4) modes of P2.
P3_MODES = ("int8", "f32")
P3_SIZES = (128, 256, 1024)  # dispatch sizes (batch 1024)
P3_REQUESTS, P3_SINGLES, P3_CLIENTS = 16_384, 256, 8  # retrieval: blocks, singles, clients
P3_FULL, P3_DEPTH = 4096, 3  # full mode: requests in blocks, expansion depth
P3_FAIL_ROWS, P3_FAIL_TIMEOUT_S, P3_FAIL_AT = 20_000, 10.0, 3  # the failure case
P3_LABEL = "ranks share one card over gloo: not a measure of serving across cards"


def p3_queries() -> np.ndarray:
    q = np.random.default_rng(13).standard_normal(
        (P3_REQUESTS + P3_SINGLES, DIM)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def served_fields(results) -> dict:
    """Served results stacked per field of `QueryBatchResult` (retrieval:
    scores and indices)."""
    if isinstance(results[0], tuple):
        return {"top_scores": np.stack([r[0] for r in results]),
                "top_indices": np.stack([r[1] for r in results])}
    return {f: np.stack([np.asarray(getattr(r, "expanded_count" if f == "expanded_counts"
                                            else f)) for r in results])
            for f in ("top_scores", "top_indices", "relevance", "combined", "expanded_nodes",
                      "expanded_counts", "expanded_relevance")}


def p3_traffic(ex, queries, kind) -> dict:
    """Rank 0's traffic: one batch of each dispatch size first (not
    timed); then in retrieval mode `P3_REQUESTS` requests in blocks of
    `E_BATCH` while `P3_CLIENTS` threads send `P3_SINGLES` single requests,
    each client waiting for its result before the next; in full mode
    `P3_FULL` requests in blocks.  Returns the results in request order,
    each batch's (dispatch size, request ids by slot), the blocks' req/s
    (to the last block request's resolve), and the single requests'
    latencies (submit -> resolve, ms)."""
    for s in P3_SIZES:
        ex.submit_many(queries[:s])[-1].result(timeout=E_WAIT_S)
    n = P3_REQUESTS if kind == "retrieval" else P3_FULL
    futs = [None] * (n + (P3_SINGLES if kind == "retrieval" else 0))
    lat = []

    def client(c):
        for i in range(n + c, len(futs), P3_CLIENTS):
            t = time.monotonic()
            f = ex.submit(queries[i])
            f.result(timeout=E_WAIT_S)
            lat.append((f.resolve_time - t) * 1e3)
            futs[i] = f

    threads = [threading.Thread(target=client, args=(c,)) for c in range(P3_CLIENTS)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for lo in range(0, n, E_BATCH):
        futs[lo:lo + E_BATCH] = ex.submit_many(queries[lo:lo + E_BATCH])
    for f in futs[:n]:
        f.result(timeout=E_WAIT_S)
    dt = max(f.resolve_time for f in futs[:n]) - t0
    for t in threads:
        t.join(E_WAIT_S)
    layout = {}
    for i, f in enumerate(futs):
        b = f._batch
        layout.setdefault(id(b), (len(b.payload[0]), {}))[1][f._slot] = i
    return dict(results=served_fields([f.result(timeout=1) for f in futs]),
                batches=[(b, [slots[j] for j in sorted(slots)]) for b, slots in layout.values()],
                rps=n / dt, lat_ms=lat)


def p3_rank(rank, world):
    """One rank of path P3 (gloo; every rank on the one card): per mode,
    `BatchedExecutor` over the sharded engine in retrieval and full mode
    (rank 0 runs `p3_traffic`, the others follow), each executor's batches,
    and the launches over both (counts at 0 just before)."""
    from hcrag_tpu_torch.parallel import ShardedQueryEngine, make_row_mesh
    from hcrag_tpu_torch.query.executor import BatchedExecutor

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    mesh = make_row_mesh(device="cuda")
    index, graph, _ = p2_setup()
    queries = p3_queries()
    out = {}
    for label in P3_MODES:
        engine = ShardedQueryEngine(index, graph, mesh=mesh, ell_max_degree=8,
                                    **P2_MODES[label][0])
        zero_counts()
        runs = {}
        for kind in ("retrieval", "full"):
            ex = BatchedExecutor(engine, batch_size=E_BATCH, batch_sizes=P3_SIZES,
                                 pipeline_depth=E_DEPTH, max_wait_ms=E_WAIT_MS, top_k=TOP_K,
                                 mode=kind, expansion_depth=P3_DEPTH)
            try:
                served = p3_traffic(ex, queries, kind) if rank == 0 else None
            finally:
                ex.shutdown()
            runs[kind] = (served, ex.batches_dispatched)
        out[label] = (runs, read_counts())
        del engine
        torch.cuda.empty_cache()
    return out


def p3_failure_rank(rank, world):
    """P3's failure case: a mesh with a `P3_FAIL_TIMEOUT_S` timeout over
    `P3_FAIL_ROWS` rows on the card; rank 1's step raises at its
    `P3_FAIL_AT`-th batch.  Rank 0 serves batches of 8 until then, then
    submits two more at once and once again after them."""
    import datetime

    from hcrag_tpu_torch.parallel import ShardedQueryEngine, make_row_mesh
    from hcrag_tpu_torch.query.executor import BatchedExecutor

    t0 = time.monotonic()
    mesh = make_row_mesh(device="cuda",
                         timeout=datetime.timedelta(seconds=P3_FAIL_TIMEOUT_S))
    index, graph, _ = p2_setup(P3_FAIL_ROWS)
    engine = ShardedQueryEngine(index, graph, mesh=mesh, ell_max_degree=8)
    if rank == 1:
        real, calls = engine.retrieve_batch_device, []

        def failing(q, top_k):
            calls.append(1)
            if len(calls) == P3_FAIL_AT:
                raise RuntimeError("injected step failure")
            return real(q, top_k=top_k)

        engine.retrieve_batch_device = failing
    q = p3_queries()
    out = {}
    ex = BatchedExecutor(engine, batch_size=8, top_k=TOP_K, max_wait_ms=E_WAIT_MS)
    try:
        if rank == 0:
            for lo in range(0, 8 * (P3_FAIL_AT - 1), 8):
                for f in ex.submit_many(q[lo:lo + 8]):
                    f.result(timeout=E_WAIT_S)
            out["later_failed"] = 0
            for f in ex.submit_many(q[8 * (P3_FAIL_AT - 1):8 * (P3_FAIL_AT + 1)]):
                try:
                    f.result(timeout=E_WAIT_S)
                except Exception:  # counted: every later request must fail
                    out["later_failed"] += 1
            try:
                ex.submit(q[0])
                out["submit"] = None
            except RuntimeError as e:
                out["submit"] = str(e)
    finally:
        try:  # past the timeout: a follower's loop ends only after it
            ex.shutdown(timeout=P3_FAIL_TIMEOUT_S + 20)
            out["shutdown"] = None
        except Exception as e:  # a follower's loop error, re-raised
            out["shutdown"] = repr(e)
    out["batches"] = ex.batches_dispatched
    out["seconds"] = time.monotonic() - t0
    return out


def path_p3(dev, card, rec) -> None:
    """Path P3: `BatchedExecutor` over the sharded engine on 2 and 4 gloo
    ranks spawned on the one card (the rank protocol; rank 0 serves, the
    others follow), P2's index, modes int8 + rescore (B1) and f32 (B4):
    every served result on rank 0 equals the unsharded engine's
    `query_batch` of its batch (the same dispatch size, zero-padded) on the
    card bit for bit; every rank steps every batch; each mode's kernel
    launches once per batch on rank 0 and no other kernel does; req/s and
    the single requests' p50 / p99.  Then the failure case (2 ranks, a
    short group timeout) and B1 / B4 at P3's smaller dispatch sizes per
    shard against their plain versions."""
    from hcrag_tpu_torch.parallel.launch import run_ranks
    from hcrag_tpu_torch.query.engine import QueryEngine

    t_phase = time.time()
    index, graph, _ = p2_setup()
    queries = p3_queries()
    plain = {label: QueryEngine(index, graph, device=dev, ell_max_degree=8,
                                **P2_MODES[label][0]) for label in P3_MODES}
    for world in P2_WORLDS:
        t0 = time.time()
        ranks = run_ranks(p3_rank, world, timeout_s=600)
        total = {name: 0 for name in KERNELS}
        for label in P3_MODES:
            runs, counts = ranks[0][label]
            stepped = 0
            for kind, (served, batches) in runs.items():
                others = [ranks[r][label][0][kind][1] for r in range(1, world)]
                if others != [batches] * (world - 1):
                    raise AssertionError(f"P3-{world} {label} {kind}: rank 0 stepped "
                                         f"{batches} batches, the others {others}")
                stepped += batches
                for b, ids in served["batches"]:
                    q = np.zeros((b, DIM), np.float32)
                    q[:len(ids)] = queries[ids]
                    ref = plain[label].query_batch(q, top_k=TOP_K, expansion_depth=P3_DEPTH)
                    for f, arr in served["results"].items():
                        if not np.array_equal(arr[ids], getattr(ref, f)[:len(ids)]):
                            raise AssertionError(f"P3-{world} {label} {kind}: {f} differs "
                                                 f"from the unsharded engine's")
                lat = np.asarray(served["lat_ms"])
                log(f"[P3-{world}] {label} {kind}: {len(served['results']['top_indices'])} "
                    f"requests in {len(served['batches'])} batches ({batches} with the "
                    f"warm-up) on every rank, each equal to the unsharded engine bit for bit; "
                    f"the blocks {served['rps']:.1f} req/s"
                    + (f"; {len(lat)} single requests from {P3_CLIENTS} clients: p50 "
                       f"{np.percentile(lat, 50):.3f} ms, p99 {np.percentile(lat, 99):.3f} ms "
                       f"(submit -> resolve)" if len(lat) else "")
                    + f" ({P3_LABEL}; {card})")
            kernel = P2_MODES[label][2]
            check_per_batch(counts, {kernel}, stepped, f"P3-{world} {label}")
            for name, n in counts.items():
                total[name] += n
        rec.launches[f"P3-{world}"] = total
        log(f"[P3] {world} ranks in {time.time() - t0:.1f} s with the spawn; rank 0's "
            f"launches {total}")
    del plain
    t0 = time.time()
    fail = run_ranks(p3_failure_rank, 2, timeout_s=300)
    bound = P3_FAIL_TIMEOUT_S + 30
    if not (fail[0]["later_failed"] == 16 and "failed across ranks" in fail[0]["submit"]
            and fail[0]["shutdown"] is None and "injected" in fail[1]["shutdown"]
            and [r["batches"] for r in fail] == [P3_FAIL_AT - 1] * 2
            and all(r["seconds"] < bound for r in fail)):
        raise AssertionError(f"P3 failure case: {fail}")
    seconds = ", ".join(f"{r['seconds']:.2f}" for r in fail)
    log(f"[P3] failure case (2 ranks, group timeout {P3_FAIL_TIMEOUT_S:.0f} s): rank 1's "
        f"step raised at batch {P3_FAIL_AT}; rank 0 failed that batch and the next, a later "
        f"submit raised, rank 1's shutdown re-raised; the ranks returned in {seconds} s "
        f"(bound {bound:.0f} s); {time.time() - t0:.1f} s with the spawn")
    for world in P2_WORLDS:
        shapes = [(f"P3-{world}@{b}", queries[:b]) for b in P3_SIZES[:2]]
        for label, _ in shapes:  # P3-{world}'s launches, at each of its shapes
            rec.launches[label] = rec.launches[f"P3-{world}"]
        p2_kernels_at_shard(P2_ROWS // world, shapes, dev, card, rec, modes=P3_MODES)
    log(f"[P3] phase {time.time() - t_phase:.1f} s")


def bm_script(label, run, expected, card, rec, counts=None):
    """One script's `run()` on the card (path BM), every launch counter at 0
    just before it and read just after (or, for a script whose kernels
    launch in its ranks, `counts(result)`: rank 0's); every kernel in
    `expected` must have launched.  Prints the script's JSON line and
    returns its result."""
    zero_counts()
    t0 = time.time()
    res = run()
    secs = time.time() - t0
    launches = read_counts()
    if counts is not None:
        launches.update(counts(res))
    rec.launches[label] = launches
    for name in expected:
        if launches[name] < 1:
            raise AssertionError(f"path {label} never launched {name}")
    log(f"[{label}] run() in {secs:.1f} s (host clock, set-up included); launches "
        f"{launches}; {card}")
    log(f"[{label}] {json.dumps(res)}")
    return res


def unit_rows(n, d, dev, seed, dtype=torch.float32):
    """[n, d] normalized normal rows drawn on the card (a kernel's operands
    at a script's shapes)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((n, d), generator=g, device=dev)
    return torch.nn.functional.normalize(x, dim=1).to(dtype)


def path_bm_engine(index, graph, graph8, dev, card, rec) -> None:
    """Path BM over the 1M index: the ablation script (the bf16 rows, B4,
    the step at max_expanded 20 and 1) and the expansion-heavy script (the
    degree-8 graph of path X), each from its `run()` at the JAX sizes, then
    their kernels at the scripts' shapes against their plain versions."""
    from hcrag_tpu_torch.benchmarks import ablation, expansion_heavy
    from hcrag_tpu_torch.ops import topk_cuda as tc

    x = ablation.setup(dev, index=index, graph=graph)
    res = bm_script("BM-ablation", lambda: ablation.run(dev, data=x), ("float_tile_topk",),
                    card, rec)
    calls = ablation.variants(x)
    _, fused = calls[ablation.FUSED]()
    _, streamed = calls[ablation.select_label(N_ROWS)]()
    agree = recall(streamed.cpu().numpy(), fused.cpu().numpy())
    log(f"[BM-ablation] B4's top-10 against the streaming selection's: {agree:.5f} "
        f"(both exact over the bf16 rows; gate {MIN_RECALL}); stages ms "
        f"{ {k: v for k, v in res.items() if k not in ('device', 'shapes')} }")
    if agree < MIN_RECALL:
        raise AssertionError(f"BM-ablation: B4 and the streaming selection agree {agree}")
    b4_at(x["q"].to(torch.bfloat16), x["e_pad"], x["mask_pad"], "BM-ablation", card, rec)
    del x, calls
    free("BM-ablation")
    x = expansion_heavy.setup(dev, index=index, graph=graph8)
    bm_script("BM-expansion", lambda: expansion_heavy.run(dev, data=x),
              ("float_packed_tile_topk", "packed_candidate_merge"), card, rec)
    e = x["engine"].d_emb
    k = tc.tile_pick_count(X_TOP_K, e.shape[0], 2048, 0)
    kv, ki = b5_at(x["q"].to(torch.bfloat16), e, path_mask(e.shape[0], N_ROWS, dev), k,
                   "BM-expansion", card, rec)
    merge_at_path(kv, ki, X_TOP_K, "BM-expansion", card, rec)


def path_bm(dev, card, rec) -> None:
    """Path BM: the root benchmark scripts' `run()` on the card
    (`hcrag_tpu_torch/benchmarks/`), each at its JAX size but
    sharded_10m (1,048,576 rows over 2 ranks), with its own checks; then
    every kernel each launches, at its shapes, against its plain version."""
    from hcrag_tpu_torch.benchmarks import (
        dispatch_floor,
        hbm_bandwidth,
        merge_micro,
        reranker_eval,
        scoring_ablation,
        sharded_10m,
        sharded_traffic,
        twolevel_ablation,
    )
    from hcrag_tpu_torch.core.types import PRIORITY_MATRIX
    from hcrag_tpu_torch.ops import scoring_cuda as sc
    from hcrag_tpu_torch.ops import topk_cuda as tc
    from hcrag_tpu_torch.ops.quantize import quantize_bank, quantize_queries

    t_phase = time.time()
    res = bm_script("BM-hbm", lambda: hbm_bandwidth.run(dev), (), card, rec)
    rates = {k: v for k, v in res.items() if k.startswith(("xla_", "folded_"))}
    if not all(np.isfinite(v) and v > 0 for v in rates.values()):
        raise AssertionError(f"BM-hbm: rates {rates}")
    log(f"[BM-hbm] GiB/s {rates}; the bounds assume {res['assumed_peak_gib_s']:.1f}; {card}")

    res = bm_script("BM-dispatch", lambda: dispatch_floor.run(dev),
                    ("float_packed_tile_topk", "packed_candidate_merge"), card, rec)
    log(f"[BM-dispatch] t(N) = a + dN: host clock a {res['fit_dispatch_overhead_ms']:.4f} ms, "
        f"d {res['fit_device_ms_per_1M_rows']:.4f} ms per 2^20 rows; events a "
        f"{res['fit_event_overhead_ms']:.4f} ms, d {res['fit_event_ms_per_1M_rows']:.4f}; "
        f"{card}")
    n = dispatch_floor.SIZES[-1]
    qb = unit_rows(dispatch_floor.B, dispatch_floor.D, dev, 1, torch.bfloat16)
    e = unit_rows(n, dispatch_floor.D, dev, 2, torch.bfloat16)
    k = tc.tile_pick_count(TOP_K, n, 2048, RESCORE)
    kv, ki = b5_at(qb, e, torch.ones(n, dtype=torch.bool, device=dev), k, "BM-dispatch",
                   card, rec)
    merge_at_path(kv, ki, RESCORE, "BM-dispatch", card, rec)
    del qb, e, kv, ki

    bm_script("BM-merge", lambda: merge_micro.run(dev), ("packed_candidate_merge",), card, rec)
    v, i = merge_micro.pool(dev)
    b, c = v.shape
    merge_at_path(v.view(b, c, 1), i.view(b, c, 1), merge_micro.M, "BM-merge", card, rec)
    # B2 orders by the packed key: where its set differs from torch.topk's,
    # the two 32nd values lie within one key quantum (2^-11 of v + 2 < 8).
    (pv, pi), (tv, ti) = merge_micro.packed_merge(v, i), merge_micro.torch_topk(v, i)
    moved = (torch.sort(pi, 1).values != torch.sort(ti, 1).values).any(1)
    gap = float((pv[moved, -1] - tv[moved, -1]).abs().max()) if moved.any() else 0.0
    log(f"[BM-merge] B2's sets equal torch.topk's but in {int(moved.sum())} of {b} rows, "
        f"whose 32nd values lie {gap:.3g} apart (a key quantum: 2^-10 at most)")
    if gap > 2.0**-10:
        raise AssertionError(f"BM-merge: B2 and torch.topk part by {gap} at the boundary")

    bm_script("BM-scoring", lambda: scoring_ablation.run(dev), ("batch_relevance",), card, rec)
    rng = np.random.default_rng(3)
    prio = torch.from_numpy(PRIORITY_MATRIX).to(dev)
    w = torch.tensor(scoring_ablation.WEIGHTS, dtype=torch.float32, device=dev)
    for n_nodes in scoring_ablation.NODES:
        x = scoring_ablation.draw(rng, n_nodes)
        t = {k: torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a).to(dev)
             for k, a in x.items()}
        args = [t["q_emb"], t["q_bits"], t["q_counts"], t["intents"], t["n_emb"], t["n_bits"],
                t["n_counts"], t["n_types"], w, prio, None]
        got, want = sc.batch_relevance(*args), sc.batch_relevance_plain(*args)
        err = float((got - want).abs().max())
        if not err <= 1e-5:
            raise AssertionError(f"BM-scoring: B6 at N={n_nodes} {err} from its plain version")
        rec.err("batch_relevance", err)
        b6_at(args, 0, f"BM-scoring@n{n_nodes}", f"{scoring_ablation.B} x {n_nodes}", card,
              rec)

    x = twolevel_ablation.banks(dev)
    res = bm_script("BM-twolevel", lambda: twolevel_ablation.run(dev, data=x),
                    ("int8_tile_topk", "packed_candidate_merge", "float_tile_topk",
                     "float_packed_tile_topk", "int8_exact_tile_topk"), card, rec)
    top10 = res["int8_two_level_top10_in_merge32_vs_f32_brute"]
    log(f"[BM-twolevel] ms per call {res['ms']}; f32 top-10 inside the int8 merge-32: {top10} "
        f"(gate {MIN_RECALL}); {card}")
    if top10 < MIN_RECALL:
        raise AssertionError(f"BM-twolevel: top-10 in merge-32 {top10} below {MIN_RECALL}")
    n = x["e"].shape[0]
    q8, qs = quantize_queries(x["q"])
    qb = x["q"].to(torch.bfloat16)
    k = tc.tile_pick_count(TOP_K, n, 2048, RESCORE)
    kv, ki = b1_at(q8, qs, x["e8"], x["sc"], x["mask"], k, "BM-twolevel", card, rec)
    merge_at_path(kv, ki, RESCORE, "BM-twolevel", card, rec)
    b4_at(qb, x["e_bf16"], x["mask"], "BM-twolevel", card, rec)
    kv, ki = b5_at(qb, x["e_bf16"], x["mask"], k, "BM-twolevel", card, rec)
    merge_at_path(kv, ki, RESCORE, "BM-twolevel@b5", card, rec)
    b3e_at(q8, qs, x["e8"], x["sc"], x["mask"], TOP_K, "BM-twolevel", card, rec)
    del x, q8, qs, qb, kv, ki
    free("BM-twolevel")

    res = bm_script("BM-reranker", lambda: reranker_eval.run(dev), ("float_tile_topk",),
                    card, rec)
    ndcg = {k: res[k] for k in ("ndcg10_cosine_order", "ndcg10_baseline", "ndcg10_reranked")}
    if not all(0.0 <= v <= 1.0 for v in ndcg.values()):
        raise AssertionError(f"BM-reranker: NDCG@10 {ndcg}")
    log(f"[BM-reranker] NDCG@10 over the seeded corpus ({res['rows']} rows): {ndcg}, lift "
        f"{res['lift']:.6f}; {card}")
    mask = torch.zeros(2048, dtype=torch.bool, device=dev)
    mask[:res["rows"]] = True
    b4_at(unit_rows(reranker_eval.TEST, DIM, dev, 3), unit_rows(2048, DIM, dev, 4), mask,
          "BM-reranker", card, rec, k=reranker_eval.TOP_M)

    def rank0_b4(res):
        return {"float_tile_topk": sum(res[f"shards_{s}"]["launches"]["float_tile_topk"]
                                       for s in BM_SHARDS)}

    res = bm_script("BM-traffic", lambda: sharded_traffic.run(dev, shards=BM_SHARDS),
                    ("float_tile_topk",), card, rec, counts=rank0_b4)
    summary_ = res["summary"]
    if not (summary_["matches_model"] and summary_["top10_equals_f32_brute"]
            and summary_["rescore_traffic_constant_in_shards"]
            and summary_["merge_traffic_scales_linearly_in_shards"]):
        raise AssertionError(f"BM-traffic: {summary_}")
    for s in BM_SHARDS:
        rows = sharded_traffic.N // s
        b4_at(unit_rows(sharded_traffic.B, sharded_traffic.D, dev, 5),
              unit_rows(rows, sharded_traffic.D, dev, 6),
              torch.ones(rows, dtype=torch.bool, device=dev), f"BM-traffic@{s}", card, rec,
              k=sharded_traffic.M)

    modes = tuple(sharded_10m.MODES)

    def rank0_10m(res):
        out = {}
        for mode in modes:
            for name, c in res[mode]["launches_by_rank"][0].items():
                out[name] = out.get(name, 0) + c
        return out

    res = bm_script("BM-10m", lambda: sharded_10m.run(dev, n=BM_10M_ROWS, ranks=BM_10M_RANKS,
                                                      modes=modes),
                    ("int8_tile_topk", "float_packed_tile_topk"), card, rec, counts=rank0_10m)
    for mode in modes:
        r = res[mode]["recall_at_10"]
        log(f"[BM-10m] {mode}: recall@10 {r} (gate {MIN_RECALL}), step ms by rank "
            f"{res[mode]['step_ms_by_rank']}, peak device GiB by rank "
            f"{res[mode]['peak_device_gib_by_rank']}, peak host RSS GiB by rank "
            f"{res[mode]['peak_host_rss_gib_by_rank']}, host GiB added a rank "
            f"{res[mode]['host_gib_added_per_rank']}; {card}")
        if r < MIN_RECALL:
            raise AssertionError(f"BM-10m {mode}: recall {r} below {MIN_RECALL}")
    rows = res[modes[0]]["n_padded"] // BM_10M_RANKS
    e = unit_rows(rows, DIM, dev, 7)
    q = unit_rows(sharded_10m.BATCH, DIM, dev, 8)
    mask = torch.ones(rows, dtype=torch.bool, device=dev)
    k = tc.tile_pick_count(TOP_K, rows, 2048, RESCORE)
    b5_at(q.to(torch.bfloat16), e.to(torch.bfloat16), mask, k, "BM-10m", card, rec)
    e8, es = quantize_bank(e, dev)
    q8, qs = quantize_queries(q)
    b1_at(q8, qs, e8, es, mask, k, "BM-10m", card, rec)
    log(f"[BM] phase {time.time() - t_phase:.1f} s")


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

    # the offline build path: corpus -> graph + index -> CLI and engine ----
    import tempfile

    from hcrag_tpu_torch import native

    t0 = time.time()
    built = native.build()
    log(f"[build] native host libraries {built} in {time.time() - t0:.1f} s (g++)")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        path_b(dev, card, rec, tmp)
        path_pv(dev, card, rec, tmp)
        path_g(dev, card, rec, tmp)
        path_b_scale(dev, card, rec, tmp)
        log(f"[B] paths B, G and B at scale in {time.time() - t0:.1f} s")
        path_ex(tmp)
        free("B")
        path_t(dev, card, rec, tmp)
    free("T")
    path_ge(dev, card, rec)
    free("GE")

    # 4-7. the paths over one 1M-row index --------------------------------------
    t0 = time.time()
    index, graph = synthetic_setup(N_ROWS, DIM, graph_degree=4)
    log(f"[setup] synthetic index {N_ROWS} x {DIM} + graph built in "
        f"{time.time() - t0:.1f} s (host)")
    rng = np.random.default_rng(7)
    queries = rng.standard_normal((BATCH, DIM)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    ref = brute_force_top_k(index.emb, queries, dev)
    engine = path_int8(index, graph, queries, ref, dev, card, rec)
    path_e(engine, dev, card, rec)
    path_rr(engine, index, dev, card, rec)
    del engine
    free("int8")
    path_p1(index, graph, queries, ref, dev, card, rec)
    path_f2(index, graph, queries, ref, dev, card, rec)
    free("F2")
    for label in ("S1", "S2"):
        path_super(label, index, graph, queries, ref, dev, card, rec)
        free(label)
    path_p2(dev, card, rec)
    free("P2")
    path_p3(dev, card, rec)
    free("P3")
    f1_q = np.random.default_rng(8).standard_normal((F1_BATCH, DIM)).astype(np.float32)
    f1_q /= np.linalg.norm(f1_q, axis=1, keepdims=True)
    engine = path_f1(index, graph, brute_force_top_k(index.emb, f1_q, dev), dev, card, rec)
    path_a(engine, index, graph, dev, card, rec)
    path_m(engine, index, graph, dev, card, rec)
    del engine
    free("M")
    graph8 = path_x(index, queries, dev, card, rec)
    free("X")
    path_large_k(index, graph, queries, dev, card, rec)
    path_bm_engine(index, graph, graph8, dev, card, rec)
    del graph8
    free("BM-expansion")
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

    # the root benchmark scripts --------------------------------------------
    path_bm(dev, card, rec)
    free("BM")

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
