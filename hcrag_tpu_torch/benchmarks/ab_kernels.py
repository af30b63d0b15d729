"""Time the per-tile top-k kernels and B6 of two source trees in one process.

    python -m hcrag_tpu_torch.benchmarks.ab_kernels PARENT_DIR CHANGE_DIR

Each directory holds a checkout of the repository (for example two
`git archive` trees).  Their `hcrag_tpu_torch/csrc/int8_tile_topk.cu`,
`float_tile_topk.cu` and `batch_relevance.cu` are built with this package's
nvcc flags into its build directory and loaded side by side, and each
kernel below is called from both libraries on the same tensors, in
alternating turns (TURNS turns a tree, CALLS calls a turn, CUDA events; a
turn of B6 replays B6_CALLS launches from a CUDA graph, since one launch at
b = 1 takes less time than the host takes to issue it): a comparison of two
versions of a kernel that no other process or card can disturb.  The inputs
are normalized random rows and queries made on the card from a seed, at the
shapes of the `chip_smoke.py` paths that run each kernel:

  B1   int8_tile_topk               path int8: B=8192 over 1,001,472 rows, k=10
  B3e  int8_exact_tile_topk         the int8 path's bank: B=2048, k=10
  B7i  int8_super_tile_topk         path S2: 8192-row supertiles, k_sub=16
  B5   float_packed_tile_topk       path F2 (bf16 bank, k=10), path X (B=256, k=100)
  B7f  float_packed_super_tile_topk path S1: 8192-row supertiles, k_sub=16
  B4   float_tile_topk              path F1 (f32 bank, B=1024, k=10), path K
                                    (bf16 bank, B=512, k=10), kg1m_bf16's
                                    batch1k (bf16, B=1024, k=10) and graph3
                                    (bf16, B=512, k=100)
  B6   batch_relevance              path R (1 x 8192 nodes, W=8, llm column),
                                    the JAX ablation (256 x 8192 nodes)

It prints one JSON line: for each case both trees' ms per call by turn,
their medians, and whether their outputs are bit-equal (B6: within 1e-5,
its f32 dot sums in another order); for each kernel
instantiation of the two libraries (`cuobjdump -sass`), its instruction
count in each and how many instructions differ by opcode.  Needs a card
and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import difflib
import json
import os
import subprocess
import sys
from pathlib import Path
from typing import Dict

import torch

from hcrag_tpu_torch.device import resolve_device
from hcrag_tpu_torch.ops import _build
from hcrag_tpu_torch.ops.quantize import quantize_bank, quantize_queries
from hcrag_tpu_torch.ops.topk_cuda import _SIGNATURES

TURNS, CALLS = 8, 3
N_ROWS, N_BANK, DIM = 1_000_000, 1_007_616, 384
N_TILED = 1_001_472  # N_ROWS in whole 2048-row tiles
SOURCES = ("int8_tile_topk", "float_tile_topk", "batch_relevance")
#: case -> (entry point, queries, per-tile k, tile or supertile rows, bank
#: type, bank rows)
CASES = {
    "int8 B1": ("int8_tile_topk", 8192, 10, 2048, "int8", N_BANK),
    "S2 B7i": ("int8_super_tile_topk", 8192, 16, 8192, "int8", N_BANK),
    "F2 B5": ("float_packed_tile_topk", 8192, 10, 2048, "bf16", N_BANK),
    "S1 B7f": ("float_packed_super_tile_topk", 8192, 16, 8192, "bf16", N_BANK),
    "X B5": ("float_packed_tile_topk", 256, 100, 2048, "bf16", N_BANK),
    "F1 B4": ("float_tile_topk", 1024, 10, 2048, "f32", N_TILED),
    "K B4": ("float_tile_topk", 512, 10, 2048, "bf16", N_TILED),
    "batch1k B4": ("float_tile_topk", 1024, 10, 2048, "bf16", N_TILED),
    "graph3 B4": ("float_tile_topk", 512, 100, 2048, "bf16", N_TILED),
    "int8 B3e": ("int8_exact_tile_topk", 2048, 10, 2048, "int8", N_TILED),
}
#: B6 case -> (queries, nodes); W = 8 words, D = 384, with an llm column.
B6_CASES = {"R B6": (1, 8192), "ablation B6": (256, 8192)}
B6_TOLERANCE = 1e-5
B6_CALLS = 20  # launches a graph replays: a replay's own cost spread thin


def build(trees: Dict[str, Path]) -> Dict[str, Dict[str, Path]]:
    """{tree: {source: library}}, every library built at once."""
    out_dir = _build.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs, libs = [], {}
    for tree, root in trees.items():
        for src in SOURCES:
            lib = out_dir / f"lib{src}-{tree}-{os.getpid()}.so"
            cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib),
                   str(root / "hcrag_tpu_torch" / "csrc" / f"{src}.cu")]
            procs.append((subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True), src, tree))
            libs.setdefault(tree, {})[src] = lib
    for proc, src, tree in procs:
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {tree}'s {src}.cu:\n{out}")
    return libs


def compare_sass(a: Path, b: Path) -> Dict[str, Dict]:
    """Per kernel of both libraries (`_build.sass_opcodes`; the tensor-core
    kernel's Bf16 tag dropped, which a tree from before the int8 kernels
    shared its template does not carry): instruction counts and how many
    instructions differ by opcode."""
    def by_label(lib):
        return {k.replace(",Bf16", ""): v for k, v in _build.sass_opcodes(lib).items()}
    ops_a, ops_b = by_label(a), by_label(b)
    out = {}
    for name in sorted(set(ops_a) & set(ops_b)):
        sm = difflib.SequenceMatcher(None, ops_a[name], ops_b[name], autojunk=False)
        same = sum(block.size for block in sm.get_matching_blocks())
        out[name] = {"instructions": [len(ops_a[name]), len(ops_b[name])],
                     "differing": max(len(ops_a[name]), len(ops_b[name])) - same}
    return out


def inputs(dev: torch.device, seed: int = 1) -> Dict[str, torch.Tensor]:
    """The bank (f32, bf16, and int8 with its scales), a row filter and
    queries (f32, bf16, and int8 with their scales), made on the card."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    e = torch.nn.functional.normalize(torch.randn(N_BANK, DIM, device=dev, generator=g), dim=1)
    q = torch.nn.functional.normalize(torch.randn(8192, DIM, device=dev, generator=g), dim=1)
    e8, e_scale = quantize_bank(e, dev)
    q8, q_scale = quantize_queries(q)
    mask = torch.zeros(N_BANK, dtype=torch.bool, device=dev)
    mask[:N_ROWS] = True
    return dict(f32=(q, e), bf16=(q.to(torch.bfloat16), e.to(torch.bfloat16)), e8=e8,
                e_scale=e_scale, q8=q8, q_scale=q_scale, mask=mask)


def time_cases(libs: Dict[str, Dict[str, Path]], dev: torch.device) -> Dict[str, Dict]:
    """Every case of CASES from both trees' libraries, in alternating turns."""
    t = inputs(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    fns = {}
    for tree, by_src in libs.items():
        loaded = {src: ctypes.CDLL(str(path)) for src, path in by_src.items()}
        for name, *_ in CASES.values():
            fn = getattr(loaded["int8_tile_topk" if "int8" in name else "float_tile_topk"], name)
            fn.argtypes = _SIGNATURES[name]
            fn.restype = ctypes.c_int
            fns[tree, name] = fn
    out = {}
    for case, (name, b, k, rows, bank, n) in CASES.items():
        tiles = -(-n // rows)
        calls, outs = {}, {}
        for tree in libs:
            ov = torch.empty((b, tiles, k), dtype=torch.float32, device=dev)
            oi = torch.empty((b, tiles, k), dtype=torch.int32, device=dev)
            if bank == "int8":
                args = (t["q8"][:b].data_ptr(), t["q_scale"][:b].data_ptr(), t["e8"].data_ptr(),
                        t["e_scale"].data_ptr(), t["mask"].data_ptr(), ov.data_ptr(),
                        oi.data_ptr(), b, n, DIM, k, rows, stream)
            else:
                q, e = t[bank]
                args = (q[:b].data_ptr(), e.data_ptr(), t["mask"].data_ptr(), ov.data_ptr(),
                        oi.data_ptr(), b, n, DIM, k, rows, int(bank == "bf16"), stream)
            calls[tree] = (fns[tree, name], args)
            outs[tree] = (ov, oi)
        for fn, args in calls.values():
            if fn(*args):
                raise RuntimeError(f"{case}: launch failed")
        torch.cuda.synchronize()
        first, second = (outs[tree] for tree in libs)
        equal = bool(torch.equal(first[1], second[1])
                     and torch.equal(first[0].view(torch.int32), second[0].view(torch.int32)))
        ms = {tree: [] for tree in libs}
        order = list(libs)
        for turn in range(TURNS):
            for tree in (order if turn % 2 == 0 else order[::-1]):
                fn, args = calls[tree]
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(CALLS):
                    fn(*args)
                end.record()
                torch.cuda.synchronize()
                ms[tree].append(start.elapsed_time(end) / CALLS)
        out[case] = {"ms": ms, "median_ms": {tree: sorted(v)[TURNS // 2] for tree, v in ms.items()},
                     "outputs_bit_equal": equal}
    return out


def _b6_operands(b: int, n: int, dev: torch.device, seed: int = 2):
    """B6's operands in its C entry point's order (q, q_bits, q_count,
    intent, weights, priority, e, n_bits, n_count, n_type, llm), made on
    the card: normalized rows, random bit words and counts, intents and
    types in the priority table."""
    from hcrag_tpu_torch.core.types import PRIORITY_MATRIX

    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def words(rows):
        return torch.randint(-2**31, 2**31 - 1, (rows, 8), device=dev, generator=g,
                             dtype=torch.int64).to(torch.int32)

    q = torch.nn.functional.normalize(torch.randn(b, DIM, device=dev, generator=g), dim=1)
    e = torch.nn.functional.normalize(torch.randn(n, DIM, device=dev, generator=g), dim=1)
    return (q, words(b), torch.randint(0, 40, (b,), device=dev, generator=g, dtype=torch.int32),
            torch.randint(0, 5, (b,), device=dev, generator=g, dtype=torch.int32),
            torch.tensor([0.3, 0.45, 0.15, 0.1], device=dev),
            torch.from_numpy(PRIORITY_MATRIX).to(dev), e, words(n),
            torch.randint(0, 40, (n,), device=dev, generator=g, dtype=torch.int32),
            torch.randint(0, 6, (n,), device=dev, generator=g, dtype=torch.int32),
            torch.rand(b, n, device=dev, generator=g))


def time_b6(libs: Dict[str, Dict[str, Path]], trees: Dict[str, Path],
            dev: torch.device) -> Dict[str, Dict]:
    """The B6 cases from both trees' libraries, in alternating turns of
    B6_CALLS launches replayed from a CUDA graph.  A tree whose
    `batch_relevance.cu` predates the launch plan takes no plan arguments;
    a later one takes this package's plan for the shape."""
    from hcrag_tpu_torch.ops.scoring_cuda import SIGNATURE, launch_plan
    from hcrag_tpu_torch.utils.timing import graph_ms

    out = {}
    for case, (b, n) in B6_CASES.items():
        ops = _b6_operands(b, n, dev)
        plan = launch_plan(ops[0], ops[6], 8)
        calls, outs = {}, {}
        for tree, by_src in libs.items():
            fn = ctypes.CDLL(str(by_src["batch_relevance"])).batch_relevance
            planned = "queries_per_block" in (
                trees[tree] / "hcrag_tpu_torch" / "csrc" / "batch_relevance.cu").read_text()
            fn.argtypes = SIGNATURE if planned else SIGNATURE[:17] + SIGNATURE[19:]
            fn.restype = ctypes.c_int
            res = torch.empty((b, n), dtype=torch.float32, device=dev)
            args = [t.data_ptr() for t in ops] + [res.data_ptr(), b, n, DIM, 8, 0]
            args += [plan.queries, int(plan.vec)] if planned else []
            # The stream is read at each call: a graph captures on its own.
            calls[tree] = (lambda fn=fn, args=args:
                           fn(*args, torch.cuda.current_stream(dev).cuda_stream))
            if calls[tree]():
                raise RuntimeError(f"{case}: {tree}'s launch failed")
            outs[tree] = res
        torch.cuda.synchronize()
        first, second = (outs[tree] for tree in libs)
        err = float((first - second).abs().max())
        ms = {tree: [] for tree in libs}
        order = list(libs)
        for turn in range(TURNS):
            for tree in (order if turn % 2 == 0 else order[::-1]):
                ms[tree].append(graph_ms(calls[tree], calls=B6_CALLS, replays=1))
        if not err <= B6_TOLERANCE:
            raise AssertionError(f"{case}: the trees' outputs differ by {err}")
        out[case] = {"ms": ms, "median_ms": {tree: sorted(v)[TURNS // 2] for tree, v in ms.items()},
                     "max_abs_diff": err, "plan": plan._asdict()}
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("parent", type=Path, help="checkout whose kernels come first")
    parser.add_argument("change", type=Path, help="checkout to compare with it")
    args = parser.parse_args(argv)
    dev = resolve_device("cuda")
    trees = {"parent": args.parent, "change": args.change}
    libs = build(trees)
    result = {
        "device": torch.cuda.get_device_name(dev),
        "cases": {**time_cases(libs, dev), **time_b6(libs, trees, dev)},
        "sass": {src: compare_sass(libs["parent"][src], libs["change"][src])
                 for src in SOURCES},
    }
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
