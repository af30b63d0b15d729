"""10M rows over ranks: the sharded engine's recall, step and memory per rank.

    python -m hcrag_tpu_torch.benchmarks.sharded_10m [--mode M] [--ranks R]   # one NVIDIA GPU
    python -m hcrag_tpu_torch.benchmarks.sharded_10m --device cpu             # a small size

Counterpart of `benchmarks/sharded_10m.py` (`BASELINE.md`'s configuration
5, 10M nodes sharded).  The JAX script runs the sharded engine on an
8-device virtual CPU mesh; the port runs `ShardedQueryEngine` in `--ranks`
processes (default 4), gloo ranks spawned by `parallel/launch.run_ranks`,
which on the card all share it: the ranks hold their blocks of rows on
the one card, and no collective crosses a wire.

The data are the JAX script's: `utils.synthetic.synthetic_bank(n, dim,
seed=0)` (the rows of `synthetic_dense_index`), a degree-8 graph (numpy
`default_rng(3)`: 8 random edges out of every node, DESCRIBED_BY or
ANNOTATION, symmetrized) split over the ranks (`shard_graph=True`), and
B = 16 queries (`default_rng(7)`): 8 stored rows, then 8 random
directions.  This process draws the rows once into a `.npy` file in a
temporary directory and writes the graph's arrays beside it; each rank
maps them read-only (`np.load(mmap_mode="r")`), so the host holds one
copy of the rows (15.4 GB of f32 at 10M x 384) whatever the rank count.

Modes (`--mode`, one or both comma-separated): `bf16_rescore`
(`exact_rescore=32`: kernels B5 + B2 on each rank, the f32 rescore) and
`int8_residual` (`quantize_int8=True, int8_residual=True,
int8_rescore=32`: kernels B1 + B2, the int8 + residual
rescore).  For each it checks, as the JAX script does, that the expansion
finds nodes and that every stored-row query ranks its own row first
(raises otherwise), and gives recall@10 against the f32 brute force, the
per-rank memory reckoning under the JAX keys (`per_chip_*`: the selection
and rescore blocks, the whole feature tables, the graph's block), and
what the JAX script cannot measure: each rank's step in ms (CUDA events,
`query_batch_device`, 5 calls after a warm-up), its peak device GiB, its
peak resident host memory by the end of the mode (`_common.PeakRss`,
sampled every 20 ms; beside that of this process, which drew the data:
every process counts the pages of the shared map that it touched), and
its kernel launches during one `query_batch`.  What the ranks hold beyond
the one shared copy is read off the whole machine (`_common.host_used_gib`:
MemTotal less MemAvailable, sampled likewise): its use just before the
ranks start (this process and the page cache of the rows),
`host_used_gib_before_ranks`; its peak while they run,
`peak_host_used_gib_with_ranks`; and the difference over the ranks,
`host_gib_added_per_rank`, each rank's own footprint.  The
JAX entry's `modeled_sharded_latency` (a TPU interconnect model over an
assumed link rate) has no counterpart and is left out.

The JAX script's variables are flags: `--n` (BENCH10M_N, 10,000,000),
`--dim` (BENCH10M_DIM, 384), `--mode` (BENCH10M_MODE, bf16_rescore),
`--graph` (BENCH10M_GRAPH, 1).  `--device cpu` runs 20,000 rows over 2
ranks.  Nothing is written but `--out` and the temporary
directory.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time
import warnings
from typing import Dict, Sequence, Union

import numpy as np
import torch

from hcrag_tpu_torch.benchmarks._common import (
    brute_force_top_k,
    device_of,
    finish,
    host_used_gib,
    log,
    ms,
    PeakRss,
    parser,
    recall,
)

TOP_K, BATCH, DEGREE, RESCORE = 10, 16, 8, 32
MODES = {
    # mode: (engine options, selection bytes a value, rescore bytes a value, rescore bank)
    "bf16_rescore": (dict(exact_rescore=RESCORE), 2, 4, "f32 rescore"),
    "int8_residual": (dict(quantize_int8=True, int8_residual=True, int8_rescore=RESCORE),
                      1, 1, "int8 residual"),
}
KERNELS = {"bf16_rescore": ("float_packed_tile_topk", "packed_candidate_merge"),
           "int8_residual": ("int8_tile_topk", "packed_candidate_merge")}
CPU_SIZE = dict(n=20_000, ranks=2)
_GRAPH_ARRAYS = ("row_ptr", "col_idx", "edge_type")


class _RowsOf:
    """A read-only sequence whose i-th item is `fn(i)`: the synthetic
    index's metadata and texts, made on demand instead of held."""

    def __init__(self, n: int, fn):
        self.n, self.fn = n, fn

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self.fn(j) for j in range(*i.indices(self.n))]
        if not -self.n <= i < self.n:
            raise IndexError(i)
        return self.fn(i % self.n)

    def __iter__(self):
        return (self.fn(i) for i in range(self.n))


def write_data(root: str, n: int, dim: int, with_graph: bool) -> None:
    """The rows (drawn straight into `root/emb.npy`), the per-row tables
    and the graph's arrays under `root`."""
    from hcrag_tpu_torch.core.graph import CsrGraph
    from hcrag_tpu_torch.core.types import edge_type_id
    from hcrag_tpu_torch.utils.synthetic import synthetic_bank

    emb = np.lib.format.open_memmap(os.path.join(root, "emb.npy"), mode="w+",
                                    dtype=np.float32, shape=(n, dim))
    t0 = time.time()
    _, type_ids, bits, counts = synthetic_bank(n, dim, seed=0, emb_out=emb)
    emb.flush()
    del emb
    for name, a in (("type_ids", type_ids), ("bits", bits), ("counts", counts)):
        np.save(os.path.join(root, f"{name}.npy"), a)
    log(f"index drawn in {time.time() - t0:.1f}s ({n * dim * 4 / 2**30:.2f} GiB f32, "
        "one copy on the host)")
    if not with_graph:
        return
    t0 = time.time()
    rng = np.random.default_rng(3)
    src = np.repeat(np.arange(n, dtype=np.int64), DEGREE)
    dst = rng.integers(0, n, size=n * DEGREE)
    ety = rng.choice([edge_type_id("DESCRIBED_BY"), edge_type_id("ANNOTATION")],
                     size=n * DEGREE)
    graph = CsrGraph.from_edges(n, src, dst, ety, node_labels=["Product"] * n,
                                node_keys=range(n), node_texts=[""] * n,
                                node_to_row=np.arange(n, dtype=np.int32))
    for name in _GRAPH_ARRAYS:
        np.save(os.path.join(root, f"{name}.npy"), getattr(graph, name))
    log(f"graph built in {time.time() - t0:.1f}s ({n * DEGREE} edges, degree {DEGREE})")


def load_data(root: str, n: int, with_graph: bool):
    """(DenseIndex, CsrGraph or None) over the arrays under `root`, the rows
    and the graph's arrays mapped read-only."""
    from hcrag_tpu_torch.core.dense_index import DenseIndex
    from hcrag_tpu_torch.core.graph import CsrGraph
    from hcrag_tpu_torch.core.vocab import EntityVocab

    path = lambda name: os.path.join(root, f"{name}.npy")  # noqa: E731
    bits = np.load(path("bits"))
    index = DenseIndex(
        emb=np.load(path("emb"), mmap_mode="r"), type_ids=np.load(path("type_ids")),
        entity_bits=bits, entity_counts=np.load(path("counts")),
        graph_ids=np.arange(n, dtype=np.int32),
        metadata=_RowsOf(n, lambda i: {"id": f"syn_{i}", "type": "database_table",
                                       "table_name": "Synthetic", "row_index": i}),
        texts=_RowsOf(n, lambda i: f"synthetic row {i}"),
        vocab=EntityVocab({f"e{i}": i for i in range(bits.shape[1] * 32)}),
        generation_info={"synthetic": True, "n": n})
    if not with_graph:
        return index, None
    arrays = {name: np.load(path(name), mmap_mode="r") for name in _GRAPH_ARRAYS}
    graph = CsrGraph(node_labels=["Product"] * n, node_keys=range(n), node_texts=[""] * n,
                     node_to_row=np.arange(n, dtype=np.int32), **arrays)
    return index, graph


def queries(emb: np.ndarray, b: int = BATCH):
    """(queries [b, dim], the stored rows of the first b // 2)."""
    rng = np.random.default_rng(7)
    n, dim = emb.shape
    stored = rng.integers(0, n, size=b // 2)
    q = np.concatenate([np.asarray(emb[stored], np.float32),
                        rng.standard_normal((b - b // 2, dim)).astype(np.float32)])
    return q / np.linalg.norm(q, axis=1, keepdims=True), stored


def memory_reckoning(engine, mode: str, with_graph: bool) -> Dict:
    """The JAX script's per-chip memory keys for one rank of `engine`."""
    _, sel_bytes, extra_bytes, _ = MODES[mode]
    n_pad, shards, dim = engine._n_bank, engine._n_shards, engine.index.dim
    per_rank_rows = n_pad // shards
    sel = per_rank_rows * dim * sel_bytes / 2**30
    extra = per_rank_rows * dim * extra_bytes / 2**30
    feat = n_pad * (4 + 4 * engine.index.entity_bits.shape[1] + 4 + 4) / 2**30
    graph = 0.0
    if with_graph:
        g_rows = engine._n_graph_padded
        width = engine.d_neighbors.shape[1]
        graph = (2 * g_rows * width + g_rows * 2) * 4 / shards / 2**30
    return {"per_chip_selection_bank_gb": sel, "per_chip_rescore_bank_gb": extra,
            "replicated_feature_tables_gb": feat, "per_chip_graph_ell_gb": graph,
            "per_chip_total_gb": sel + extra + feat + graph}


def rank_main(rank: int, world: int, root: str, n: int, modes: Sequence[str], device: str,
              with_graph: bool, steps: int) -> Dict:
    """One rank: per mode, the sharded engine over the mapped data, one
    `query_batch` (launches counted), the step's time and the memory."""
    # The banks are read from the read-only map, a chunk at a time, and
    # copied to the device: no tensor over the map is ever written.
    warnings.filterwarnings("ignore", message="The given NumPy array is not writable")
    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
    else:
        torch.set_num_threads(1)
    with PeakRss() as rss:
        return _rank_modes(rss, root, n, modes, device, with_graph, steps)


def _rank_modes(rss, root, n, modes, device, with_graph, steps) -> Dict:
    from hcrag_tpu_torch.ops import topk_cuda as tc
    from hcrag_tpu_torch.parallel import ShardedQueryEngine, make_row_mesh

    mesh = make_row_mesh(device=device)
    index, graph = load_data(root, n, with_graph)
    q, _ = queries(index.emb)
    dq = torch.from_numpy(q).to(mesh.device)
    out = {}
    for mode in modes:
        if mesh.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(mesh.device)
        t0 = time.time()
        engine = ShardedQueryEngine(index, graph, mesh=mesh, shard_graph=with_graph,
                                    ell_max_degree=DEGREE, **MODES[mode][0])
        setup_s = time.time() - t0
        wrappers = [getattr(tc, name) for name in KERNELS[mode]]
        before = [w.launches for w in wrappers]
        t0 = time.time()
        res = engine.query_batch(q, top_k=TOP_K, expansion_depth=1)
        first_s = time.time() - t0
        launches = {w.__name__: w.launches - b for w, b in zip(wrappers, before)}
        step_ms = ms(lambda: engine.query_batch_device(dq, top_k=TOP_K, expansion_depth=1),
                     mesh.device, steps, warmup=1)
        out[mode] = dict(
            top_indices=res.top_indices, top_scores=res.top_scores,
            expanded_counts=res.expanded_counts, launches=launches, step_ms=step_ms,
            setup_s=setup_s, first_query_s=first_s, memory=memory_reckoning(engine, mode,
                                                                              with_graph),
            n_padded=engine._n_bank,
            peak_device_gib=(torch.cuda.max_memory_allocated(mesh.device) / 2**30
                             if mesh.device.type == "cuda" else None),
            peak_host_rss_gib=rss.peak)
        del engine
        if mesh.device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def run(device: Union[str, torch.device, None] = "cuda", n: int = 10_000_000, dim: int = 384,
        modes: Sequence[str] = ("bf16_rescore",), ranks: int = 4, with_graph: bool = True,
        steps: int = 5) -> Dict:
    """Every mode over `ranks` ranks (module docstring); returns
    {mode: the JAX entry and the measurements}."""
    from hcrag_tpu_torch.parallel.launch import run_ranks

    dev = device_of(device)
    for mode in modes:
        if mode not in MODES:
            raise ValueError(f"mode must be one of {sorted(MODES)}, got {mode!r}")
    if dev.type == "cuda":  # once here, not in every rank at once
        from hcrag_tpu_torch.ops import _build

        _build.build(("int8_tile_topk", "packed_candidate_merge", "float_tile_topk"))
    log(f"{ranks} ranks; n={n} dim={dim} modes={list(modes)} graph={with_graph} "
        f"device={dev.type}")
    with PeakRss() as rss, tempfile.TemporaryDirectory() as root:
        write_data(root, n, dim, with_graph)
        emb = np.load(os.path.join(root, "emb.npy"), mmap_mode="r")
        q, stored = queries(emb)
        t0 = time.time()
        ref = brute_force_top_k(emb, q, TOP_K)
        log(f"f32 brute force ground truth: {time.time() - t0:.1f}s")
        del emb
        t0 = time.time()
        used_before = host_used_gib()
        with PeakRss() as during:
            outs = run_ranks(rank_main, ranks, args=(root, n, tuple(modes), dev.type,
                                                     with_graph, steps), timeout_s=3600.0)
        log(f"ranks done in {time.time() - t0:.1f}s; the machine's host memory in use "
            f"{used_before} GiB before them, {during.peak_used} GiB at most with them")
    added = (None if used_before is None or during.peak_used is None
             else (during.peak_used - used_before) / ranks)
    result = {}
    for mode in modes:
        per = [o[mode] for o in outs]
        top = per[0]["top_indices"]
        for r, o in enumerate(per[1:], 1):
            if not (np.array_equal(o["top_indices"], top)
                    and np.array_equal(o["top_scores"], per[0]["top_scores"])):
                raise AssertionError(f"{mode}: rank {r}'s result differs from rank 0's")
        if with_graph and not (per[0]["expanded_counts"] > 0).any():
            raise AssertionError(f"{mode}: the expansion produced nothing")
        for j, row in enumerate(stored):
            if int(top[j, 0]) != int(row):
                raise AssertionError(f"{mode}: self-retrieval failed: query {j} row {row} "
                                     f"got {top[j, 0]}")
        _, _, _, extra_name = MODES[mode]
        entry = {
            "n_rows": n, "dim": dim, "mode": mode, "mesh_devices": ranks,
            "recall_at_10_vs_f32_bruteforce": recall(ref, top),
            "self_retrieval_exact": True, **per[0]["memory"],
            "graph": (f"degree-{DEGREE} ELL, shard_graph=True (split over ranks; whole "
                      f"on every rank it would cost "
                      f"{per[0]['memory']['per_chip_graph_ell_gb'] * ranks} GB a rank)"
                      if with_graph else "none"),
            "rescore_bank": extra_name, "n_padded": per[0]["n_padded"],
            "step_ms_by_rank": [o["step_ms"] for o in per],
            "setup_s_by_rank": [o["setup_s"] for o in per],
            "first_query_s_by_rank": [o["first_query_s"] for o in per],
            "peak_device_gib_by_rank": [o["peak_device_gib"] for o in per],
            "peak_host_rss_gib_by_rank": [o["peak_host_rss_gib"] for o in per],
            "peak_host_rss_gib_drawing_process": rss.peak,
            "host_used_gib_before_ranks": used_before,
            "peak_host_used_gib_with_ranks": during.peak_used,
            "host_gib_added_per_rank": added,
            "launches_by_rank": [o["launches"] for o in per],
            "top_indices": top.tolist(),
            "device": dev.type if dev.type == "cpu" else torch.cuda.get_device_name(dev),
            "note": ("ranks are gloo processes sharing one card: the step time includes "
                     "their collectives through host memory, no interconnect"),
        }
        entry["recall_at_10"] = entry["recall_at_10_vs_f32_bruteforce"]
        entry["per_chip_gb"] = entry["per_chip_total_gb"]
        entry["n"] = n
        log(f"{mode}: recall@10 {entry['recall_at_10']}, step ms by rank "
            f"{entry['step_ms_by_rank']}, per-rank total {entry['per_chip_total_gb']:.3f} GB")
        result[mode] = entry
    return result


def main(argv=None) -> int:
    p = parser(__doc__)
    p.add_argument("--n", type=int, default=None, help="rows (10,000,000; 20,000 on the CPU)")
    p.add_argument("--dim", type=int, default=384)
    p.add_argument("--mode", default="bf16_rescore",
                   help="bf16_rescore or int8_residual, or both comma-separated")
    p.add_argument("--graph", type=int, default=1, help="1: the degree-8 graph; 0: none")
    p.add_argument("--ranks", type=int, default=None, help="ranks (4; 2 on the CPU)")
    args = p.parse_args(argv)
    dev = device_of(args.device)
    size = dict(CPU_SIZE) if dev.type == "cpu" else dict(n=10_000_000, ranks=4)
    size.update({k: v for k, v in (("n", args.n), ("ranks", args.ranks)) if v is not None})
    finish(run(dev, dim=args.dim, modes=args.mode.split(","), with_graph=bool(args.graph),
               **size), args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
