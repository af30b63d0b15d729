"""Rank functions of the sharded-engine tests (`tests/test_torch_sharded*.py`).

They run in processes spawned by `hcrag_tpu_torch.parallel.launch.run_ranks`
(gloo on the CPU), so this module imports neither JAX nor the JAX package:
each rank imports only the port.  The inputs are made here from seeds, and
the tests make the same ones for the JAX side.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

SHARDS = 4
# 9,000 rows over 4 shards of 4,096 (the bank padded to 4 x 2,048-row
# tiles): shard 2 is ragged and shard 3 is all padding.
ENGINE_ROWS, ENGINE_DIM, ENGINE_B = 9000, 128, 8
QUIRK_ROWS = 6000

#: mode -> (engine options, query_batch options, batch); the JAX engines
#: take these plus their Pallas switches (tests/test_torch_sharded.py).
ENGINE_MODES = {
    "f32": (dict(), dict(), ENGINE_B),
    "rescore": (dict(exact_rescore=32), dict(), ENGINE_B),
    "rescore_super": (dict(exact_rescore=32, pallas_super=4), dict(), 64),
    "int8": (dict(quantize_int8=True, int8_rescore=32), dict(), ENGINE_B),
    "residual": (dict(quantize_int8=True, int8_residual=True, int8_rescore=24),
                 dict(), ENGINE_B),
    "int8_only": (dict(quantize_int8=True, int8_only=True), dict(), ENGINE_B),
    "top_k_200": (dict(), dict(top_k=200), ENGINE_B),
    "filter": (dict(), dict(category_filter="json_table"), ENGINE_B),
    "dynamic": (dict(), dict(dynamic=True), ENGINE_B),
    "graph_split_depth2": (dict(shard_graph=True), dict(expansion_depth=2), ENGINE_B),
    "graph_whole_depth2": (dict(), dict(expansion_depth=2), ENGINE_B),
    "batch_mesh": (dict(shard_queries=True), dict(top_k=7), ENGINE_B),
}
#: The modes the checkpoint round trip covers (at 2 shards).
CHECKPOINT_MODES = ("f32", "rescore", "rescore_super", "int8", "residual",
                    "int8_only", "graph_split_depth2")
QUIRK_OPTS = dict(quantize_int8=True, int8_rescore=32, int8_f32_rescore=True)
FIELDS = ("top_scores", "top_indices", "relevance", "combined",
          "expanded_nodes", "expanded_counts", "expanded_relevance")


def normalized(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def topk_inputs():
    """The inputs of the `sharded_top_k` / `sharded_row_gather` cases."""
    rng = np.random.default_rng(20)
    mask = np.zeros(256, bool)
    mask[100:200] = True
    return dict(
        emb=normalized(rng, 4096, 64), q=normalized(rng, 4, 64),
        # all rows equal: every score ties, across shard boundaries
        tied_emb=np.tile(np.eye(1, 8, dtype=np.float32), (64, 1)),
        tied_q=np.eye(1, 8, dtype=np.float32),
        mask_emb=normalized(rng, 256, 16), mask=mask,
        rq=normalized(rng, 8, 64),
        table=rng.standard_normal((512, 7)).astype(np.float32),
        gather_idx=np.array([[0, 5, 511], [100, 255, -1]], dtype=np.int32),
    )


def index_and_graph(n_rows=ENGINE_ROWS, dim=ENGINE_DIM, emb_seed=None):
    """The engines' index (every third row re-typed, for the filter) and
    its degree-4 graph; `emb_seed` swaps in other rows of the same shape."""
    from hcrag_tpu_torch.utils.synthetic import synthetic_embeddings, synthetic_setup

    index, graph = synthetic_setup(n_rows, dim, graph_degree=4)
    meta = [dict(m, type="json_table" if r % 3 == 0 else "database_table")
            for r, m in enumerate(index.metadata)]
    index = dataclasses.replace(index, metadata=meta)
    if emb_seed is not None:
        index = dataclasses.replace(index, emb=synthetic_embeddings(n_rows, dim, emb_seed))
    return index, graph


def engine_queries(b, dim=ENGINE_DIM):
    return normalized(np.random.default_rng(11 + b), b, dim)


def query_kwargs(qopts):
    """A mode's query_batch options, its dynamic weights made."""
    kw = dict(qopts)
    if kw.pop("dynamic", False):
        from hcrag_tpu_torch.pipeline.scorer_designs import canonical_dynamic_weight_tensor

        kw["dynamic_weight_tensor"] = canonical_dynamic_weight_tensor()
    return kw


def result_arrays(res):
    return {f: np.asarray(getattr(res, f)) for f in FIELDS}


def _block(a, rank, world):
    per = a.shape[0] // world
    return torch.from_numpy(np.ascontiguousarray(a[rank * per:(rank + 1) * per]))


def _numpy(pair):
    return tuple(t.numpy() for t in pair)


def topk_cases(rank, world):
    """Every `sharded_top_k` / `sharded_row_gather` case of the CPU tests,
    then the collectives (kind, bytes) of one rescored call at b = 8,
    k = 10, m = 32."""
    torch.set_num_threads(1)
    from hcrag_tpu_torch.ops.quantize import quantize_rows
    from hcrag_tpu_torch.ops.similarity import dots
    from hcrag_tpu_torch.ops.similarity import top_k as stable_top_k
    from hcrag_tpu_torch.parallel import (
        make_batch_row_mesh,
        make_row_mesh,
        sharded_ops,
        sharded_row_gather,
        sharded_top_k,
    )

    mesh = make_row_mesh(device="cpu")
    x = topk_inputs()
    t = torch.from_numpy
    blk = lambda a: _block(a, rank, world)  # noqa: E731
    emb = x["emb"]
    q8, s8 = quantize_rows(emb)

    def two_then_fillers(q, bl, mask, k, m):
        v, i = stable_top_k(dots(q, bl["emb"]), 2)
        fill = max(k, m) - 2
        return (torch.cat([v, torch.full((q.shape[0], fill), -1e30)], 1),
                torch.cat([i, torch.full((q.shape[0], fill), -1, dtype=i.dtype)], 1))

    bf = blk(emb).to(torch.bfloat16)
    out = {
        "plain": sharded_top_k(mesh, t(x["q"]), blk(emb), 10),
        "tied": sharded_top_k(mesh, t(x["tied_q"]), blk(x["tied_emb"]), 20),
        "mask": sharded_top_k(mesh, t(x["mask_emb"][:1]), blk(x["mask_emb"]), 5,
                              blk(x["mask"])),
        "rescore_key": sharded_top_k(
            mesh, t(x["rq"]), None, 10, banks={"emb": bf, "emb_f32": blk(emb)},
            fetch_k=32, rescore_key="emb_f32"),
        "rescore_rows": sharded_top_k(
            mesh, t(x["rq"]), None, 10,
            banks={"emb": bf, "e8": blk(q8), "es": blk(s8)}, fetch_k=32,
            rescore_rows=lambda bl, ix: bl["e8"][ix].float() * bl["es"][ix][..., None]),
        "fillers": sharded_top_k(mesh, t(x["q"]), blk(emb), 10,
                                 local_select=two_then_fillers),
    }
    # A batch of 3 split over the 2 x 2 mesh's batch axis: slices of 2 and
    # 1 (the second padded), gathered back to 3.
    batch_mesh = make_batch_row_mesh(2, 2, device="cpu")
    out["ragged_batch"] = sharded_top_k(
        batch_mesh, t(x["q"][:3]), _block(emb, batch_mesh.coords["rows"], 2), 10,
        batch_axis="batch")
    out = {k: _numpy(v) for k, v in out.items()}
    out["gather"] = sharded_row_gather(mesh, blk(x["table"]), t(x["gather_idx"])).numpy()

    calls = []
    real = sharded_ops._collective

    def recording(kind, tensor, group):
        got = real(kind, tensor, group)
        calls.append((kind, got.numel() * got.element_size()))
        return got

    sharded_ops._collective = recording
    try:
        sharded_top_k(mesh, t(x["rq"]), None, 10,
                      banks={"emb": blk(emb), "emb_f32": blk(emb)},
                      fetch_k=32, rescore_key="emb_f32")
    finally:
        sharded_ops._collective = real
    out["traffic"] = calls
    return out


def engine_cases(rank, world):
    """Every engine mode of `ENGINE_MODES` at 4 shards (the batch mesh 2 x
    2), then the `int8_f32_rescore` mode at 6,000 rows."""
    torch.set_num_threads(1)
    from hcrag_tpu_torch.parallel import (
        ShardedQueryEngine,
        make_batch_row_mesh,
        make_row_mesh,
    )

    meshes = {"rows": make_row_mesh(device="cpu"),
              "batch": make_batch_row_mesh(2, 2, device="cpu")}
    index, graph = index_and_graph()
    out = {}
    for mode, (opts, qopts, b) in ENGINE_MODES.items():
        mesh = meshes["batch" if opts.get("shard_queries") else "rows"]
        engine = ShardedQueryEngine(index, graph, mesh=mesh, ell_max_degree=8, **opts)
        out[mode] = result_arrays(engine.query_batch(engine_queries(b), **query_kwargs(qopts)))
    qi, qg = index_and_graph(QUIRK_ROWS)
    engine = ShardedQueryEngine(qi, qg, mesh=meshes["rows"], ell_max_degree=8, **QUIRK_OPTS)
    out["quirk"] = result_arrays(engine.query_batch(engine_queries(ENGINE_B), top_k=10))
    out["quirk_report"] = engine.resolved_kernel_config(ENGINE_B)["rescore_bank"]
    return out


def checkpoint_cases(rank, world, directory):
    """At 2 shards, per mode of `CHECKPOINT_MODES`: results before a save,
    and after restoring into an engine built from other rows; then the
    refusals (another mode; `BatchedExecutor` over more than one rank)."""
    torch.set_num_threads(1)
    from hcrag_tpu_torch.parallel import ShardedQueryEngine, make_row_mesh
    from hcrag_tpu_torch.parallel.checkpoint import (
        restore_sharded_index,
        save_sharded_index,
    )
    from hcrag_tpu_torch.query.executor import BatchedExecutor

    mesh = make_row_mesh(device="cpu")
    index, graph = index_and_graph()
    other, _ = index_and_graph(emb_seed=5)
    out = {}
    for mode in CHECKPOINT_MODES:
        opts, qopts, b = ENGINE_MODES[mode]
        kw = query_kwargs(qopts)
        q = engine_queries(b)
        engine = ShardedQueryEngine(index, graph, mesh=mesh, ell_max_degree=8, **opts)
        before = result_arrays(engine.query_batch(q, **kw))
        save_sharded_index(engine, os.path.join(directory, mode))
        fresh = ShardedQueryEngine(other, graph, mesh=mesh, ell_max_degree=8, **opts)
        differs = not np.array_equal(fresh.query_batch(q, **kw).top_indices,
                                     before["top_indices"])
        restore_sharded_index(fresh, os.path.join(directory, mode))
        out[mode] = (before, result_arrays(fresh.query_batch(q, **kw)), differs)
    wrong_mode = ShardedQueryEngine(index, graph, mesh=mesh, ell_max_degree=8,
                                    exact_rescore=32)
    try:
        restore_sharded_index(wrong_mode, os.path.join(directory, "f32"))
        out["wrong_mode"] = None
    except ValueError as e:
        out["wrong_mode"] = str(e)
    try:
        BatchedExecutor(wrong_mode)
        out["executor"] = None
    except ValueError as e:
        out["executor"] = str(e)
    return out


def sharded_cases(rank, world):
    """`topk_cases` and `engine_cases` in one spawn."""
    return {"topk": topk_cases(rank, world), "engine": engine_cases(rank, world)}


#: The card tests' modes (tests/test_torch_cuda.py).
CARD_MODES = {"int8": dict(quantize_int8=True, int8_rescore=32), "f32": dict()}
CARD_ROWS, CARD_DIM, CARD_B = 20_000, 384, 64


def card_cases(rank, world):
    """Each `CARD_MODES` mode through a sharded engine on the card (every
    rank on card 0, gloo)."""
    from hcrag_tpu_torch.parallel import ShardedQueryEngine, make_row_mesh

    mesh = make_row_mesh(device="cuda")
    index, graph = index_and_graph(CARD_ROWS, CARD_DIM)
    q = engine_queries(CARD_B, CARD_DIM)
    return {mode: result_arrays(ShardedQueryEngine(index, graph, mesh=mesh, ell_max_degree=8,
                                                   **opts).query_batch(q, top_k=10))
            for mode, opts in CARD_MODES.items()}
