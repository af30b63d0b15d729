"""Rank functions of the sharded-engine tests (`tests/test_torch_sharded*.py`,
`tests/test_torch_serving_ranks.py`).

They run in processes spawned by `hcrag_tpu_torch.parallel.launch.run_ranks`
(gloo on the CPU), so this module imports neither JAX nor the JAX package:
each rank imports only the port.  The inputs are made here from seeds, and
the tests make the same ones for the JAX side.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import threading
import time

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
    refusal of another mode."""
    torch.set_num_threads(1)
    from hcrag_tpu_torch.parallel import ShardedQueryEngine, make_row_mesh
    from hcrag_tpu_torch.parallel.checkpoint import (
        restore_sharded_index,
        save_sharded_index,
    )

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
    return out


def sharded_cases(rank, world):
    """`topk_cases` and `engine_cases` in one spawn."""
    return {"topk": topk_cases(rank, world), "engine": engine_cases(rank, world)}


# ---------------------------------------------------------------------------
# BatchedExecutor over the sharded engine (tests/test_torch_serving_ranks.py)
# ---------------------------------------------------------------------------
SERVE_WAIT = 60  # seconds any one served request may take
#: The modes served against the unsharded engine, on 2 and 4 ranks (the
#: dispatch sizes stay under 64 queries, so `rescore_super` selects by B5
#: tiles, as its unsharded engine does at these sizes).
SERVE_MODES = ("f32", "int8", "rescore_super", "residual", "int8_only")
JAX_SERVE_MODES = ("f32", "int8")  # against JAX's executor, on 4 ranks
#: The traffic: 64 requests in blocks of 16 from one thread while 4 client
#: threads submit 24 more one by one.
SERVE_BLOCKS, SERVE_BLOCK, SERVE_SINGLES, SERVE_CLIENTS = 64, 16, 24, 4
SERVE_KW = dict(batch_size=16, batch_sizes=(4, 8, 16), top_k=10)
GRAPH_DEPTHS = (1, 3)  # full mode over the split graph, on 2 ranks
#: 19 requests over the 2 x 2 mesh: batches of 8, 8 and a ragged 3.
BATCH_MESH_REQUESTS, BATCH_MESH_KW = 19, dict(batch_size=8, batch_sizes=(3, 8), top_k=7,
                                                mode="full", max_wait_ms=50)
HOST_API_MODES = ("f32", "int8", "rescore_super")  # the host API across 2 ranks
HOST_TEXT_ROWS = (5, 77, 4001)
APPEND_ROWS = 1500
FAIL_TIMEOUT_S = 10.0  # the failure case's group timeout
FAIL_AT = 3  # the step at which rank 1 raises
#: A follower's shutdown bound, and how long rank 0 serves past it.
FOLLOWER_BOUND_S, RANK0_SERVES_S = 1.0, 4.0


def serve_queries(n=SERVE_BLOCKS + SERVE_SINGLES, dim=ENGINE_DIM):
    return normalized(np.random.default_rng(31), n, dim)


def served_arrays(results) -> dict:
    """Served results stacked per field, under `FIELDS`' names (retrieval:
    scores and indices only)."""
    if isinstance(results[0], tuple):
        return {"top_scores": np.stack([r[0] for r in results]),
                "top_indices": np.stack([r[1] for r in results])}
    return {f: np.stack([np.asarray(getattr(r, "expanded_count" if f == "expanded_counts"
                                            else f)) for r in results])
            for f in FIELDS}


def serve_traffic(ex, queries) -> dict:
    """Rank 0's traffic: the first `SERVE_BLOCKS` queries in blocks from
    this thread while `SERVE_CLIENTS` threads submit the rest one by one;
    the served results in request order."""
    futs = [None] * len(queries)

    def client(c):
        for i in range(SERVE_BLOCKS + c, len(queries), SERVE_CLIENTS):
            futs[i] = ex.submit(queries[i])

    threads = [threading.Thread(target=client, args=(c,)) for c in range(SERVE_CLIENTS)]
    for t in threads:
        t.start()
    for lo in range(0, SERVE_BLOCKS, SERVE_BLOCK):
        futs[lo:lo + SERVE_BLOCK] = ex.submit_many(queries[lo:lo + SERVE_BLOCK])
    for t in threads:
        t.join(SERVE_WAIT)
    return served_arrays([f.result(timeout=SERVE_WAIT) for f in futs])


def serve(engine, rank, work, follower_work=None, **kw):
    """Every rank constructs the executor and shuts it down; rank 0 runs
    `work(ex)`, the others `follower_work(ex)`.  Returns (that output,
    the batches this rank stepped, the last batch's sequence number)."""
    from hcrag_tpu_torch.query.executor import BatchedExecutor

    ex = BatchedExecutor(engine, **kw)
    try:
        if rank == 0:
            out = work(ex)
        else:
            out = follower_work(ex) if follower_work else None
    finally:
        ex.shutdown()
    return out, ex.batches_dispatched, ex._seq


def _submit_many(queries):
    return lambda ex: served_arrays([f.result(timeout=SERVE_WAIT)
                                     for f in ex.submit_many(queries)])


def _follower_submit(ex):
    try:
        ex.submit(np.zeros(ENGINE_DIM, np.float32))
    except RuntimeError as e:
        return str(e)
    return None


def _wrong_width_then_served(queries):
    """A request of another width (its batch fails on rank 0), then a
    block served on every rank."""
    def work(ex):
        bad = ex.submit(np.ones(ENGINE_DIM // 2, np.float32))
        try:
            bad.result(timeout=SERVE_WAIT)
            err = None
        except ValueError as e:
            err = str(e)
        return err, _submit_many(queries)(ex)
    return work


def _shutdown_with_queued(queries):
    """Many blocks submitted, then shutdown at once: each request is served
    or fails with the shutdown's error."""
    def work(ex):
        futs = [f for _ in range(25) for f in ex.submit_many(queries)]
        ex.shutdown()
        outcome = []
        for f in futs:
            try:
                f.result(timeout=SERVE_WAIT)
                outcome.append(None)
            except RuntimeError as e:
                outcome.append(str(e))
        return outcome, ex.requests_served
    return work


def _bounded_shutdown(ex):
    """A follower's shutdown with a bound that rank 0 outlasts: the
    `TimeoutError` and the seconds it took (`serve` then waits again)."""
    t0 = time.monotonic()
    try:
        ex.shutdown(timeout=FOLLOWER_BOUND_S)
    except TimeoutError as e:
        return str(e), time.monotonic() - t0
    return None, time.monotonic() - t0


def n_groups() -> int:
    """The process groups this rank holds."""
    return len(torch.distributed.distributed_c10d._world.pg_map)


def _mismatch(engine, rank):
    """Rank 3 asks for another top_k: every rank's constructor raises."""
    from hcrag_tpu_torch.query.executor import BatchedExecutor

    try:
        BatchedExecutor(engine, batch_size=8, top_k=5 if rank == 3 else 10)
    except ValueError as e:
        return str(e)
    return None


def serving_cases(rank, world):
    """`BatchedExecutor` over the sharded engine on `world` ranks (row
    mesh): each `SERVE_MODES` mode under the traffic (retrieval); at 4
    ranks also JAX's cases (16 requests by one `submit_many`, batch 8,
    both modes), the 2 x 2 batch mesh, a follower's submit, arguments that
    differ on one rank, a request of another width and a shutdown with
    requests queued; at 2 ranks full mode over the split graph at depths 1
    and 3."""
    torch.set_num_threads(1)
    from hcrag_tpu_torch.parallel import (
        ShardedQueryEngine,
        make_batch_row_mesh,
        make_row_mesh,
    )

    mesh = make_row_mesh(device="cpu")
    index, graph = index_and_graph()
    q = serve_queries()
    out = {"traffic": {}, "jax": {}, "graph": {}, "groups": [n_groups()]}
    for mode in SERVE_MODES:
        engine = ShardedQueryEngine(index, graph, mesh=mesh, ell_max_degree=8,
                                    **ENGINE_MODES[mode][0])
        out["traffic"][mode] = serve(engine, rank, lambda ex: serve_traffic(ex, q), **SERVE_KW)
        if world == 4 and mode in JAX_SERVE_MODES:
            for kind in ("retrieval", "full"):
                out["jax"][mode, kind] = serve(
                    engine, rank, _submit_many(engine_queries(16)), batch_size=8, top_k=10,
                    max_wait_ms=50, mode=kind)
        if world == 4 and mode == "f32":
            out["follower_submit"] = serve(engine, rank, lambda ex: None, _follower_submit,
                                           batch_size=8)
            out["mismatch"] = _mismatch(engine, rank)
            out["wrong_width"] = serve(engine, rank, _wrong_width_then_served(q[:8]),
                                       batch_size=8, top_k=10, max_wait_ms=50)
            out["queued"] = serve(engine, rank, _shutdown_with_queued(q[:16]), batch_size=8,
                                  top_k=10)
            out["bounded"] = serve(engine, rank, lambda ex: time.sleep(RANK0_SERVES_S),
                                   _bounded_shutdown, batch_size=8)
    out["groups"].append(n_groups())
    if world == 4:
        engine = ShardedQueryEngine(index, graph, mesh=make_batch_row_mesh(2, 2, device="cpu"),
                                    ell_max_degree=8, shard_queries=True)
        out["batch_mesh"] = serve(engine, rank, _submit_many(q[:BATCH_MESH_REQUESTS]),
                                  **BATCH_MESH_KW)
    else:
        engine = ShardedQueryEngine(index, graph, mesh=mesh, ell_max_degree=8, shard_graph=True)
        for depth in GRAPH_DEPTHS:
            out["graph"][depth] = serve(engine, rank, lambda ex: serve_traffic(ex, q),
                                        mode="full", expansion_depth=depth, **SERVE_KW)
    return out


def host_index_and_graph():
    """`index_and_graph`'s rows with the database rows made Product rows
    with an entity id, so that `hybrid_search` finds graph records."""
    index, graph = index_and_graph()
    meta = [dict(m, table_name="Product", entity_id=f"P{r}")
            if m["type"] == "database_table" else m
            for r, m in enumerate(index.metadata)]
    return dataclasses.replace(index, metadata=meta), graph


def append_rows(index):
    """`APPEND_ROWS` rows appended to `index` in place, from a seed."""
    rng = np.random.default_rng(9)
    n0 = index.n
    index.append(
        rng.standard_normal((APPEND_ROWS, ENGINE_DIM)).astype(np.float32),
        [{"id": f"new_{i}", "type": "database_table", "table_name": "Synthetic",
          "row_index": n0 + i} for i in range(APPEND_ROWS)],
        [f"appended row {i} e{i % 100}" for i in range(APPEND_ROWS)],
    )


def host_api_calls(engine, index) -> dict:
    """The engine's host API on a few of the index's own texts and rows."""
    from hcrag_tpu_torch.models.reranker import Reranker

    texts = [index.texts[i] for i in HOST_TEXT_ROWS]
    out = {
        "process_query": [engine.process_query(t, top_k=5, similarity_threshold=0.0)
                          for t in texts],
        "search_by_category": [engine.search_by_category(t, c, top_k=5)
                               for t in texts for c in (None, "json_table")],
        "hybrid_search": [engine.hybrid_search(t, limit=5) for t in texts],
        "find_similar_content": [engine.find_similar_content(np.asarray(index.emb[i]), top_k=5)
                                 for i in HOST_TEXT_ROWS],
    }
    engine.set_reranker(Reranker(seed=3, device=engine.device))
    out["rerank"] = result_arrays(engine.query_batch(engine_queries(ENGINE_B), top_k=10,
                                                     rerank=True))
    engine.set_reranker(None)
    append_rows(index)
    engine.refresh_index()
    out["refresh"] = result_arrays(engine.query_batch(engine_queries(ENGINE_B), top_k=10))
    return out


def host_api_cases(rank, world):
    """`host_api_calls` on each `HOST_API_MODES` engine, then the serving
    cases, in one spawn."""
    torch.set_num_threads(1)
    from hcrag_tpu_torch.parallel import ShardedQueryEngine, make_row_mesh

    mesh = make_row_mesh(device="cpu")
    out = {}
    for mode in HOST_API_MODES:
        index, graph = host_index_and_graph()
        engine = ShardedQueryEngine(index, graph, mesh=mesh, ell_max_degree=8,
                                    **ENGINE_MODES[mode][0])
        out[mode] = host_api_calls(engine, index)
    return {"host_api": out, "serving": serving_cases(rank, world)}


def failure_case(rank, world):
    """A mesh with a `FAIL_TIMEOUT_S` timeout; rank 1's step raises at its
    `FAIL_AT`-th batch, and rank 1 then keeps its process (and its
    connections) for longer than the timeout, so only the timeout frees the
    others.  Rank 0 serves two blocks of 8, then four more at once, then
    submits again.  Each rank returns what it saw and the seconds its
    function took."""
    torch.set_num_threads(1)
    t0 = time.monotonic()
    from hcrag_tpu_torch.parallel import ShardedQueryEngine, make_row_mesh
    from hcrag_tpu_torch.query.executor import BatchedExecutor

    mesh = make_row_mesh(device="cpu", timeout=datetime.timedelta(seconds=FAIL_TIMEOUT_S))
    index, graph = index_and_graph()
    engine = ShardedQueryEngine(index, graph, mesh=mesh, ell_max_degree=8)
    if rank == 1:
        real, calls = engine.retrieve_batch_device, []

        def failing(q, top_k):
            calls.append(q.shape[0])
            if len(calls) == FAIL_AT:
                raise RuntimeError("injected step failure")
            return real(q, top_k=top_k)

        engine.retrieve_batch_device = failing
    q = serve_queries()
    out = {}
    ex = BatchedExecutor(engine, batch_size=8, top_k=10, max_wait_ms=50)
    try:
        if rank == 0:
            served = [f.result(timeout=SERVE_WAIT) for lo in (0, 8)
                      for f in ex.submit_many(q[lo:lo + 8])]
            out["served"] = served_arrays(served)
            later = ex.submit_many(q[16:48])
            out["later"] = []
            for f in later:
                try:
                    f.result(timeout=SERVE_WAIT)
                    out["later"].append(None)
                except Exception as e:  # the outcome is the test's subject
                    out["later"].append(repr(e))
            try:
                ex.submit(q[0])
                out["submit"] = None
            except RuntimeError as e:
                out["submit"] = str(e)
    finally:
        try:  # past the timeout: the followers' loops end only after it
            ex.shutdown(timeout=FAIL_TIMEOUT_S + 20)
            out["shutdown"] = None
        except Exception as e:  # a follower's loop error, re-raised
            out["shutdown"] = repr(e)
    if rank == 1:
        time.sleep(FAIL_TIMEOUT_S + 5)
    out["batches"] = ex.batches_dispatched
    out["seconds"] = time.monotonic() - t0
    return out


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


def card_serving_cases(rank, world):
    """`serve_traffic` through `BatchedExecutor` over each `CARD_MODES`
    sharded engine on the card (every rank on card 0, gloo)."""
    from hcrag_tpu_torch.parallel import ShardedQueryEngine, make_row_mesh

    mesh = make_row_mesh(device="cuda")
    index, graph = index_and_graph(CARD_ROWS, CARD_DIM)
    q = serve_queries(dim=CARD_DIM)
    return {mode: serve(ShardedQueryEngine(index, graph, mesh=mesh, ell_max_degree=8, **opts),
                        rank, lambda ex: serve_traffic(ex, q), **SERVE_KW)
            for mode, opts in CARD_MODES.items()}


def dryrun_cases(rank, world, init):
    """`graft_entry.dryrun_multichip` in place on this group's ranks (CPU),
    then `contrastive_train` from `init` (JAX's initial weights): its
    losses, step 1's averaged gradients and the trained weights, under the
    Flax tree's names."""
    torch.set_num_threads(1)
    from hcrag_tpu_torch import graft_entry
    from hcrag_tpu_torch.models.minilm import flax_from_state, state_to_flax
    from hcrag_tpu_torch.parallel import make_row_mesh

    out = graft_entry.dryrun_multichip(world, device="cpu")
    res = graft_entry.contrastive_train(make_row_mesh(device="cpu"), init=init)
    out["from_jax"] = {"losses": res["losses"],
                       "grads": flax_from_state(res["grads"], graft_entry.DRYRUN_MINILM),
                       "params": state_to_flax(res["model"])}
    return out
