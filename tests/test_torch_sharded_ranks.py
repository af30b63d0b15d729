"""The port's sharded engine at world size 1 in a plain process, its
checkpoints over 2 gloo ranks, and the refusals.

  * World size 1 (no spawn: `make_row_mesh` makes a one-rank group in
    memory): `ShardedQueryEngine` equals `QueryEngine` bit for bit in the
    f32 and int8 + rescore modes, and `BatchedExecutor` over it (the rank
    protocol at world size 1) serves the same results.
  * Checkpoints at 2 shards (one spawn, `tests/torch_sharded_workers.
    checkpoint_cases`), in each mode: results after a restore into an
    engine built from other rows equal those before the save; the manifest
    names every bank the mode uses; a restore into another mode or another
    world size raises.
  * Without CUDA and without `device="cpu"`, the sharded engine and
    `make_row_mesh` raise.
"""

import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from hcrag_tpu_torch.parallel import ShardedQueryEngine, make_row_mesh
from hcrag_tpu_torch.parallel.checkpoint import restore_sharded_index
from hcrag_tpu_torch.parallel.mesh import replicated, row_sharding
from hcrag_tpu_torch.parallel.launch import run_ranks
from hcrag_tpu_torch.query.engine import QueryEngine
from hcrag_tpu_torch.query.executor import BatchedExecutor
from tests import torch_sharded_workers as W

WAIT = 60  # seconds any one future may take
ONE_RANK_MODES = {"f32": {}, "int8": dict(quantize_int8=True, int8_rescore=32)}
#: The banks each checkpointed mode keeps besides the per-row and graph tables.
BANKS = {
    "f32": {"emb"}, "rescore": {"emb", "emb_f32"}, "rescore_super": {"emb", "emb_f32"},
    "int8": {"emb", "emb_int8", "emb_scale"},
    "residual": {"emb_int8", "emb_scale", "emb_res8", "emb_res_scale"},
    "int8_only": {"emb_int8", "emb_scale"}, "graph_split_depth2": {"emb"},
}
TABLES = {"type_ids", "entity_bits", "entity_counts", "graph_ids", "neighbors",
          "neighbors_hop2", "g_type_ids", "g_row"}


@pytest.fixture(scope="module")
def index_graph():
    return W.index_and_graph()


@pytest.fixture(scope="module")
def cpu_mesh():
    """A one-rank mesh on the CPU.  The default group it makes in this
    process is destroyed after the module's tests, so no later test finds
    one."""
    made = not dist.is_initialized()
    yield make_row_mesh(device="cpu")
    if made:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def one_rank(index_graph, cpu_mesh):
    """(sharded, unsharded) engines per mode at world size 1 on the CPU."""
    index, graph = index_graph
    return {
        mode: (ShardedQueryEngine(index, graph, mesh=cpu_mesh, ell_max_degree=8, **opts),
               QueryEngine(index, graph, device="cpu", ell_max_degree=8, **opts))
        for mode, opts in ONE_RANK_MODES.items()
    }


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    directory = str(tmp_path_factory.mktemp("sharded_checkpoints"))
    return directory, run_ranks(W.checkpoint_cases, 2, args=(directory,))


@pytest.mark.parametrize("mode", list(ONE_RANK_MODES))
@pytest.mark.parametrize("depth", [1, 2])
def test_one_rank_equals_unsharded(one_rank, mode, depth):
    sharded, plain = one_rank[mode]
    assert sharded.mesh.size == 1 and sharded.mesh.backend == "gloo"
    q = W.engine_queries(16)
    got = sharded.query_batch(q, top_k=10, expansion_depth=depth)
    want = plain.query_batch(q, top_k=10, expansion_depth=depth)
    for f in W.FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)


def test_placements_and_split_tensors(one_rank, cpu_mesh, index_graph):
    """`row_sharding` / `replicated` state the two placements as
    `torch.distributed.tensor` does; the engine splits the banks, and the
    graph tables only with `shard_graph`."""
    from torch.distributed.tensor import Replicate, Shard

    assert row_sharding(cpu_mesh) == (Shard(0),)
    assert replicated(cpu_mesh) == (Replicate(),)
    banks = {"d_emb", "d_emb_int8", "d_emb_scale", "d_emb_f32", "d_emb_res8",
             "d_emb_res_scale"}
    graph = {"d_neighbors", "d_neighbors_hop2", "d_g_type_ids", "d_g_row"}
    assert one_rank["int8"][0].split_attrs == banks
    index, graph_ = index_graph
    split = ShardedQueryEngine(index, graph_, mesh=cpu_mesh, ell_max_degree=8,
                               shard_graph=True)
    assert split.split_attrs == banks | graph


@pytest.mark.parametrize("mode", list(ONE_RANK_MODES))
def test_executor_over_one_rank(one_rank, mode):
    sharded, plain = one_rank[mode]
    q = W.engine_queries(16)
    ex = BatchedExecutor(sharded, batch_size=8, top_k=10, max_wait_ms=50.0)
    try:
        futs = ex.submit_many(q)
        got = [f.result(timeout=WAIT) for f in futs]
    finally:
        ex.shutdown()
    want = plain.query_batch(q, top_k=10)
    np.testing.assert_array_equal(np.stack([i for _, i in got]), want.top_indices)
    np.testing.assert_allclose(np.stack([v for v, _ in got]), want.top_scores,
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("mode", W.CHECKPOINT_MODES)
def test_checkpoint_round_trip(checkpoints, mode):
    _, ranks = checkpoints
    for out in ranks:
        before, after, differed = out[mode]
        assert differed, "the fresh engine's own rows must answer otherwise"
        for f in W.FIELDS:
            np.testing.assert_array_equal(after[f], before[f], err_msg=f)


@pytest.mark.parametrize("mode", W.CHECKPOINT_MODES)
def test_manifest_names_every_bank(checkpoints, mode):
    directory, _ = checkpoints
    with open(os.path.join(directory, mode, "manifest.json")) as f:
        manifest = json.load(f)
    assert set(manifest["tensors"]) == BANKS[mode] | TABLES
    assert manifest["mesh_shape"] == {"rows": 2}
    split = {k for k, v in manifest["tensors"].items() if v["placement"] == "rows"}
    graph = {"neighbors", "neighbors_hop2", "g_type_ids", "g_row"}
    assert split == BANKS[mode] | (graph if mode == "graph_split_depth2" else set())
    assert sorted(os.listdir(os.path.join(directory, mode))) == [
        "manifest.json", "replicated.npz", "rows-0.npz", "rows-1.npz"]


def test_restore_refuses_another_mode(checkpoints):
    _, ranks = checkpoints
    assert all("exact_rescore" in out["wrong_mode"] for out in ranks)


def test_restore_refuses_another_world_size(checkpoints, index_graph, cpu_mesh):
    directory, _ = checkpoints
    index, graph = index_graph
    engine = ShardedQueryEngine(index, graph, mesh=cpu_mesh, ell_max_degree=8)
    with pytest.raises(ValueError, match="mesh_shape"):
        restore_sharded_index(engine, os.path.join(directory, "f32"))


def test_without_cuda_the_sharded_engine_raises(index_graph):
    if torch.cuda.is_available():
        return  # the default device is valid
    index, graph = index_graph
    with pytest.raises(RuntimeError, match="CUDA"):
        make_row_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        ShardedQueryEngine(index, graph)


_TORCHRUN_SCRIPT = """
import json, sys
import torch
torch.set_num_threads(1)
from hcrag_tpu_torch.parallel import ShardedQueryEngine, make_row_mesh
from tests import torch_sharded_workers as W
index, graph = W.index_and_graph()
mesh = make_row_mesh(device="cpu")
engine = ShardedQueryEngine(index, graph, mesh=mesh, ell_max_degree=8,
                            quantize_int8=True, int8_rescore=32)
res = engine.query_batch(W.engine_queries(8), top_k=10)
with open(f"{sys.argv[1]}/rank-{mesh.coords['rows']}.json", "w") as f:
    json.dump([mesh.coords["rows"], mesh.backend, res.top_indices.tolist()], f)
"""


def test_torchrun_ranks_equal_unsharded(tmp_path, one_rank):
    """Under `torchrun` (2 processes, its localhost rendezvous) each rank's
    `make_row_mesh()` takes the environment's group, and both ranks return
    the unsharded engine's indices."""
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "shard.py"
    script.write_text(_TORCHRUN_SCRIPT)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", str(script), str(tmp_path)],
        cwd=root, env=dict(os.environ, PYTHONPATH=root), capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    # A file per rank: the ranks share one stdout, where lines can interleave.
    outs = sorted(json.loads((tmp_path / f"rank-{r}.json").read_text()) for r in range(2))
    want = one_rank["int8"][1].query_batch(W.engine_queries(8), top_k=10)
    assert [o[:2] for o in outs] == [[0, "gloo"], [1, "gloo"]]
    for o in outs:
        assert o[2] == want.top_indices.tolist()
