"""The driver's entry points on the card: the query step for a single-card
check, and a dry run of the whole path over several ranks.

    python -m hcrag_tpu_torch.graft_entry      # entry(), then dryrun_multichip(8)

Counterpart of `__graft_entry__.py`:

`entry(device)` returns (step, example_args): the fused retrieve -> expand
-> score step (`QueryEngine._build_step`, top_k 10, depth 1, 20 expanded
nodes, the COMPOSITE weights) over `synthetic_setup(2048, 384)` with an
ELL table of degree 8, and its eight operands on the device (entity words
as the port's int32 words).  The JAX engine caches its step; the port
builds it at each call, so there is nothing to cache.

`dryrun_multichip(n, device)` runs JAX's five parts over n ranks, one
process each (the port's SPMD model), on a (batch, rows) mesh of
(2, n / 2) ranks for an even n above 2, else (1, n):
  (a) the sharded forward over 1,024 x 128 rows at expansion depth 2;
  (b) the residency modes (bf16 + exact rescore, int8 + rescore,
      int8 residual, the split graph), each sharded engine equal to the
      unsharded engine built with the same options;
  (c) 1,024 requests through `BatchedExecutor` over the sharded
      `exact_rescore=32` engine (rank 0 submits, the other ranks follow),
      each served row equal to the unsharded engine's;
  (d) the seeded `RetrievalAgent` over the sharded engine, its trace equal
      to the same run over the unsharded engine, and equal on every rank;
  (e) the data-parallel contrastive step of the MiniLM encoder
      (`contrastive_train`), one pair a rank (two on a single rank: one
      pair alone has no in-batch negative, and its loss is 0 at every
      step, so JAX's dry run over one device fails its own check).
With no default process group it spawns the ranks (`parallel/launch.
run_ranks`: gloo, ranks that may share one card, or CPU ranks for
`device="cpu"`); inside an existing group (torchrun) it runs in place, on
the group's ranks; one rank runs in this process, over NCCL on a card.

Both run on the card unless the caller names another device, and raise
without CUDA.
"""

from __future__ import annotations

import hashlib
import time
from typing import Dict, Optional, Union

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from hcrag_tpu_torch.device import resolve_device
from hcrag_tpu_torch.models.minilm import MiniLMConfig, MiniLMEncoder, flax_to_state
from hcrag_tpu_torch.parallel.sharded_ops import _collective
from hcrag_tpu_torch.utils.synthetic import synthetic_setup
from hcrag_tpu_torch.utils.train_checkpoint import optax_adamw

Device = Optional[Union[str, torch.device]]

#: The dry run's MiniLM encoder (JAX's `dryrun_multichip` configuration).
DRYRUN_MINILM = MiniLMConfig(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
                             intermediate_size=256, max_position=32)
#: InfoNCE temperature and AdamW learning rate of the contrastive step.
TEMPERATURE, LR = 0.05, 1e-3
#: The dry run's index rows, width, batch and top_k.
DRYRUN_ROWS, DRYRUN_DIM, DRYRUN_BATCH, DRYRUN_K = 1024, 128, 8, 5
#: (name, engine options, shard_graph): the residency modes of part (b).
DRYRUN_MODES = (
    ("bf16+exact_rescore", dict(exact_rescore=32), False),
    ("int8+rescore", dict(quantize_int8=True, int8_rescore=32), False),
    ("int8_residual", dict(quantize_int8=True, int8_only=True, int8_residual=True,
                           int8_rescore=32), False),
    ("shard_graph", {}, True),
)
#: Requests served in part (c).
DRYRUN_REQUESTS = 1024
AGENT_QUESTION = "node n5 and its described documents"
RESULT_FIELDS = ("top_scores", "top_indices", "relevance", "combined",
                 "expanded_nodes", "expanded_counts", "expanded_relevance")


def entry(device: Device = None):
    """(step, example_args) of the fused query step over a 2048-row
    synthetic index, the operands on `device` (CUDA unless named)."""
    from hcrag_tpu_torch.core.types import ScorerType, scorer_spec
    from hcrag_tpu_torch.query.engine import QueryEngine

    dev = resolve_device(device)
    n, d, b, k = 2048, 384, 8, 10
    index, graph = synthetic_setup(n, d)
    engine = QueryEngine(index, graph, ell_max_degree=8, device=dev)
    w, reduction = scorer_spec(ScorerType.COMPOSITE, None)
    step = engine._build_step(top_k=k, depth=1, max_expanded=20, reduction=reduction)

    rng = np.random.default_rng(0)
    q = rng.standard_normal((b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    example_args = (
        torch.from_numpy(q).to(dev),
        torch.zeros((b, index.entity_bits.shape[1]), dtype=torch.int32, device=dev),
        torch.zeros((b,), dtype=torch.int32, device=dev),
        torch.zeros((b,), dtype=torch.int32, device=dev),
        torch.from_numpy(w).to(dev),
        engine._type_mask(None),
        torch.zeros((b, k), dtype=torch.float32, device=dev),
        engine._bank(),
    )
    return step, example_args


class _GatherWithGrad(torch.autograd.Function):
    """[s, ...] of every rank's tensor, in group-rank order; the backward
    sums the upstream gradients of every rank and keeps this rank's slice
    (what `torch.distributed.nn.functional.all_gather` does), both through
    `_collective`."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _collective("all_gather", x, group)

    @staticmethod
    def backward(ctx, grad):
        total = _collective("all_reduce", grad.contiguous().clone(), ctx.group)
        return total[dist.get_rank(ctx.group)], None


def contrastive_pairs(n_pairs: int, seq: int, vocab: int):
    """(query ids, document ids) [n_pairs, seq] int32 as JAX's dry run
    draws them from `default_rng(0)`: random document tokens in
    [3, vocab), and the query a copy with 30% of its tokens redrawn."""
    rng = np.random.default_rng(0)
    d_ids = rng.integers(3, vocab, size=(n_pairs, seq)).astype(np.int32)
    corrupt = rng.random((n_pairs, seq)) < 0.3
    q_ids = np.where(corrupt, rng.integers(3, vocab, size=(n_pairs, seq)), d_ids)
    return q_ids.astype(np.int32), d_ids


def contrastive_train(
    mesh,
    *,
    steps: int = 3,
    cfg: MiniLMConfig = DRYRUN_MINILM,
    pairs_per_rank: int = 1,
    seq: int = 16,
    init: Optional[Dict[str, np.ndarray]] = None,
) -> dict:
    """Data-parallel contrastive training of the MiniLM encoder over every
    rank of `mesh` (the flagship step of JAX's dry run).

    Each rank holds the whole encoder (from `init`, the Flax tree's
    flattened arrays, else the seeded initialization, seed 0: the same on
    every rank) and its `pairs_per_rank` pairs of `contrastive_pairs`
    (rank r the r-th block).  A step embeds them, gathers every rank's
    query and document embeddings with their gradient, takes InfoNCE at
    `TEMPERATURE` over the global [B, B] logits (positives on the
    diagonal), and steps optax's AdamW at `LR`.  Every rank computes the
    whole global loss, so the gather's backward hands each rank n times
    its share of the gradient: the all-reduce of the flattened gradients
    (one `_collective` call) is divided by n, which gives each rank the
    gradient of the global loss.

    Returns {"losses": each step's loss (before the step), "grads": step
    1's averaged gradient by parameter name (CPU tensors), "model": the
    trained encoder, "reduce_bytes":
    the bytes of one all-reduce, "step_ms": each step's time by CUDA events
    on a card, else None}."""
    group = mesh.world
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    dev = mesh.device
    q_ids, d_ids = contrastive_pairs(world * pairs_per_rank, seq, cfg.vocab_size)
    mine = slice(rank * pairs_per_rank, (rank + 1) * pairs_per_rank)
    qi = torch.from_numpy(q_ids[mine]).to(dev, torch.int64)
    di = torch.from_numpy(d_ids[mine]).to(dev, torch.int64)
    mask = torch.ones_like(qi)
    labels = torch.arange(world * pairs_per_rank, device=dev)

    model = MiniLMEncoder(cfg, generator=torch.Generator().manual_seed(0))
    if init is not None:
        model.load_state_dict(flax_to_state(init, cfg))
    model.to(dev)
    named = list(model.named_parameters())
    optimizer = optax_adamw([p for _, p in named], LR)

    def gathered(x):
        return _GatherWithGrad.apply(x, group).reshape(-1, x.shape[-1])

    timed = dev.type == "cuda"
    losses, step_ms, grads = [], [], None
    flat = None
    for i in range(steps):
        if timed:
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        optimizer.zero_grad(set_to_none=True)
        q_all, d_all = gathered(model(qi, mask)), gathered(model(di, mask))
        loss = F.cross_entropy(torch.matmul(q_all, d_all.T) / TEMPERATURE, labels)
        loss.backward()
        flat = torch.cat([p.grad.reshape(-1) for _, p in named])
        _collective("all_reduce", flat, group)
        flat /= world
        offset = 0
        for _, p in named:
            p.grad.copy_(flat[offset:offset + p.numel()].view_as(p))
            offset += p.numel()
        if i == 0:
            grads = {name: p.grad.detach().cpu().clone() for name, p in named}
        optimizer.step()
        if timed:
            stop.record()
        losses.append(float(loss.detach()))
        if timed:
            step_ms.append(start.elapsed_time(stop))
    return {"losses": losses, "grads": grads, "model": model,
            "reduce_bytes": 0 if flat is None else flat.numel() * flat.element_size(),
            "step_ms": step_ms if timed else None}


def _arrays(res) -> Dict[str, np.ndarray]:
    return {f: np.asarray(getattr(res, f)) for f in RESULT_FIELDS}


def _same(got: dict, want: dict, label: str) -> None:
    """The dry run's equality: indices and expansion exactly, scores within
    1e-5."""
    np.testing.assert_array_equal(got["top_indices"], want["top_indices"],
                                  err_msg=f"{label}: top_indices diverge")
    np.testing.assert_allclose(got["top_scores"], want["top_scores"], atol=1e-5,
                               err_msg=f"{label}: top_scores diverge")
    np.testing.assert_array_equal(got["expanded_nodes"], want["expanded_nodes"],
                                  err_msg=f"{label}: expansion diverges")


def agent_fingerprint(engine, graph) -> tuple:
    """(node trace, final node ids, final scores rounded to 6 places,
    decision) of the seeded agent's run on `AGENT_QUESTION`."""
    from hcrag_tpu_torch.config import RuntimeConfig
    from hcrag_tpu_torch.pipeline.agent import RetrievalAgent

    agent = RetrievalAgent(engine, graph, config=RuntimeConfig(random_seed=7))
    r = agent.run(AGENT_QUESTION)
    return (
        r.node_trace,
        [n.graph_relations.get("node_id") for n in r.final_relevant_nodes],
        [round(float(n.score), 6) for n in r.final_relevant_nodes],
        r.decision,
    )


def _agree_across_ranks(fp: tuple, group, device) -> None:
    """Raise unless every rank's fingerprint hashes alike."""
    digest = torch.tensor(list(hashlib.sha256(repr(fp).encode()).digest()), dtype=torch.int64,
                          device=device)
    every = _collective("all_gather", digest, group)
    if not bool((every == digest).all()):
        raise AssertionError(f"the agent's trace differs across ranks: {fp}")


def _dryrun_mesh(world: int, device: torch.device):
    from hcrag_tpu_torch.parallel import make_batch_row_mesh

    if world % 2 == 0 and world > 2:
        return make_batch_row_mesh(2, world // 2, device=device)
    return make_batch_row_mesh(1, world, device=device)


def _dryrun(world: int, device: torch.device) -> dict:
    """This rank's part of the dry run (inside a default group of `world`
    ranks): runs and checks the five parts; returns {"mesh", "forward",
    "modes": name -> (sharded, unsharded) arrays, "served" (rank 0; None
    on the others), "serve_ref", "batches", "agent", "contrastive",
    "status", "seconds": part -> host seconds}."""
    from hcrag_tpu_torch.parallel import ShardedQueryEngine
    from hcrag_tpu_torch.query.engine import QueryEngine
    from hcrag_tpu_torch.query.executor import BatchedExecutor

    mesh = _dryrun_mesh(world, device)
    rank = dist.get_rank()
    n_rows, dim, b, k = DRYRUN_ROWS, DRYRUN_DIM, DRYRUN_BATCH, DRYRUN_K
    index, graph = synthetic_setup(n_rows, dim)
    seconds = {}

    # (a) the sharded forward.
    t0 = time.perf_counter()
    engine = ShardedQueryEngine(index, graph, mesh=mesh, ell_max_degree=8)
    rng = np.random.default_rng(1)
    q = rng.standard_normal((b, dim)).astype(np.float32)
    forward = _arrays(engine.query_batch(q, top_k=k, expansion_depth=2, max_expanded=10))
    if forward["top_indices"].shape != (b, k) or not (forward["expanded_counts"] >= 0).all():
        raise AssertionError("the sharded forward's shapes")
    seconds["forward"] = time.perf_counter() - t0

    # (b) the residency modes, each against the unsharded engine.
    t0 = time.perf_counter()
    modes, mode_status = {}, []
    for name, opts, shard_graph in DRYRUN_MODES:
        single = QueryEngine(index, graph, device=mesh.device, **opts)
        sharded = ShardedQueryEngine(index, graph, mesh=mesh, shard_graph=shard_graph, **opts)
        got = _arrays(sharded.query_batch(q, top_k=k, expansion_depth=2, max_expanded=10))
        want = _arrays(single.query_batch(q, top_k=k, expansion_depth=2, max_expanded=10))
        _same(got, want, f"sharded mode {name}")
        modes[name] = (got, want)
        mode_status.append(f"{name} ok")
    seconds["modes"] = time.perf_counter() - t0

    # (c) serving over the sharded engine: rank 0 submits, the others follow.
    t0 = time.perf_counter()
    single_ref = QueryEngine(index, graph, device=mesh.device, exact_rescore=32)
    serve_engine = ShardedQueryEngine(index, graph, mesh=mesh, exact_rescore=32)
    sq = rng.standard_normal((DRYRUN_REQUESTS, dim)).astype(np.float32)
    sq /= np.linalg.norm(sq, axis=1, keepdims=True)
    ex = BatchedExecutor(serve_engine, batch_size=256, top_k=k, batch_sizes=(64, 256))
    served = None
    try:
        if rank == 0:
            futs = [ex.submit(sq[0])]
            futs += ex.submit_many(sq[1:])
            served = [f.result(timeout=600) for f in futs]
    finally:
        ex.shutdown()
    ref = _arrays(single_ref.query_batch(sq, top_k=k))
    if served is not None:
        for i, (scores, idx) in enumerate(served):
            np.testing.assert_array_equal(
                idx, ref["top_indices"][i],
                err_msg=f"served request {i}: indices diverge from the unsharded engine")
            np.testing.assert_allclose(scores, ref["top_scores"][i], atol=1e-5,
                                       err_msg=f"served request {i}: scores diverge")
        served = {"top_scores": np.stack([s for s, _ in served]),
                  "top_indices": np.stack([i for _, i in served])}
    serve_status = f"serve ok ({DRYRUN_REQUESTS} futures, {ex.batches_dispatched} batches)"
    seconds["serve"] = time.perf_counter() - t0

    # (d) the seeded agent over the sharded engine, on every rank.
    t0 = time.perf_counter()
    fp_sharded = agent_fingerprint(serve_engine, graph)
    fp_single = agent_fingerprint(single_ref, graph)
    if fp_sharded != fp_single:
        raise AssertionError(f"agent trace diverges on the mesh: {fp_sharded} vs {fp_single}")
    _agree_across_ranks(fp_sharded, mesh.world, mesh.device)
    agent_status = f"agent ok ({len(fp_sharded[1])} final nodes, decision={fp_sharded[3]!r})"
    seconds["agent"] = time.perf_counter() - t0

    # (e) the data-parallel contrastive step.
    t0 = time.perf_counter()
    # One pair on one rank has no negative (its loss is identically 0), so a
    # world of one takes two.
    contrastive = contrastive_train(mesh, pairs_per_rank=2 if world == 1 else 1)
    losses = contrastive["losses"]
    if not all(np.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"contrastive loss did not decrease: {losses}")
    seconds["contrastive"] = time.perf_counter() - t0
    # numpy, so that a spawned rank's result crosses the process boundary.
    contrastive["grads"] = {k: v.numpy() for k, v in contrastive["grads"].items()}
    del contrastive["model"]

    status = (
        f"dryrun_multichip ok: mesh={mesh.shape}, "
        f"retrieval top-k {forward['top_indices'].shape}, "
        f"residency modes [{', '.join(mode_status)}], "
        f"{serve_status}, {agent_status}, "
        f"minilm train loss {losses[0]:.4f} -> {losses[-1]:.4f}"
    )
    if rank == 0:
        print(status, flush=True)
    return {"mesh": mesh.shape, "forward": forward, "modes": modes, "served": served,
            "serve_ref": ref, "batches": ex.batches_dispatched, "agent": fp_sharded,
            "contrastive": contrastive, "status": status, "seconds": seconds}


def _dryrun_rank(rank: int, world: int, device: str) -> dict:
    return _dryrun(world, torch.device(device))


def dryrun_multichip(n_devices: int, device: Device = None) -> dict:
    """The dry run over `n_devices` ranks (see the module's docstring);
    returns rank 0's `_dryrun` result (this rank's, inside a group)."""
    from hcrag_tpu_torch.parallel.launch import run_ranks

    dev = resolve_device(device)
    if dist.is_initialized():
        if dist.get_world_size() != n_devices:
            raise ValueError(f"dryrun_multichip({n_devices}) inside a group of "
                             f"{dist.get_world_size()} ranks")
        return _dryrun(n_devices, dev)
    if n_devices == 1:
        try:
            return _dryrun(1, dev)
        finally:
            dist.destroy_process_group()
    return run_ranks(_dryrun_rank, n_devices, args=(str(dev),))[0]


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    print("entry() ok:", [tuple(o.shape) for o in out])
    dryrun_multichip(8)
