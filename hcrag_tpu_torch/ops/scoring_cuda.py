"""Fused multi-metric relevance scoring, with its CUDA kernel.

Counterpart of `pallas_batch_relevance` (hcrag_tpu/ops/scoring_pallas.py):
`batch_relevance` (kernel B6, csrc/batch_relevance.cu) computes, for a query
batch against a node bank, the four metrics of `ops/scoring.py` (semantic
(cos + 1) / 2, entity-bitset match with the 0.5 / 0.1 empty rules,
intent x node-type priority, an optional LLM-judge column) and their
weighted sum or maximum in one pass, so the [B, N, 4] metric stack never
reaches device memory.  The TPU layout (512-node tiles, a query replicated
to 8 rows) is not carried over: nodes are not padded and one query is a
batch of one.

The wrapper launches the kernel for CUDA tensors (or raises) and runs its
plain PyTorch version, defined beside it, for CPU tensors; it counts its
launches in `batch_relevance.launches`.  `launch_plan` picks the kernel's
regime from the shapes (csrc/batch_relevance.cu): up to 16 queries, the
byte-bound kernel with the smallest query block that covers them; more, the
register-tiled CUDA-core loop, unless its operand rules refuse the shape.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from hcrag_tpu_torch.core.types import NUM_INTENTS, NUM_NODE_TYPES, REDUCE_MAX
from hcrag_tpu_torch.ops import _build
from hcrag_tpu_torch.ops.quantize import check_exact_matmul
from hcrag_tpu_torch.ops.scoring import popcount_words
from hcrag_tpu_torch.ops.topk_cuda import (
    _SMEM_LIMIT,
    CORE_BLOCK_QUERIES,
    CORE_LOOP_SMEM,
    _check,
)

#: The query blocks of the byte-bound kernel (a), and of the tiled one (b),
#: which runs the CUDA-core loop of B4.
FEW_QUERY_BLOCKS = (1, 2, 4, 8, 16)
TILED_QUERY_BLOCK = CORE_BLOCK_QUERIES
_TABLES = 4 + NUM_INTENTS * NUM_NODE_TYPES  # static shared floats: weights, priority
SIGNATURE = (ctypes.c_void_p,) * 12 + (ctypes.c_int,) * 7 + (ctypes.c_void_p,)


def _kernel():
    fn = _build.load("batch_relevance").batch_relevance
    fn.argtypes = SIGNATURE
    fn.restype = ctypes.c_int
    return fn


class LaunchPlan(NamedTuple):
    """How kernel B6 runs a shape: `queries` per block (1-16: the
    byte-bound kernel (a); 128: the tiled loop (b)), `vec` whether (a)
    reads node rows as float4, and the block's dynamic shared memory."""

    queries: int
    vec: bool
    smem: int

    @property
    def regime(self) -> str:
        return "tiled" if self.queries == TILED_QUERY_BLOCK else "few"


def _few_smem(qn: int, d: int) -> int:
    """Kernel (a)'s shared memory: the query rows, reused for the dots of
    its 32 node rows."""
    return 4 * qn * max(d, 32)


def launch_plan(q_emb: torch.Tensor, node_emb: torch.Tensor, w: int) -> LaunchPlan:
    """The regime of kernel B6 for these operands (any device; the CUDA
    wrapper launches what it returns).  More than 16 queries take the tiled
    loop where its rules allow (d % 8 == 0, both float operands on 16-byte
    boundaries, the bit words of 128 queries and 128 nodes in shared
    memory); otherwise the byte-bound kernel at the smallest query block in
    FEW_QUERY_BLOCKS that covers min(b, 16).  Raises ValueError where
    neither fits shared memory."""
    b, d = q_emb.shape
    aligned = q_emb.data_ptr() % 16 == 0 and node_emb.data_ptr() % 16 == 0
    tiled_smem = CORE_LOOP_SMEM + 8 * TILED_QUERY_BLOCK * ((w | 1) + 2)
    if b > 16 and d % 8 == 0 and aligned and tiled_smem + 4 * _TABLES <= _SMEM_LIMIT:
        return LaunchPlan(TILED_QUERY_BLOCK, False, tiled_smem)
    qn = next(x for x in FEW_QUERY_BLOCKS if x >= min(b, 16))
    smem = _few_smem(qn, d)
    if smem + 4 * _TABLES > _SMEM_LIMIT:
        raise ValueError(f"d={d}: the query block does not fit shared memory")
    return LaunchPlan(qn, d % 4 == 0 and node_emb.data_ptr() % 16 == 0, smem)


def batch_relevance_plain(
    q_emb: torch.Tensor,
    q_bits: torch.Tensor,
    q_counts: torch.Tensor,
    intent_ids: torch.Tensor,
    node_emb: torch.Tensor,
    node_bits: torch.Tensor,
    node_counts: torch.Tensor,
    node_type_ids: torch.Tensor,
    weights: torch.Tensor,
    priority: torch.Tensor,
    llm_scores: Optional[torch.Tensor] = None,
    *,
    reduction: int = 0,
) -> torch.Tensor:
    """Plain PyTorch version of kernel B6 (same contract; the dot's f32 sum
    is taken in another order, so scores agree to rounding).

    q_emb [B, D] f32, q_bits [B, W] int32 words (uint32 bits), q_counts [B]
    int32 (in-vocabulary popcount + out-of-vocabulary count), intent_ids [B]
    int32, node_emb [N, D] f32, node_bits [N, W] int32, node_counts [N]
    int32, node_type_ids [N] int32, weights [4] f32, priority
    [NUM_INTENTS, NUM_NODE_TYPES] f32, llm_scores [B, N] f32 or None (zeros)
    -> scores [B, N] f32: the weighted sum ((sem*w0 + llm*w1) + ent*w2) +
    typ*w3 (`reduction` 0) or max(max(sem, llm), max(ent, typ)) (1).  An
    intent or type id outside the table scores priority 0."""
    check_exact_matmul()
    b, n = q_emb.shape[0], node_emb.shape[0]
    dev = q_emb.device
    sem = (q_emb.to(torch.float32) @ node_emb.to(torch.float32).T + 1.0) * 0.5
    inter = popcount_words(q_bits[:, None, :] & node_bits[None, :, :])
    q_count = q_counts.to(torch.float32)[:, None]
    ratio = inter.to(torch.float32) / torch.clamp(q_count, min=1.0)
    ent = torch.where(
        q_count == 0.0,
        torch.where(node_counts[None, :] == 0, 0.5, 0.1),
        ratio,
    )
    it = intent_ids.to(torch.int64)[:, None]
    ty = node_type_ids.to(torch.int64)[None, :]
    inside = (it >= 0) & (it < NUM_INTENTS) & (ty >= 0) & (ty < NUM_NODE_TYPES)
    typ = torch.where(
        inside, priority[it.clamp(0, NUM_INTENTS - 1), ty.clamp(0, NUM_NODE_TYPES - 1)],
        0.0,
    )
    if llm_scores is None:
        llm = torch.zeros((b, n), dtype=torch.float32, device=dev)
    else:
        llm = llm_scores.to(torch.float32)
    if reduction == REDUCE_MAX:
        return torch.maximum(torch.maximum(sem, llm), torch.maximum(ent, typ))
    w = weights.to(torch.float32)
    return sem * w[0] + llm * w[1] + ent * w[2] + typ * w[3]


def batch_relevance(
    q_emb: torch.Tensor,
    q_bits: torch.Tensor,
    q_counts: torch.Tensor,
    intent_ids: torch.Tensor,
    node_emb: torch.Tensor,
    node_bits: torch.Tensor,
    node_counts: torch.Tensor,
    node_type_ids: torch.Tensor,
    weights: torch.Tensor,
    priority: torch.Tensor,
    llm_scores: Optional[torch.Tensor] = None,
    *,
    reduction: int = 0,
) -> torch.Tensor:
    """Kernel B6 for CUDA tensors, its plain version for CPU tensors (see
    `batch_relevance_plain` for the contract)."""
    args = (q_emb, q_bits, q_counts, intent_ids, node_emb, node_bits,
            node_counts, node_type_ids, weights, priority, llm_scores)
    if q_emb.device.type == "cpu":
        return batch_relevance_plain(*args, reduction=reduction)
    if q_emb.device.type != "cuda":
        raise ValueError(f"q_emb must be a CUDA or CPU tensor, got {q_emb.device}")
    b, d = q_emb.shape
    n, w = node_emb.shape[0], q_bits.shape[1]
    dev = q_emb.device
    _check(q_emb, "q_emb", torch.float32, (b, d), dev)
    _check(q_bits, "q_bits", torch.int32, (b, w), dev)
    _check(q_counts, "q_counts", torch.int32, (b,), dev)
    _check(intent_ids, "intent_ids", torch.int32, (b,), dev)
    _check(node_emb, "node_emb", torch.float32, (n, d), dev)
    _check(node_bits, "node_bits", torch.int32, (n, w), dev)
    _check(node_counts, "node_counts", torch.int32, (n,), dev)
    _check(node_type_ids, "node_type_ids", torch.int32, (n,), dev)
    _check(weights, "weights", torch.float32, (4,), dev)
    _check(priority, "priority", torch.float32, (NUM_INTENTS, NUM_NODE_TYPES), dev)
    if llm_scores is not None:
        _check(llm_scores, "llm_scores", torch.float32, (b, n), dev)
    if b == 0 or n == 0 or w == 0:
        raise ValueError("batch_relevance needs a query, a node and a bit word")
    if reduction not in (0, 1):
        raise ValueError(f"reduction must be 0 or 1, got {reduction}")
    plan = launch_plan(q_emb, node_emb, w)
    out = torch.empty((b, n), dtype=torch.float32, device=dev)
    err = _kernel()(
        q_emb.data_ptr(), q_bits.data_ptr(), q_counts.data_ptr(),
        intent_ids.data_ptr(), weights.data_ptr(), priority.data_ptr(),
        node_emb.data_ptr(), node_bits.data_ptr(), node_counts.data_ptr(),
        node_type_ids.data_ptr(),
        None if llm_scores is None else llm_scores.data_ptr(),
        out.data_ptr(), b, n, d, w, reduction, plan.queries, int(plan.vec),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(f"batch_relevance launch failed: CUDA error {err}")
    batch_relevance.launches += 1
    return out


batch_relevance.launches = 0
