"""Kernel B6 (`batch_relevance`) of the PyTorch port: its plain version
against the Pallas kernel in interpret mode across the shapes that reach
either of the kernel's two regimes, and the launch plan that picks the
regime.

The plain version is what the wrapper runs for CPU tensors, and what the
card holds the CUDA kernel to (tests/test_torch_cuda.py, chip_smoke.py).
Tolerance 1e-5: the dot's f32 sum runs in another order; the metrics and
their reduction round as the Pallas body does.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hcrag_tpu.core.types import PRIORITY_MATRIX
from hcrag_tpu.ops.scoring_pallas import pallas_batch_relevance
from hcrag_tpu_torch.ops import scoring_cuda
from hcrag_tpu_torch.ops.scoring_cuda import batch_relevance, launch_plan

TOL = dict(atol=1e-5, rtol=0)


def _bank(b, n, d, w, seed):
    """Normalized rows, bit words (every other query and every 7th node
    without entities), counts, intents, node types with two ids outside
    the table, an llm column and the weights."""
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
    intents = rng.integers(0, 5, b).astype(np.int32)
    tids = rng.integers(0, 6, n).astype(np.int32)
    tids[1:3] = [6, -1][: max(0, min(2, n - 1))]
    llm = rng.uniform(0, 1, (b, n)).astype(np.float32)
    weights = np.array([0.3, 0.45, 0.15, 0.1], np.float32)
    return (q, qb, qc, intents, e, nb, nc, tids, weights), llm


def _t(a):
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


SHAPES = [(b, n, d) for b in (1, 3, 16, 17, 64) for n in (1, 63, 700) for d in (16, 384)]


@pytest.mark.parametrize("case", range(len(SHAPES)))
def test_b6_plain_equals_pallas_across_regimes(case):
    """b of 1-16 is regime (a)'s, 17 and 64 the tiled loop's; n ragged
    against every block size; W of 1 and 8 words, both reductions, with and
    without the llm column, each met by several shapes."""
    b, n, d = SHAPES[case]
    w, reduction, with_llm = (1, 8)[case % 2], (case // 2) % 2, bool((case // 4) % 2)
    arrays, llm = _bank(b, n, d, w, seed=case)
    want = np.asarray(pallas_batch_relevance(
        *(jnp.asarray(a) for a in arrays), jnp.asarray(llm) if with_llm else None,
        reduction=reduction, tile=256, interpret=True,
    ))
    got = batch_relevance(*(_t(a) for a in arrays), torch.from_numpy(PRIORITY_MATRIX),
                          _t(llm) if with_llm else None, reduction=reduction)
    assert got.shape == (b, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def _operands(b, d, offset=0):
    """f32 query and node rows on the CPU whose data starts `offset`
    floats into a fresh (64-byte aligned) buffer."""
    q = torch.empty(b * d + offset)[offset:].view(b, d)
    e = torch.empty(64 * d + offset)[offset:].view(64, d)
    return q, e


def _want(b, d, w=8):
    """The plan by the rule: the tiled loop past 16 queries where d % 8 ==
    0 (aligned rows, W = 8), else the smallest query block of (a) that
    covers min(b, 16), float4 rows where d % 4 == 0."""
    if b > 16 and d % 8 == 0:
        return "tiled", 128, False
    qn = next(x for x in (1, 2, 4, 8, 16) if x >= min(b, 16))
    return "few", qn, d % 4 == 0


@pytest.mark.parametrize("d", [16, 383, 384, 1040])
def test_b6_launch_plan_by_shape(d):
    for b in range(1, 301):
        q, e = _operands(b, d)
        plan = launch_plan(q, e, 8)
        assert (plan.regime, plan.queries, plan.vec) == _want(b, d), (b, d)
        assert plan.smem <= 232_448


def test_b6_launch_plan_refused_operands_take_the_few_kernel():
    """What the tiled loop refuses runs regime (a) at 16 queries a block:
    a query or node row off a 16-byte boundary, or bit words past the
    loop's shared memory; an unaligned node bank also reads scalars."""
    q, e = _operands(64, 384, offset=1)
    assert launch_plan(q, e, 8)[:2] == (16, False)
    q, _ = _operands(64, 384, offset=1)
    _, e = _operands(64, 384)
    assert launch_plan(q, e, 8)[:2] == (16, True)
    q, e = _operands(64, 384)
    assert launch_plan(q, e, 206).regime == "tiled"
    assert launch_plan(q, e, 208)[:2] == (16, True)


def test_b6_launch_plan_takes_every_shape_the_earlier_kernel_took():
    """The earlier kernel took any d with 16 f32 query rows and the two
    tables in one block's shared memory: 4 (16 d + 34) <= 232,448, so d up
    to 3629 at any b; the plan still runs that, and refuses past it where
    16 rows must fit."""
    q, e = _operands(40, 3624)
    assert launch_plan(q, e, 8).regime == "tiled"
    q, e = _operands(40, 3624, offset=1)
    assert launch_plan(q, e, 8)[:2] == (16, False)
    q, e = _operands(40, 3629)
    assert launch_plan(q, e, 8)[:2] == (16, False)
    q, e = _operands(40, 3630)
    with pytest.raises(ValueError, match="shared memory"):
        launch_plan(q, e, 8)


def test_b6_wrapper_runs_the_plain_version_on_the_cpu():
    arrays, llm = _bank(20, 100, 64, 2, seed=3)
    args = [_t(a) for a in arrays] + [torch.from_numpy(PRIORITY_MATRIX), _t(llm)]
    before = batch_relevance.launches
    got = batch_relevance(*args, reduction=0)
    assert batch_relevance.launches == before
    assert torch.equal(got, scoring_cuda.batch_relevance_plain(*args, reduction=0))
