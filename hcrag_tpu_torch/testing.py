"""Test fixtures, and comparisons of the float selection kernels with
their plain versions.

`create_sample_nodes` and `create_sample_query` are the 18 typed demo nodes
(products, documents, specifications, categories, an annotation; relevant
to irrelevant for the canonical query) and that query, with embeddings from
the hashing embedder, the same as the JAX package's `testing.py` gives.  `RowLookupEmbedder`
encodes a row's own text to the row's stored embedding, so questions over a
synthetic index of random rows find their rows, as with an encoder that
knows the corpus.

Kernels B4, B5, B7f and B8 take their f32 dot sums in another order than the
plain versions' matrix products, so the two agree to rounding, not to the
bit.
These checks state how far they may differ and raise AssertionError past
that; `tests/test_torch_cuda.py` and `chip_smoke.py` use them on the card.

  * B4 (`check_exact_topk`): values within `atol`; an index may differ only
    where the two rows' scores (recomputed in float64) lie within `atol` of
    each other, a near-tie that rounding can order either way.
  * B5 and B7f (`check_packed_topk`): keys equal, except in a tile where a
    row that either side selected has its shifted score within 1e-6 of a
    multiple of the key quantum (B5: 2^-11 above 2, 2^-12 below; B7f over
    lbits-row supertiles: lbits times 2^-22 above 2, 2^-23 below), where
    rounding can move the row's key by one quantum.  On inputs whose dots
    are exact in any order (multiples of 1/64, say) the two are bit-equal.
    Over a bf16 bank both kernels sum on the tensor cores, which add in
    their own order and rounding; the band holds for them while their sums
    stay within `TC_DOT_ERROR` (the same 1e-6) of the float64 dots.  On an
    NVIDIA H100 80GB HBM3 at 700 W the loop's largest error over 512 x
    65,536 normalized rows at d = 384 measured 1.6e-7 (an f32 matrix
    product's: 1.3e-7), so the band is unchanged; `chip_smoke.py` measures
    it again on every run and fails past the band.
  * B8c (`check_level1`): the [m1 | m2] keys equal, except where the row a
    differing key may come from (its column, in any tile) has its shifted
    score within 1e-6 of a multiple of the key quantum (2^-11 above 2,
    2^-12 below) and within a quantum of that key's score.  Bit-equal on
    exact dots.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from hcrag_tpu_torch.core.types import NodeInput, QueryInput, QueryIntent
from hcrag_tpu_torch.models.embedder import HashingEmbedder

_EMBEDDER = HashingEmbedder()

_FIXTURES = [
    # (text, node_type, entities)
    ("Premium Red Mountain Bike - Trail Blazer X1 with advanced suspension "
     "and lightweight frame, perfect for off-road adventures under $900",
     "product", ["red mountain bike", "trail", "suspension", "lightweight"]),
    ("Blue Mountain Bike - Rugged terrain specialist with 21-speed gear "
     "system, priced at $750",
     "product", ["blue mountain bike", "terrain", "gear system"]),
    ("Mountain Bike Maintenance Guide - Complete handbook for maintaining "
     "your mountain bike including brake adjustments, tire care, and gear "
     "tuning",
     "document", ["mountain bike", "maintenance", "brake", "tire"]),
    ("Red Road Bike - Speed demon for paved roads with aerodynamic design, "
     "$1200",
     "product", ["red road bike", "aerodynamic", "speed"]),
    ("Mountain Bike Frame Specifications - Technical details for aluminum "
     "and carbon fiber mountain bike frames, weight tolerances and geometry",
     "specification", ["mountain bike", "frame", "aluminum", "carbon fiber"]),
    ("Mountain Bikes Category - Off-road bicycles designed for rough "
     "terrain riding",
     "category", ["mountain bike", "off-road"]),
    ("Red Mountain Bike Helmet - Safety certified helmet with ventilation, "
     "matches red bikes, $85",
     "product", ["red", "helmet", "safety"]),
    ("Kitchen Blender 3000 - High-powered blender for smoothies and food "
     "preparation, $120",
     "product", ["blender", "kitchen"]),
    ("Office Chair Assembly Manual - Step-by-step guide for assembling "
     "ergonomic office chairs",
     "document", ["office chair", "assembly"]),
    ("Laptop Computer Specifications - 16GB RAM, 512GB SSD, 14-inch display "
     "technical specs",
     "specification", ["laptop", "computer"]),
    ("Mountain Bike Wheels 29-inch - Tubeless-ready wheels for mountain "
     "bikes, pair $320",
     "product", ["mountain bike", "wheel", "tubeless"]),
    ("Touring Bike Travel Guide - Long distance cycling routes and "
     "equipment recommendations",
     "document", ["touring bike", "travel"]),
    ("Bicycle Brake Pads Specification - Compatibility chart for disc and "
     "rim brake pads",
     "specification", ["brake", "bicycle"]),
    ("Garden Hose 50ft - Flexible watering hose for outdoor use, $35",
     "product", ["garden hose"]),
    ("Road Bikes Category - Lightweight bicycles optimized for paved "
     "surfaces",
     "category", ["road bike", "lightweight"]),
    ("Mountain Bike Suspension Service Manual - Fork and shock maintenance "
     "procedures with torque specifications",
     "document", ["mountain bike", "suspension", "fork"]),
    ("Black Mountain Bike Gloves - Padded cycling gloves size M-XL, $25",
     "product", ["black", "gloves", "mountain bike"]),
    ("Annotation: Mountain bike geometry diagram Figure 3",
     "annotation", ["mountain bike", "geometry"]),
]



def create_sample_nodes() -> List[NodeInput]:
    """18 typed fixture nodes with deterministic embeddings."""
    return [
        NodeInput(
            text=text,
            embeddings=_EMBEDDER.encode([text])[0],
            graph_relations={"type": node_type},
            node_type=node_type,
            entities=entities,
        )
        for text, node_type, entities in _FIXTURES
    ]


def create_sample_query(
    text: str = "Find red mountain bikes under $1000",
    intent: QueryIntent = QueryIntent.PRODUCT_SEARCH,
) -> QueryInput:
    """The canonical demo query with its embedding."""
    return QueryInput(
        text=text,
        embeddings=_EMBEDDER.encode([text])[0],
        entities=["red mountain bike"],
        intent=intent,
    )


class RowLookupEmbedder:
    """Encodes a text equal to an index row's text to that row's stored
    embedding (the first such row), any other text by the hashing embedder
    at the index's width.  Host numpy, like the hashing embedder; either
    package's engine takes it as its `embedder`."""

    def __init__(self, index):
        self.dim = int(np.asarray(index.emb).shape[1])
        self._emb = index.emb
        self._rows = {}
        for i, text in enumerate(index.texts):
            self._rows.setdefault(text, i)
        self._fallback = HashingEmbedder(dim=self.dim)

    def encode(self, texts: Sequence[str]) -> np.ndarray:
        out = np.empty((len(texts), self.dim), np.float32)
        for j, text in enumerate(texts):
            row = self._rows.get(text)
            out[j] = (self._fallback.encode([text])[0] if row is None
                      else np.asarray(self._emb[row], np.float32))
        return out


NEAR_BOUNDARY = 1e-6
#: The most the tensor-core dot loop of B5 / B7f may differ from the
#: float64 dots for `check_packed_topk`'s band to hold.
TC_DOT_ERROR = NEAR_BOUNDARY


def _dots(q: torch.Tensor, e: torch.Tensor, b_idx, rows) -> torch.Tensor:
    """float64 dots of queries q[b_idx] with rows e[rows] (same shapes)."""
    return (q[b_idx].double() * e[rows.long()].double()).sum(dim=-1)


def check_exact_topk(kv, ki, pv, pi, q, e, mask, atol: float = 1e-5) -> Tuple[float, int]:
    """B4's kernel output (kv, ki) against its plain version's (pv, pi), all
    [B, tiles, k], for operands q [B, D], e [N, D], mask [N].  Returns (max
    abs value difference, number of indices that differ at near-ties)."""
    err = float((kv.double() - pv.double()).abs().max())
    if err > atol:
        raise AssertionError(f"values differ by {err} > {atol}")
    bad = (ki != pi).nonzero()
    if len(bad):
        at = tuple(bad.T)
        rk, rp = ki[at], pi[at]
        gap = (_dots(q, e, bad[:, 0], rk) - _dots(q, e, bad[:, 0], rp)).abs()
        ok = (kv[at] > -1e29) & mask[rk.long()] & mask[rp.long()] & (gap <= atol)
        if not bool(ok.all()):
            first = bad[~ok][0].tolist()
            raise AssertionError(f"indices differ at {first} beyond a near-tie")
    return err, len(bad)


def check_packed_topk(kv, ki, pv, pi, q, e, max_share: float = 0.02,
                      lane_bits: int = 2048) -> Tuple[float, int]:
    """B5's (or, with `lane_bits` = lbits, B7f's) kernel output (kv, ki)
    against its plain version's (pv, pi), all [B, tiles, k], for operands
    q [B, D], e [N, D].  Returns (max abs value difference over the slots
    that agree on their row, number of tiles that differ next to a
    key-quantum boundary); raises if such tiles exceed `max_share` of
    all."""
    same_i = ki == pi
    same = same_i & (kv.view(torch.int32) == pv.view(torch.int32))
    bad = (~same).any(dim=2).nonzero()
    if len(bad):
        b_idx, t_idx = bad[:, 0], bad[:, 1]
        rows = torch.cat([ki[b_idx, t_idx], pi[b_idx, t_idx]], dim=1)
        x = _dots(q, e, b_idx[:, None].expand_as(rows), rows.clamp(min=0)) + 2.0
        quantum = torch.where(x >= 2.0, lane_bits * 2.0**-22, lane_bits * 2.0**-23)
        near = ((x - torch.round(x / quantum) * quantum).abs() < NEAR_BOUNDARY)
        excused = (near & (rows >= 0)).any(dim=1)
        if not bool(excused.all()):
            first = bad[~excused][0].tolist()
            raise AssertionError(f"keys differ in (query, tile) {first} away from a boundary")
        if len(bad) > max_share * ki.shape[0] * ki.shape[1]:
            raise AssertionError(f"{len(bad)} tiles differ: more than {max_share:.0%}")
    diff = (kv.double() - pv.double()).abs()
    err = float(torch.where(same_i, diff, 0.0).max())
    return err, len(bad)


def check_level1(kernel_out, plain_out, q, e, tile_n: int, max_share: float = 0.02,
                 chunk: int = 64) -> int:
    """B8c's kernel output against its plain version's, both [B, 256] int32
    ([m1 | m2] keys), for operands q [B, D] and e [N, D] of whole `tile_n`-row
    tiles.  A key names its column in the tile, not the tile, so the rows
    it may come from are that column's rows in every tile; a differing
    entry is excused when, for one of the two keys, such a row lies next to
    a key-quantum boundary and within a quantum of the key's score.
    Returns the number of differing entries; raises past `max_share` of
    all, or at one that is not excused."""
    bad = (kernel_out != plain_out).nonzero()
    if not len(bad):
        return 0
    if len(bad) > max_share * kernel_out.numel():
        raise AssertionError(f"{len(bad)} keys differ: more than {max_share:.0%}")
    n = e.shape[0]
    tile_base = torch.arange(0, n, tile_n, device=e.device)
    for lo in range(0, len(bad), chunk):
        b_idx, slot = bad[lo:lo + chunk, 0], bad[lo:lo + chunk, 1]
        keys = torch.stack([kernel_out[b_idx, slot], plain_out[b_idx, slot]], dim=1)
        col = 2047 - (keys & 2047)
        score = (keys & ~2047).view(torch.float32).double()  # the key's s + 2
        rows = col[:, :, None] + tile_base  # [m, 2, tiles]
        real = ((keys > 0) & (col < tile_n))[:, :, None]
        x = _dots(q, e, b_idx[:, None, None].expand_as(rows), rows.clamp(max=n - 1)) + 2.0
        quantum = torch.where(x >= 2.0, 2.0**-11, 2.0**-12)
        near = (x - torch.round(x / quantum) * quantum).abs() < NEAR_BOUNDARY
        close = (x - score[:, :, None]).abs() <= quantum + NEAR_BOUNDARY
        excused = (near & close & real).flatten(1).any(dim=1)
        if not bool(excused.all()):
            first = bad[lo:lo + chunk][~excused][0].tolist()
            raise AssertionError(f"keys differ at (query, slot) {first} away from a boundary")
    return len(bad)
