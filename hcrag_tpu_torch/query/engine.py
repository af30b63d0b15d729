"""QueryEngine — the batched query step and its host API in PyTorch.

Counterpart of `hcrag_tpu/query/engine.py` on its TPU (Pallas) route, in
its residency modes:

  * float, the default: the index's own f32 (or bf16) bank, selected
    exactly by kernel B4 with no rescore;
  * float + `exact_rescore=m` over an f32 index: a bf16 selection bank
    through kernel B5, the merge (kernel B2 for large pools), and an exact
    f32 rescore of the m candidates;
  * int8 (`quantize_int8=True`): an int8 selection bank through kernel B1
    (the exact per-tile top-k under the packed key) and the merge (B2 for
    large pools), then, with `int8_rescore=m`, an exact rescore of the m
    candidates from the f32 rows (`int8_f32_rescore`, over an f32 index:
    `bench.py`'s default), from a bf16 copy of the rows, or from the
    int8 + int8-residual reconstruction (`int8_residual`: 10M rows on one
    card).  `int8_only` keeps no float copy and, without the residual, no
    rescore: its selection is the k-pass packed branch of kernel B3, whose
    contract B1 computes at per-tile k = top_k.

With `pallas_super=s > 1` every rescored mode selects over supertiles
(kernel B7, then the merge) for batches of 64 queries or more: the float
path over 1024-row tiles grouped s at a time, the int8 path over 2048-row
tiles, at most 8192 rows to a supertile; the bank is padded to a whole
supertile at set-up, as the JAX engine pads it.

One call of the step runs, in order: the selection above; the relevance
metrics on the top-k rows (semantic, entity bitset popcount, intent x type
priority, weighted reduction); the ELL graph expansion to the requested
depth, its second and later hops over the ANNOTATION-only table
(`ops/expand.expand_batch_early_exit`); the scoring of the expanded nodes
and the 0.7/0.3 blend of relevance and similarity.  `retrieve_batch_device`
runs the selection alone; `query_text_batch_device` runs the step on a batch
of texts, encoded on the device by the attached encoder inside the step;
`find_similar_content`, `process_query` (with the encoder confidence),
`search_by_category`, `suggest_queries`, `query_similar_products` and
`hybrid_search` are the reference-shaped host API over the step.
`refresh_index` uploads the index again after `DenseIndex.append`;
`attach_device_encoder` makes text queries run the MiniLM encoder on the
engine's device.

Under a profiler, or inside `utils.timing.recording()`, the step records
its spans (`engine.step`, `engine.select`, `engine.rescore`,
`engine.metrics`, `engine.expand`, `engine.score_expanded`; for texts
`engine.tokenize` and `engine.encode` with the counters `encode.tokens` and
`encode.padded_tokens`, `models/minilm.py`) and the expansion's counters
(`utils/timing.py`).

The selections are the CUDA kernels of `ops/topk_cuda.py`.  Past 128
candidates (top_k or the rescore's oversample), which the kernels' per-tile
lists do not hold, the engine selects as the JAX engine does off the TPU:
the dense product and `masked_top_k`, streamed in row chunks past 2^18 rows
(`ops/similarity.py`, `ops/quantize.py`).  The rest is plain PyTorch on the
engine's device.  Its f32 dot products are elementwise products and sums,
and the route's products are taken in float64, so no TF32 /
`float32_matmul_precision` setting changes them (the JAX engine pins
`Precision.HIGHEST`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from hcrag_tpu_torch import config as cfg
from hcrag_tpu_torch.convert import _tensor
from hcrag_tpu_torch.core.dense_index import DenseIndex
from hcrag_tpu_torch.core.graph import CsrGraph
from hcrag_tpu_torch.core.types import (
    EXPANSION_EDGE_TYPES,
    NUM_INTENTS,
    NUM_NODE_TYPES,
    PRIORITY_MATRIX,
    REDUCE_MAX,
    REDUCE_WEIGHTED_SUM,
    EDGE_TYPES,
    CompositeWeights,
    QueryInput,
    QueryIntent,
    ScorerType,
    edge_type_id,
    node_type_id,
    scorer_spec,
)
from hcrag_tpu_torch.device import resolve_device
from hcrag_tpu_torch.ingest.entities import (
    extract_entities_from_content,
    infer_query_intent,
)
from hcrag_tpu_torch.models.confidence import encoder_confidence
from hcrag_tpu_torch.models.embedder import embedder_from_index
from hcrag_tpu_torch.models.reranker import engine_candidate_features
from hcrag_tpu_torch.ops.expand import expand_batch_early_exit
from hcrag_tpu_torch.ops.quantize import (
    quantize_bank,
    quantize_queries,
    quantized_scores,
    streaming_quantized_top_k,
)
from hcrag_tpu_torch.ops.scoring import combine_metrics_dynamic, popcount_words
from hcrag_tpu_torch.ops.similarity import (
    STREAMING_MIN_ROWS,
    candidate_dots,
    dots,
    masked_top_k,
    streaming_masked_top_k,
)
from hcrag_tpu_torch.ops.similarity import top_k as stable_top_k
from hcrag_tpu_torch.ops.topk_cuda import (
    MAX_SUPER_ROWS,
    MAX_TILE_K,
    NEG_INF,
    cosine_top_k,
    cosine_top_k_int8,
    resolve_super_tiles,
    super_pick_count,
    tile_pick_count,
    uses_packed_merge,
    uses_packed_super_merge,
)
from hcrag_tpu_torch.utils import timing

TILE_N = 2048  # index rows per tile: the packed key's lane field is 11 bits
SUPER_FLOAT_TILE_N = 1024  # the float path's tile under supertiles
SUPER_MIN_BATCH = 64  # smaller batches never take supertiles


def _super_pad_multiple(n_rows: int, tile: int) -> int:
    """The bank's row multiple under supertiles (`_super_pad_multiple`):
    spt * tile, spt the floor power of two of min(8192 / tile, tiles of
    the unpadded rows)."""
    spt = min(max(1, MAX_SUPER_ROWS // tile), max(1, -(-n_rows // tile)))
    return (1 << (spt.bit_length() - 1)) * tile


_GRAPH_LABEL_TO_TYPE = {
    "Product": "product",
    "Category": "category",
    "Document": "document",
    "Annotation": "annotation",
}


@dataclasses.dataclass
class QueryBatchResult:
    """Outputs of a query batch as host arrays (all [B, ...])."""

    NAMES = (
        "top_scores", "top_indices", "relevance", "combined",
        "expanded_nodes", "expanded_counts", "expanded_relevance",
    )

    top_scores: np.ndarray  # [B, k] cosine similarity
    top_indices: np.ndarray  # [B, k] index rows
    relevance: np.ndarray  # [B, k] relevance scores of retrieved rows
    combined: np.ndarray  # [B, k] 0.7*rel + 0.3*sim
    expanded_nodes: np.ndarray  # [B, max_expanded] graph node ids (-1 pad)
    expanded_counts: np.ndarray  # [B]
    expanded_relevance: np.ndarray  # [B, max_expanded]
    rerank_scores: Optional[np.ndarray] = None


class _TextBatch:
    """Texts whose queries the step takes from `encoder.encode_device`,
    called inside the step's span (`query_text_batch_device`); `emb` holds
    the embeddings once encoded."""

    __slots__ = ("encoder", "texts", "max_len", "emb")

    def __init__(self, encoder, texts: Sequence[str], max_len: int):
        self.encoder, self.texts, self.max_len = encoder, texts, max_len
        self.emb: Optional[torch.Tensor] = None


def exact_rescore(
    q_emb: torch.Tensor,
    v: torch.Tensor,
    i: torch.Tensor,
    rows_fn: Callable[[torch.Tensor], torch.Tensor],
    top_k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Re-rank the oversampled candidates (v, i) [B, m] by exact f32 dots
    with `rows_fn(i)` and keep top_k (stable ties).  Fillers (idx -1) and
    filtered rows (value -1e30) never win."""
    valid = (i >= 0) & (v > -1e29)
    rows = rows_fn(torch.where(valid, i, 0).to(torch.int64))
    exact = torch.where(valid, candidate_dots(q_emb, rows), -1e30)
    sv, sp = stable_top_k(exact, top_k)
    return sv, torch.gather(i, 1, sp)


class QueryEngine:
    """Single-device query engine over a DenseIndex (+ optional CsrGraph)."""

    def __init__(
        self,
        index: DenseIndex,
        graph: Optional[CsrGraph] = None,
        *,
        embedder=None,
        ell_max_degree: Optional[int] = None,
        device: Optional[Union[str, torch.device]] = None,
        quantize_int8: bool = False,
        int8_only: bool = False,
        int8_residual: bool = False,
        int8_rescore: int = 0,
        int8_f32_rescore: bool = False,
        exact_rescore: int = 0,
        pallas_super: int = 0,
        select_lane_t: int = 0,
        use_pallas: Optional[bool] = None,
        pallas_tile_n: int = TILE_N,
        pallas_interpret: Optional[bool] = None,
        bank_dtype: Optional[str] = None,
    ):
        if select_lane_t not in (0, 1):
            raise ValueError(
                "select_lane_t must be 0 or 1: the kernels select every tile "
                f"exactly, so no per-lane depth applies (got {select_lane_t})"
            )
        # The JAX engine's kernel switches, at the values the port runs:
        # its kernels always run (there is no route without them, so
        # `use_pallas=False` has nothing to select) over 2048-row tiles;
        # `pallas_interpret` has no counterpart (a CPU tensor runs the plain
        # versions) and is ignored.
        if use_pallas not in (None, True):
            raise ValueError(
                "use_pallas must be None or True: the port's kernels always "
                f"run, there is no route without them (got {use_pallas!r})"
            )
        if pallas_tile_n != TILE_N:
            raise ValueError(
                f"pallas_tile_n must be {TILE_N}: the kernels' tile is fixed at "
                f"{TILE_N} rows (got {pallas_tile_n})"
            )
        if bank_dtype not in (None, "bfloat16"):
            raise ValueError(f"bank_dtype must be None or 'bfloat16', got {bank_dtype!r}")
        host_dtype = np.asarray(index.emb).dtype
        if not quantize_int8 and host_dtype != np.float32 and host_dtype.name != "bfloat16":
            raise ValueError(
                f"float residency needs a float32 or bfloat16 index, got {host_dtype}"
            )
        #: "bfloat16": the float bank is the f32 rows rounded to bf16 on the
        #: device, the residency of the JAX engine over a bfloat16 host
        #: index (no f32 rows, so no rescore), built without a host bf16
        #: type.
        self.bank_dtype = None if quantize_int8 else bank_dtype
        self.device = resolve_device(device)
        self.index = index
        self.graph = graph
        self._embedder = embedder
        self.reranker = None  # the final ranking stage of rerank=True (set_reranker)
        # The JAX engine's flag rules: the residual implies int8-only
        # residency; int8-only without it has no rescore source; the f32
        # rescore needs the float copy (and is dropped below for a non-f32
        # index).
        self.quantize_int8 = bool(quantize_int8)
        self.int8_residual = bool(int8_residual) and self.quantize_int8
        self.int8_only = bool(int8_only) or self.int8_residual
        self.int8_rescore = (
            max(0, int(int8_rescore))
            if self.quantize_int8 and (not self.int8_only or self.int8_residual)
            else 0
        )
        self.int8_f32_rescore = (
            bool(int8_f32_rescore) and self.quantize_int8 and not self.int8_only
        )
        #: Float path: the oversample rescored from an f32 bank (0 = off;
        #: dropped to 0 below when the host index is not f32).
        self.exact_rescore = 0 if quantize_int8 else max(0, int(exact_rescore))
        #: Supertile factor of the rescored (packed) selections; <= 1 is off.
        self.pallas_super = int(pallas_super)

        put = self._put
        self._upload_index()
        self.d_priority = put(PRIORITY_MATRIX)

        if graph is not None:
            if graph.edge_type_vocab is None:
                ell = graph.to_ell(EXPANSION_EDGE_TYPES, max_degree=ell_max_degree)
                self.d_neighbors = put(ell.neighbors)
                # Hops after the first follow ANNOTATION edges only: the
                # reference's depth-2 path is Product -> Document ->
                # Annotation.
                self.d_neighbors_hop2 = put(
                    graph.to_ell(("ANNOTATION",), max_degree=ell_max_degree).neighbors
                )
            else:
                # A discovered-vocabulary graph has no such schema: every
                # hop follows all relations, over the same table.
                ell = graph.to_ell(max_degree=ell_max_degree)
                self.d_neighbors = self.d_neighbors_hop2 = put(ell.neighbors)
            g_types = np.array(
                [
                    node_type_id(_GRAPH_LABEL_TO_TYPE.get(lbl, "unknown"))
                    for lbl in graph.node_labels
                ],
                dtype=np.int32,
            )
            self.d_g_type_ids = put(g_types)
            self.d_g_row = put(graph.node_to_row.astype(np.int32))
        else:
            self.d_neighbors = self.d_neighbors_hop2 = None
            self.d_g_type_ids = None
            self.d_g_row = None

    @property
    def embedder(self):
        """The query-text embedder: the one given or attached, else the
        index's own (`embedder_from_index` on the engine's device, resolved
        at first use)."""
        if self._embedder is None:
            self._embedder = embedder_from_index(self.index, device=self.device)
        return self._embedder

    def _upload_index(self) -> None:
        """The index on the device: the banks, padded to the row count's
        multiple (`_row_pad_multiple`), and the per-row tensors."""
        index, put = self.index, self._put
        self._n_rows = np.asarray(index.emb).shape[0]
        mult = self._row_pad_multiple()
        self._n_bank = -(-self._n_rows // mult) * mult
        self._init_emb_banks(np.asarray(index.emb), self._n_bank)
        self.d_type_ids = put(index.type_ids.astype(np.int32))
        self.d_bits = put(np.ascontiguousarray(index.entity_bits).view(np.int32))
        self.d_counts = put(index.entity_counts.astype(np.int32))
        self.d_graph_ids = put(index.graph_ids.astype(np.int32))

    def refresh_index(self) -> None:
        """Upload the index again after `DenseIndex.append` (or another
        change to its host arrays): the banks at the new row count's
        padding, the int8 banks quantized on the device as at set-up, and
        the per-row tensors.  The step is built at every call, so nothing
        else keeps the old shapes.  The old banks are released first
        (`_init_emb_banks` drops the others before it builds)."""
        self.d_emb = None
        self._upload_index()

    def attach_device_encoder(self, minilm_embedder) -> None:
        """Encode text queries with this embedder (`models/minilm.py`'s
        `MiniLMEmbedder`, on the engine's device): `query_text_batch_device`,
        and through it `process_query`, `search_by_category` and
        `hybrid_search`, then tokenize on the host and run the encoder's
        forward pass on the card inside the step; `create_query_input`
        takes its vector from the same forward."""
        self._embedder = minilm_embedder

    # ------------------------------------------------------------------
    # Banks
    # ------------------------------------------------------------------
    def _put(self, a: np.ndarray) -> torch.Tensor:
        return _tensor(a).to(self.device)

    def _put_operand(self, a: np.ndarray) -> torch.Tensor:
        """A per-call operand (queries, bitsets, weights) on the device
        (the JAX engine's `_put_query_input`) without waiting for it: on
        CUDA the host array is staged in pinned memory and copied on the
        current stream after the work already queued there (a copy from
        pageable memory would first wait for that work, which serializes
        the dispatches of a serving loop).  The pinned block is reused
        only after the copy (PyTorch's caching host allocator records it on
        the stream)."""
        t = _tensor(a)
        if self.device.type != "cuda":
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def _row_pad_multiple(self) -> int:
        """The bank's row multiple (`_row_pad_multiple`): one 2048-row
        tile, or with supertiles on a rescored mode the widest supertile
        the selection can resolve (decided before a non-f32 index drops
        `exact_rescore`, as in the JAX engine)."""
        if self.pallas_super > 1 and self._rescore_m() > 0:
            return _super_pad_multiple(self._n_rows, TILE_N)
        return TILE_N

    def _put_rows(self, a: np.ndarray, n_bank: int) -> torch.Tensor:
        """Host rows [N, D] on the device, padded with zero rows to
        `n_bank` rows; pad rows are masked out of every selection."""
        t = self._put(a)
        pad = n_bank - t.shape[0]
        return torch.nn.functional.pad(t, (0, 0, 0, pad)) if pad else t

    def _init_emb_banks(self, emb_host: np.ndarray, n_bank: int) -> None:
        """The selection bank, the bank expanded-node scoring gathers from
        (`d_emb`; none in int8-only residency, whose rows are dequantized
        from the int8 banks), and the mode's rescore bank, each of the
        rows `emb_host` padded to `n_bank` rows."""
        put = lambda a: self._put_rows(a, n_bank)  # noqa: E731
        self.d_emb_int8 = self.d_emb_scale = None
        self.d_emb_res8 = self.d_emb_res_scale = None
        self.d_emb_f32 = None
        if not self.quantize_int8:
            if self.bank_dtype == "bfloat16":
                self.exact_rescore = 0  # no f32 rows to rescore from
                self.d_emb = put(emb_host).to(torch.bfloat16)
            elif self.exact_rescore and emb_host.dtype == np.float32:
                # bf16 rows for selection; the exact f32 rows of only the
                # merged candidates are rescored.
                self.d_emb_f32 = put(emb_host)
                self.d_emb = self.d_emb_f32.to(torch.bfloat16)
            else:
                self.exact_rescore = 0  # needs an f32 source to rescore
                self.d_emb = put(emb_host)
            return
        # Quantized on the device, chunk by chunk: no host copy of the
        # int8 banks, and the pad rows come out as zero rows.
        banks = quantize_bank(
            emb_host, self.device, n_bank, residual=self.int8_residual
        )
        self.d_emb_int8, self.d_emb_scale = banks[:2]
        if self.int8_residual:
            self.d_emb_res8, self.d_emb_res_scale = banks[2:]
        if emb_host.dtype != np.float32:
            self.int8_f32_rescore = False  # needs an f32 source
        if self.int8_only:
            self.d_emb = None
        elif self.int8_f32_rescore:
            self.d_emb_f32 = put(emb_host)
            self.d_emb = self.d_emb_f32.to(torch.bfloat16)
        else:
            self.d_emb = put(emb_host).to(torch.bfloat16)

    def _bank(self) -> Dict[str, torch.Tensor]:
        """The device tensors of the index and graph, under the keys of the
        JAX engine's `_bank()` (see `convert.bank_from_numpy`)."""
        bank = {
            "type_ids": self.d_type_ids,
            "bits": self.d_bits,
            "counts": self.d_counts,
            "graph_ids": self.d_graph_ids,
        }
        if self.d_emb is not None:
            bank["emb"] = self.d_emb
        if self.d_emb_f32 is not None:
            bank["emb_f32"] = self.d_emb_f32
        if self.quantize_int8:
            bank["emb_int8"] = self.d_emb_int8
            bank["emb_scale"] = self.d_emb_scale
        if self.d_emb_res8 is not None:
            bank["emb_res8"] = self.d_emb_res8
            bank["emb_res_scale"] = self.d_emb_res_scale
        if self.d_neighbors is not None:
            bank["neighbors"] = self.d_neighbors
            bank["neighbors_hop2"] = self.d_neighbors_hop2
            bank["g_type_ids"] = self.d_g_type_ids
            bank["g_row"] = self.d_g_row
        return bank

    def _gather_emb_rows(self, indices: torch.Tensor, bank) -> torch.Tensor:
        """Embedding rows at arbitrary indices ([..., D]): the `emb` bank's,
        or, in int8-only residency, the dequantized q8 * s (+ r8 * rs with
        the residual bank) in f32."""
        if "emb" in bank:
            return bank["emb"][indices]
        rows = (
            bank["emb_int8"][indices].to(torch.float32)
            * bank["emb_scale"][indices][..., None]
        )
        if "emb_res8" in bank:
            rows = rows + (
                bank["emb_res8"][indices].to(torch.float32)
                * bank["emb_res_scale"][indices][..., None]
            )
        return rows

    # ------------------------------------------------------------------
    # Selection
    # ------------------------------------------------------------------
    def _select_plan(self, batch: int, n_bank: int) -> Tuple[int, int]:
        """(tile rows, supertile factor) of a selection over `batch`
        queries and a bank of `n_bank` rows (one shard's block in the
        sharded engine), as the JAX engine's `_local_select` resolves them:
        with a rescore, `pallas_super > 1` and at least 64 queries, the
        float path drops to 1024-row tiles and both paths group tiles into
        supertiles (`resolve_super_tiles` against the padded bank's tile
        count, as the kernel clamps); otherwise 2048-row tiles, no
        supertiles."""
        if not (self._rescore_m() > 0 and self.pallas_super > 1
                and batch >= SUPER_MIN_BATCH):
            return TILE_N, 1
        tile = TILE_N if self.quantize_int8 else SUPER_FLOAT_TILE_N
        return tile, resolve_super_tiles(self.pallas_super, tile, -(-n_bank // tile))

    def _local_select(self, q_emb, bank, type_mask, top_k: int, fetch_k: int):
        """The mode's selection over the bank: (values [B, m], row indices
        [B, m]) with m = max(top_k, fetch_k) candidates; no rescore here.
        Where the per-tile kernels cannot hold m (`_dense_route`), the JAX
        engine's route off the TPU (`_dense_select`).  Otherwise an int8
        bank takes the packed selection in every mode: with a rescore it
        stands for the JAX engine's fused two-level branch (whose exact
        contract it computes), without one for the k-pass branch; the calls
        differ only in merge_k, hence in the per-tile pick count and the
        merge's out_k.  `_select_plan` gives the tile and the supertiles.

        Every shape is read from the tensors handed in, so the same method
        selects over one shard's block of the sharded engine (its local row
        indices; its pad rows masked in `type_mask`), as the JAX engine's
        `_local_select` runs unchanged inside `shard_map`."""
        m = max(top_k, fetch_k)
        sel = bank["emb_int8"] if self.quantize_int8 else bank["emb"]
        if self._dense_route(m, sel.shape[0]):
            return self._dense_select(q_emb, bank, type_mask, m)
        merge_k = m if m > top_k else 0
        pad = sel.shape[0] - type_mask.shape[0]
        if pad:
            type_mask = torch.cat(
                [type_mask, torch.zeros(pad, dtype=torch.bool, device=type_mask.device)]
            )
        tile, spt = self._select_plan(q_emb.shape[0], sel.shape[0])
        if self.quantize_int8:
            return cosine_top_k_int8(
                q_emb, sel, bank["emb_scale"], type_mask, top_k,
                tile_n=tile, merge_k=merge_k, super_tiles=spt,
            )
        return cosine_top_k(
            q_emb, sel, type_mask, top_k, tile_n=tile, merge_k=merge_k,
            packed_select=self.exact_rescore > 0, super_tiles=spt,
        )

    def _dense_route(self, m: int, n_bank: int) -> bool:
        """Whether a selection of m candidates leaves the kernels: m, capped
        at the bank's `n_bank` rows, above the 128 a per-tile list holds."""
        return min(m, n_bank) > MAX_TILE_K

    def _dense_select(self, q_emb, bank, type_mask, m: int):
        """The JAX engine's selection off the TPU (`engine.py:619-639`),
        over the rows `type_mask` covers (the unpadded rows; in the sharded
        engine one shard's block, whose pad rows the mask leaves out): a
        float bank takes its dots and `masked_top_k`, an int8 bank
        `quantized_scores` and `masked_top_k`; past 2^18 rows the streaming
        variants.  Filtered rows come back at -inf with their own indices,
        as there; slots past the rows are (-1e30, -1) fillers."""
        mask = type_mask
        n = mask.shape[0]
        if self.quantize_int8:
            e8, es = bank["emb_int8"][:n], bank["emb_scale"][:n]
            if n > STREAMING_MIN_ROWS:
                v, i = streaming_quantized_top_k(q_emb, e8, es, mask, m)
            else:
                qi, qs = quantize_queries(q_emb.to(torch.float32))
                v, i = masked_top_k(quantized_scores(qi, qs, e8, es), mask, m)
        else:
            emb = bank["emb"][:n]
            if n > STREAMING_MIN_ROWS:
                v, i = streaming_masked_top_k(q_emb, emb, mask, m)
            else:
                v, i = masked_top_k(dots(q_emb.to(emb.dtype), emb), mask, m)
        short = m - v.shape[1]
        if short > 0:
            v = torch.nn.functional.pad(v, (0, short), value=NEG_INF)
            i = torch.nn.functional.pad(i, (0, short), value=-1)
        return v, i

    def _rescore_m(self) -> int:
        """Oversample of the exact rescore (0 = off)."""
        return self.int8_rescore if self.quantize_int8 else self.exact_rescore

    def _topk_impl(self, q_emb, type_mask, top_k: int, bank):
        """Selection of the top_k (or, with a rescore, of the m best
        candidates, then their exact f32 rescore down to top_k).  The
        rescore reads the f32 bank where there is one, else the rows
        `_gather_emb_rows` gives (the bf16 copy, or the int8 + residual
        reconstruction)."""
        m = self._rescore_m()
        with timing.span("engine.select"):
            v, i = self._local_select(q_emb, bank, type_mask, top_k, max(top_k, m))
        if not m:
            return v, i
        if "emb_f32" in bank:
            rows_fn = lambda ix: bank["emb_f32"][ix]  # noqa: E731
        else:
            rows_fn = lambda ix: self._gather_emb_rows(ix, bank)  # noqa: E731
        with timing.span("engine.rescore"):
            return exact_rescore(q_emb, v, i, rows_fn, top_k)

    def resolved_kernel_config(self, batch: int, top_k: int = 10) -> Dict:
        """The selection strategy a `query_batch` of this shape runs.
        `tile_k` is the per-tile (with supertiles: per-supertile) pick count
        the kernel is launched with, after the small-pool raise of the
        packed selections; `super_tiles` is the factor the kernel runs,
        clamped against the padded bank (the JAX engine's report clamps
        against the unpadded rows and can differ on small indexes); `lane_t`
        is 0 and `two_level` False because every tile is selected
        exactly.  Past 128 candidates `kernel` names the function of the
        route without a kernel (`_dense_select`), with no tile and no
        merge."""
        m = self._rescore_m()
        merge_k = m if m > top_k else 0
        packed = self.quantize_int8 or self.exact_rescore > 0
        sel = self.d_emb_int8 if self.quantize_int8 else self.d_emb
        n_bank = int(sel.shape[0])  # in the sharded engine, one shard's block
        tile, spt = self._select_plan(batch, n_bank)
        tiles = -(-n_bank // tile)
        plain = "" if self.device.type == "cuda" else "_plain"
        if self._dense_route(max(top_k, m), n_bank):
            streaming = min(self._n_rows, n_bank) > STREAMING_MIN_ROWS
            if self.quantize_int8:
                kernel = ("streaming_quantized_top_k" if streaming
                          else "quantized_scores+masked_top_k")
            else:
                kernel = "streaming_masked_top_k" if streaming else "masked_top_k"
            merge, packed, tile, tile_k, spt = "none", False, 0, 0, 1
        else:
            if spt > 1:
                lbits = spt * tile
                tile_k = super_pick_count(top_k, n_bank, lbits, merge_k)
                num_super = -(-n_bank // lbits)
                out_k = min(max(min(top_k, n_bank), merge_k), num_super * tile_k)
                packed_merge = uses_packed_super_merge(num_super, tile_k, out_k)
            elif packed:
                tile_k = tile_pick_count(top_k, n_bank, tile, merge_k)
                packed_merge = uses_packed_merge(tiles, tile_k, merge_k)
            else:
                tile_k, packed_merge = min(top_k, n_bank), False
            kernel = (
                ("int8_super_tile_topk" if spt > 1 else "int8_tile_topk")
                if self.quantize_int8
                else "float_packed_super_tile_topk" if spt > 1
                else "float_packed_tile_topk" if packed
                else "float_tile_topk"
            ) + plain
            merge = "packed_candidate_merge" + plain if packed_merge else "stable_sort"
        return {
            "quantize_int8": self.quantize_int8,
            "int8_only": self.int8_only,
            "int8_residual": self.int8_residual,
            "rescore_oversample": m,
            "merge_k": merge_k,
            "kernel": kernel,
            "merge": merge,
            "packed_select": packed,
            "two_level": False,
            "tile_n": tile,
            "tile_k": tile_k,
            "sub_batch": batch,
            "super_tiles": spt,
            "lane_t": 0,
            "select_bank": (
                "int8" if self.quantize_int8
                else str(sel.dtype).removeprefix("torch.")
            ),
            "rescore_bank": self._rescore_bank(),
            "device": str(self.device),
        }

    def _rescore_bank(self) -> str:
        """The JAX engine's label of the rescore source: for an int8 bank
        "int8_residual", "" (int8-only), "f32" or "bf16" (the latter also
        when `int8_rescore` is 0 and nothing is rescored); for a float bank
        "f32" or ""."""
        if not self.quantize_int8:
            return "f32" if self.exact_rescore else ""
        if self.int8_residual:
            return "int8_residual"
        if self.int8_only:
            return ""
        return "f32" if self.int8_f32_rescore else "bf16"

    # ------------------------------------------------------------------
    # The step
    # ------------------------------------------------------------------
    def _gather_graph(self, table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """Rows of a graph-side table (the ELL tables, per-node type ids,
        node -> row links) at batched node ids; the sharded engine gathers
        across ranks when it splits these tables (`shard_graph`)."""
        return table[idx]

    def _expand_impl(self, bank, seeds, depth: int, max_expanded: int):
        """The batched k-hop expansion of the seeds [B, k] over the ELL
        bank, with the batch-level early exit
        (`ops/expand.expand_batch_early_exit`); the sharded engine's split
        graph tables take its own."""
        return expand_batch_early_exit(
            bank["neighbors"], seeds, depth=depth, max_nodes=max_expanded,
            hop2_neighbors=bank["neighbors_hop2"],
        )

    def _build_step(self, top_k: int, depth: int, max_expanded: int, reduction: int):
        has_graph = self.d_neighbors is not None
        priority = self.d_priority

        def metrics_reduce(sem, llm, ent, typ, weights, intent_ids, tids):
            metrics = torch.stack([sem, llm, ent, typ], dim=-1)
            if reduction == REDUCE_MAX:
                return metrics.amax(dim=-1)
            if weights.ndim == 3:
                # Dynamic per-(intent, node-type) weights [4, I, T].
                return combine_metrics_dynamic(
                    metrics, weights, intent_ids[:, None], tids
                )
            return (metrics * weights).sum(dim=-1)

        def entity_match(q_bits, q_count, bits, counts):
            inter = popcount_words(q_bits[:, None, :] & bits)  # [B, k]
            ratio = inter.to(torch.float32) / torch.clamp(
                q_count[:, None].to(torch.float32), min=1.0
            )
            return torch.where(
                (q_count == 0)[:, None],
                torch.where(counts == 0, 0.5, 0.1),
                ratio,
            )

        def step(q_emb, q_bits, q_oov, intent_ids, weights, type_mask,
                 llm_topk, bank):
            # q_emb [B, D] normalized, q_bits [B, W] int32 words, q_oov [B],
            # intent_ids [B], weights [4] or [4, I, T], type_mask [N] bool,
            # llm_topk [B, k] host LLM-judge column (zeros if absent).
            type_ids = bank["type_ids"]
            bits = bank["bits"]
            counts = bank["counts"]
            top_v, top_i = self._topk_impl(q_emb, type_mask, top_k, bank)

            # --- relevance metrics on retrieved rows --------------------
            # A filler index (-1) reads the last row, as the JAX step's
            # gather does (negative indices wrap there).
            with timing.span("engine.metrics"):
                n = type_ids.shape[0]
                gi = top_i.to(torch.int64)
                gi = torch.where(gi < 0, gi + n, gi)
                sem = (top_v + 1.0) * 0.5
                q_count = popcount_words(q_bits) + q_oov  # [B]
                ent = entity_match(q_bits, q_count, bits[gi], counts[gi])
                row_tids = type_ids[gi]
                typ = priority[intent_ids[:, None], row_tids]
                rel = metrics_reduce(
                    sem, llm_topk, ent, typ, weights, intent_ids, row_tids
                )
                combined = (
                    cfg.COMBINED_RELEVANCE_WEIGHT * rel
                    + cfg.COMBINED_SIMILARITY_WEIGHT * top_v
                )

            b = q_emb.shape[0]
            if not has_graph:
                return (
                    top_v, top_i, rel, combined,
                    torch.full((b, max_expanded), -1, dtype=torch.int32,
                               device=q_emb.device),
                    torch.zeros((b,), dtype=torch.int32, device=q_emb.device),
                    torch.zeros((b, max_expanded), device=q_emb.device),
                )

            # --- expansion -----------------------------------------------
            with timing.span("engine.expand"):
                seeds = torch.where(top_v >= -1.0, bank["graph_ids"][gi], -1)
                expanded, exp_count = self._expand_impl(bank, seeds, depth, max_expanded)

            # --- expanded-node scoring -----------------------------------
            with timing.span("engine.score_expanded"):
                valid = expanded >= 0
                safe_nodes = torch.where(valid, expanded, 0).to(torch.int64)
                rows = self._gather_graph(bank["g_row"], safe_nodes)  # [B, E]; -1 = none
                has_row = rows >= 0
                safe_rows = torch.where(has_row, rows, 0).to(torch.int64)
                e_emb = (
                    self._gather_emb_rows(safe_rows, bank).to(torch.float32)
                    * has_row[..., None]
                )
                sem_e = (
                    (e_emb * q_emb.to(torch.float32)[:, None, :]).sum(dim=-1) + 1.0
                ) * 0.5
                e_bits = torch.where(has_row[..., None], bits[safe_rows], 0)
                e_counts = torch.where(has_row, counts[safe_rows], 0)
                ent_e = entity_match(q_bits, q_count, e_bits, e_counts)
                e_tids = self._gather_graph(bank["g_type_ids"], safe_nodes)
                typ_e = priority[intent_ids[:, None], e_tids]
                rel_e = metrics_reduce(
                    sem_e, torch.zeros_like(sem_e), ent_e, typ_e, weights,
                    intent_ids, e_tids,
                )
                rel_e = torch.where(valid, rel_e, 0.0)
            return top_v, top_i, rel, combined, expanded, exp_count, rel_e

        return step

    # ------------------------------------------------------------------
    # Batched API
    # ------------------------------------------------------------------
    def _query_tensor(self, query_embs) -> torch.Tensor:
        """[B, D] f32 queries on the device: a 2-D tensor is taken as
        already normalized, as are a `_TextBatch`'s embeddings (unit
        length), encoded here; anything else is L2-normalized on the
        host."""
        if isinstance(query_embs, torch.Tensor) and query_embs.ndim == 2:
            return query_embs.to(device=self.device, dtype=torch.float32)
        if isinstance(query_embs, _TextBatch):
            query_embs.emb = query_embs.encoder.encode_device(
                query_embs.texts, query_embs.max_len)
            return query_embs.emb.to(device=self.device, dtype=torch.float32)
        qh = np.asarray(query_embs, dtype=np.float32)
        if qh.ndim == 1:
            qh = qh[None, :]
        qh = qh / np.maximum(np.linalg.norm(qh, axis=1, keepdims=True), 1e-12)
        return self._put_operand(qh)

    def _type_mask(self, category_filter: Optional[str]) -> torch.Tensor:
        """The row filter [N] bool, sized to the unpadded rows: the bank's
        pad rows stay masked."""
        if category_filter:
            return self._put_operand(self.index.type_mask(category_filter))
        return torch.ones((self._n_rows,), dtype=torch.bool, device=self.device)

    def retrieve_batch_device(
        self,
        query_embs,
        *,
        top_k: int = cfg.DEFAULT_TOP_K,
        category_filter: Optional[str] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Retrieval only: the selection (and the mode's rescore) without
        metrics or expansion.  Returns (scores [B, k], indices [B, k]) on
        the engine's device, without waiting for the device."""
        return self._topk_impl(
            self._query_tensor(query_embs), self._type_mask(category_filter),
            top_k, self._bank(),
        )

    def query_batch_device(
        self,
        query_embs,
        *,
        top_k: int = cfg.DEFAULT_TOP_K,
        intents: Optional[Sequence[QueryIntent]] = None,
        entity_lists: Optional[Sequence[Sequence[str]]] = None,
        scorer_type: ScorerType = ScorerType.COMPOSITE,
        weights: Optional[CompositeWeights] = None,
        expansion_depth: int = cfg.EXPANSION_DEPTH,
        max_expanded: int = cfg.MAX_CONNECTED_NODES,
        category_filter: Optional[str] = None,
        llm_scores: Optional[np.ndarray] = None,
        dynamic_weight_tensor: Optional[np.ndarray] = None,
    ) -> Tuple[torch.Tensor, ...]:
        """Run the step and return its outputs as tensors on the engine's
        device, without waiting for the device.

        A 2-D tensor `query_embs` is taken as already normalized; anything
        else is L2-normalized on the host.  `dynamic_weight_tensor`
        ([4, NUM_INTENTS, NUM_NODE_TYPES]) switches the reduction to
        per-(intent, node-type) weights."""
        with timing.span("engine.step") as span:
            dev = self.device
            q = self._query_tensor(query_embs)
            b = q.shape[0]
            if span is not None:
                span.attrs.update(batch=b, top_k=top_k, depth=expansion_depth,
                                  max_expanded=max_expanded)

            if intents is None:
                intent_ids = torch.zeros((b,), dtype=torch.int64, device=dev)
            else:
                intent_ids = self._put_operand(np.array([i.index for i in intents], dtype=np.int64))

            vocab = self.index.vocab
            qb = np.zeros((b, vocab.num_words), dtype=np.uint32)
            qo = np.zeros(b, dtype=np.int32)
            for i, ents in enumerate(entity_lists or ()):
                qb[i], qo[i] = vocab.encode(ents)
            q_bits, q_oov = self._put_operand(qb.view(np.int32)), self._put_operand(qo)
            type_mask = self._type_mask(category_filter)

            w, reduction = scorer_spec(scorer_type, weights)
            if dynamic_weight_tensor is not None:
                w = np.asarray(dynamic_weight_tensor, dtype=np.float32)
                if w.shape != (4, NUM_INTENTS, NUM_NODE_TYPES):
                    raise ValueError(
                        "dynamic_weight_tensor must be [4 metrics, "
                        f"{NUM_INTENTS} intents, {NUM_NODE_TYPES} node types], "
                        f"got {w.shape}"
                    )
                reduction = REDUCE_WEIGHTED_SUM
            if llm_scores is None:
                llm_topk = torch.zeros((b, top_k), dtype=torch.float32, device=dev)
            else:
                llm_topk = self._put_operand(np.asarray(llm_scores, dtype=np.float32))

            step = self._build_step(top_k, expansion_depth, max_expanded, reduction)
            return step(
                q, q_bits, q_oov, intent_ids, self._put_operand(w), type_mask, llm_topk,
                self._bank(),
            )

    def query_text_batch_device(
        self, texts: Sequence[str], *, max_len: int = 0, **kwargs
    ) -> Tuple[torch.Tensor, ...]:
        """The step of `query_batch_device` (the same keyword arguments) on
        a batch of texts, encoded by the attached device encoder
        (`attach_device_encoder`: a `MiniLMEmbedder`) inside the step:
        tokenized on the host, the ids uploaded and the forward issued
        without waiting, its unit embeddings taken as the queries with no
        host round trip.  `max_len` caps the padded length (0: the
        tokenizer's own).  Returns the step's seven outputs and then the
        query embeddings [B, D] f32, on the device, without waiting for
        it."""
        encoder = self.embedder
        if not hasattr(encoder, "encode_device"):
            raise TypeError(
                f"query_text_batch_device needs a device encoder (a MiniLMEmbedder, "
                f"attach_device_encoder); the engine's embedder is a "
                f"{type(encoder).__name__}"
            )
        batch = _TextBatch(encoder, texts, max_len)
        out = self.query_batch_device(batch, **kwargs)
        return (*out, batch.emb)

    def _text_query(self, text: str, **kwargs) -> Tuple[QueryBatchResult, np.ndarray]:
        """One text's step on the host and its embedding [D]: through
        `query_text_batch_device` where the embedder encodes on the device,
        else the embedder's host vector through `query_batch`."""
        if hasattr(self.embedder, "encode_device"):
            *out, emb = self.query_text_batch_device([text], **kwargs)
            return self._host_result(out), emb[0].cpu().numpy()
        emb = np.asarray(self.embedder.encode([text])[0])
        return self.query_batch(emb, **kwargs), emb

    @staticmethod
    def _host_result(out) -> QueryBatchResult:
        """The step's outputs copied to host arrays."""
        return QueryBatchResult(
            **{n: v.cpu().numpy() for n, v in zip(QueryBatchResult.NAMES, out)}
        )

    def query_batch(
        self, query_embs, *, rerank: bool = False, **kwargs
    ) -> QueryBatchResult:
        """`query_batch_device`, with the outputs copied to host arrays.
        `rerank=True` reorders each query's top-k by the attached re-ranker
        (`set_reranker`) as a last host stage."""
        res = self._host_result(self.query_batch_device(query_embs, **kwargs))
        if rerank:
            res = self.rerank_result(
                res,
                intents=kwargs.get("intents"),
                entity_lists=kwargs.get("entity_lists"),
            )
        return res

    # ------------------------------------------------------------------
    # Learned re-ranking (models/reranker.py)
    # ------------------------------------------------------------------
    def set_reranker(self, reranker) -> None:
        """Attach a trained `models.reranker.Reranker` as the final ranking
        stage of `query_batch(..., rerank=True)`: an MLP over the judge-free
        metrics, distilled from the judge-inclusive blend, so the order
        approaches that blend's with no LLM call at query time."""
        self.reranker = reranker

    def rerank_result(
        self, res: QueryBatchResult, intents=None, entity_lists=None
    ) -> QueryBatchResult:
        """A result's top-k reordered by the re-ranker's scores (stable:
        ties keep their order); invalid slots (index -1 or a filler score)
        score -inf and stay last.  Without a re-ranker, `res` as it is."""
        if self.reranker is None:
            return res
        with timing.span("engine.rerank"):
            feats = engine_candidate_features(
                self, res, intents=intents, entity_lists=entity_lists
            )
            scores = self.reranker.score(feats)  # [B, k]
            invalid = (res.top_indices < 0) | (res.top_scores <= -1e29)
            scores = np.where(invalid, -np.inf, scores)
            order = np.argsort(-scores, axis=1, kind="stable")
            take = lambda a: np.take_along_axis(a, order, axis=1)  # noqa: E731
            return dataclasses.replace(
                res,
                top_scores=take(res.top_scores),
                top_indices=take(res.top_indices),
                relevance=take(res.relevance),
                combined=take(res.combined),
                rerank_scores=take(scores),
            )

    # ------------------------------------------------------------------
    # Reference-shaped host API
    # ------------------------------------------------------------------
    def find_similar_content(
        self,
        query_embedding: np.ndarray,
        top_k: int = cfg.DEFAULT_TOP_K,
        similarity_threshold: float = cfg.DEFAULT_SIMILARITY_THRESHOLD,
    ) -> List[Dict]:
        """The top_k rows of one query embedding with cosine at or above
        the threshold, as {content, metadata, similarity_score} dicts."""
        return self._similar_rows(
            self.query_batch(query_embedding, top_k=top_k), similarity_threshold)

    def _similar_rows(self, res: QueryBatchResult, similarity_threshold: float) -> List[Dict]:
        """`find_similar_content`'s dicts of the first query of `res`."""
        results = []
        for score, idx in zip(res.top_scores[0], res.top_indices[0]):
            if score >= similarity_threshold:
                results.append(
                    {
                        "content": self.index.texts[int(idx)],
                        "metadata": self.index.metadata[int(idx)],
                        "similarity_score": float(score),
                    }
                )
        return results

    def process_query(
        self,
        query: str,
        top_k: int = cfg.DEFAULT_TOP_K,
        similarity_threshold: float = cfg.DEFAULT_SIMILARITY_THRESHOLD,
        parser=None,
        with_confidence: Optional[bool] = None,
    ) -> Dict:
        """One text query end to end: parse -> embed -> retrieve ->
        summarize.  `parser` optionally supplies an LLM query parser (its
        `parse_query`); without one, or when it fails, the raw query is the
        search text.  `with_confidence` adds `encoder_confidence`
        (`models/confidence.encoder_confidence`: the calibrated chance that
        the distilled encoder serves this query as the true model would);
        by default it is on for a trainable encoder (one with
        `load_params`) over at most 100,000 rows, whose host feature pass
        stays cheap."""
        parsed = {"search_text": query}
        if parser is not None:
            try:
                parsed = parser.parse_query(query)
            except Exception:
                parsed = {"search_text": query}
        search_text = parsed.get("search_text", query)
        res, query_embedding = self._text_query(search_text, top_k=top_k)
        results = self._similar_rows(res, similarity_threshold)
        avg = (
            float(np.mean([r["similarity_score"] for r in results]))
            if results
            else 0.0
        )
        out = {
            "parsed_query": parsed,
            "search_text": search_text,
            "results": results,
            "summary": (
                f"Found {len(results)} results with average similarity: {avg:.3f}"
            ),
            "query_embedding": query_embedding,
        }
        want_conf = with_confidence
        if want_conf is None:
            want_conf = (
                hasattr(self.embedder, "load_params") and self.index.n <= 100_000
            )
        if want_conf:
            bank = np.asarray(self.index.emb, np.float32)
            bank_norm = bank / np.maximum(
                np.linalg.norm(bank, axis=1, keepdims=True), 1e-12
            )
            out["encoder_confidence"] = encoder_confidence(
                self.embedder, bank_norm, search_text,
                query_emb=query_embedding[None, :],
            )
        return out

    def search_by_category(
        self,
        query: str,
        category_filter: Optional[str] = None,
        top_k: int = cfg.DEFAULT_TOP_K,
    ) -> Dict:
        """Type-masked search: no threshold, ranked dicts of the rows that
        match the filter."""
        if category_filter and not self.index.type_mask(category_filter).any():
            return {"results": [], "summary": "No items match the filter criteria"}
        res, _ = self._text_query(query, top_k=top_k, category_filter=category_filter)
        # Filtered rows come back at -1e30 and packed fillers with index -1:
        # keep only true matches, ranked over the returned list.
        mask = (
            np.asarray(self.index.type_mask(category_filter))
            if category_filter
            else None
        )
        results = []
        for score, idx in zip(res.top_scores[0], res.top_indices[0]):
            idx = int(idx)
            if idx < 0 or not np.isfinite(score) or score <= -1e29:
                continue
            if mask is not None and not mask[idx]:
                continue
            results.append(
                {
                    "rank": len(results) + 1,
                    "similarity_score": float(score),
                    "content": self.index.texts[idx],
                    "metadata": self.index.metadata[idx],
                }
            )
        return {
            "results": results,
            "summary": (
                f"Found {len(results)} results in "
                f"{category_filter or 'all categories'}"
            ),
        }

    def create_query_input(self, query: str) -> QueryInput:
        """A QueryInput with the query's embedding, keyword entities and
        keyword intent."""
        return QueryInput(
            text=query,
            embeddings=np.asarray(self.embedder.encode([query])[0]),
            entities=extract_entities_from_content(query),
            intent=infer_query_intent(query),
        )

    def get_content_statistics(self) -> Dict:
        return self.index.content_statistics()

    def suggest_queries(self, limit: int = 8) -> List[str]:
        """Query starters from the graph's first product names, category
        and document, then three general ones; the first `limit`."""
        suggestions: List[str] = []
        if self.graph is not None:
            g = self.graph

            def texts(label):
                return [str(g.node_texts[i]) for i, lbl in enumerate(g.node_labels)
                        if lbl == label]

            products = [t.split(" |")[0] for t in texts("Product")]
            categories = texts("Category")
            documents = texts("Document")
            if products:
                suggestions.append(f"Find products similar to {products[0]}")
                if len(products) > 1:
                    suggestions.append(f"Compare {products[0]} and {products[1]}")
            if categories:
                suggestions.append(f"Show me {categories[0]} products")
            if documents:
                suggestions.append(f"Show me the {documents[0]} document")
                suggestions.append(f"What does the {documents[0]} documentation say?")
        suggestions.extend(
            [
                "What products are under $500?",
                "Show me technical specifications",
                "What documents are available?",
            ]
        )
        return suggestions[:limit]

    # ------------------------------------------------------------------
    # Graph-enriched lookups
    # ------------------------------------------------------------------
    def query_similar_products(self, product_id, limit: int = 5) -> List[Dict]:
        """The products one hop from product `product_id` in the graph, by
        price ascending (0 where the text holds none), at most `limit`."""
        if self.graph is None:
            return []
        g = self.graph
        node = next(
            (i for i, (lbl, key) in enumerate(zip(g.node_labels, g.node_keys))
             if lbl == "Product" and str(key) == str(product_id)),
            None,
        )
        if node is None:
            return []
        nbrs, types = g.neighbors_of(node)
        out = []
        for nb, t in zip(nbrs, types):
            if g.node_labels[int(nb)] != "Product":
                continue
            text = g.node_texts[int(nb)]
            price = 0.0
            if "Price: $" in text:
                try:
                    price = float(text.split("Price: $")[1].split(" |")[0])
                except ValueError:
                    pass
            out.append(
                {
                    "product_name": text.split(" |")[0],
                    "product_id": g.node_keys[int(nb)],
                    "relationship_type": EDGE_TYPES[int(t)],
                    "price": price,
                }
            )
        out.sort(key=lambda r: r["price"])
        return out[:limit]

    @staticmethod
    def _parse_product_node_text(text: str):
        """(name, price, category) of a product node's text, "Name |
        Category: X | Price: $Y | ..."; None where a field is missing or
        does not parse."""
        parts = text.split(" | ")
        name, price, category = parts[0], None, None
        for part in parts[1:]:
            if part.startswith("Price: $"):
                try:
                    price = float(part[len("Price: $"):])
                except ValueError:
                    pass
            elif part.startswith("Category: "):
                category = part[len("Category: "):]
        return name, price, category

    def hybrid_search(self, search_term: str, limit: int = 5) -> List[Dict]:
        """Dense search over 2 x `limit` rows, then, for each Product
        database row with an entity id, its graph record: name, price,
        category, up to 3 SAME_CATEGORY neighbours' names, the similarity
        and the row text's first 100 characters.  Rows without an entity id,
        or (with a graph) without a product node, are skipped; without a
        graph the entity id is the name."""
        res, _ = self._text_query(search_term, top_k=limit * 2)
        items: List[Dict] = []
        same_category = edge_type_id("SAME_CATEGORY")
        for score, row in zip(res.top_scores[0], res.top_indices[0]):
            meta = self.index.metadata[int(row)]
            if not (meta.get("type") == "database_table"
                    and meta.get("table_name") == "Product"):
                continue
            entity_id = meta.get("entity_id")
            if not entity_id:
                continue
            name, price, category = str(entity_id), None, None
            related: List[str] = []
            if self.graph is not None:
                gid = int(self.index.graph_ids[int(row)])
                if gid < 0:
                    continue
                name, price, category = self._parse_product_node_text(
                    self.graph.node_texts[gid]
                )
                nbrs, types = self.graph.neighbors_of(gid)
                for nb, t in zip(nbrs, types):
                    if int(t) == same_category and len(related) < 3:
                        related.append(self.graph.node_texts[int(nb)].split(" |")[0])
            items.append(
                {
                    "name": name,
                    "price": price,
                    "category": category,
                    "similarity_score": float(score),
                    "related_products": related,
                    "embedding_text": self.index.texts[int(row)][:100] + "...",
                }
            )
            if len(items) >= limit:
                break
        return items
