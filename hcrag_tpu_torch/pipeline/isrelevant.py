"""Host-facing `isRelevant` API.

Counterpart of `hcrag_tpu/pipeline/isrelevant.py`: `isRelevant` and
`batch_isRelevant` over `QueryInput` / `NodeInput` lists.  The cheap
metrics run as tensor ops on `device` (CUDA unless the caller names
another); the LLM-judge metric is computed on the host in `batch_size`
chunks, with the reference's word-overlap fallback when the endpoint is
absent or fails:

    score = min(overlap / max(|query words|, 1) * 0.8 + 0.1, 0.9)

From FUSED_SCORING_MIN_NODES nodes up, on a CUDA device, one launch of
kernel B6 (`ops/scoring_cuda.batch_relevance`) computes the whole metric
stack and its reduction.
"""

from __future__ import annotations

from typing import List, Optional, Union

import numpy as np
import torch

from hcrag_tpu_torch.core.types import (
    DEFAULT_COMPOSITE_WEIGHTS,
    PRIORITY_MATRIX,
    CompositeWeights,
    NodeInput,
    QueryInput,
    ScorerType,
    node_type_id,
    scorer_needs_llm,
    scorer_spec,
)
from hcrag_tpu_torch.core.vocab import EntityVocab
from hcrag_tpu_torch.device import resolve_device
from hcrag_tpu_torch.ops.scoring import (
    combine_metrics,
    entity_match_scores,
    node_type_priority_scores,
    semantic_similarity_scores,
)
from hcrag_tpu_torch.ops.scoring_cuda import batch_relevance
from hcrag_tpu_torch.pipeline.llm import BatchRelevanceScore, LLMClient

Device = Optional[Union[str, torch.device]]

#: Node count from which `batch_isRelevant` takes the fused kernel on a CUDA
#: device.  The JAX package's routing rule, measured there on a TPU
#: (2.7x over the unfused metric stack at 8192 nodes, parity at 128); the
#: card's times of both routes are in PERF.md.
FUSED_SCORING_MIN_NODES = 2048

_judge_prompt_header = """You are an expert relevance evaluator for a knowledge graph system. Your task is to assess how relevant each piece of content is to a user's query."""


def overlap_fallback_scores(query: QueryInput, nodes: List[NodeInput]) -> List[float]:
    """The reference's LLM-judge failure heuristic: word overlap with the
    query."""
    query_words = set(query.text.lower().split())
    out = []
    for node in nodes:
        node_words = set(node.text.lower().split())
        overlap = len(query_words & node_words)
        out.append(min(overlap / max(len(query_words), 1) * 0.8 + 0.1, 0.9))
    return out


def batch_llm_judge(
    query: QueryInput,
    nodes: List[NodeInput],
    client: Optional[LLMClient] = None,
) -> List[float]:
    """One structured LLM call scoring every node 0-1, padding (0.5) or
    truncating a malformed score list and falling back to word overlap."""
    if not nodes:
        return []
    client = client or LLMClient()
    if client.offline:
        return overlap_fallback_scores(query, nodes)

    nodes_text = "\n\n".join(
        f"Content {i}: {node.text}" for i, node in enumerate(nodes, 1)
    )
    prompt = f"""
            User Query: {query.text}

            Multiple Contents to Evaluate:
            {nodes_text}

            """
    system_prompt = f"""{_judge_prompt_header}

You will receive {len(nodes)} pieces of content to evaluate. For each content, provide a relevance score between 0.0 and 1.0.

Scoring Guidelines:
- 0.9-1.0: Perfect match - directly answers the query or provides exactly what's requested
- 0.8-0.9: Highly relevant - very useful for answering the query, contains key information
- 0.6-0.7: Moderately relevant - somewhat useful, related but not central to the query
- 0.4-0.5: Marginally relevant - tangentially related, might provide context
- 0.2-0.3: Low relevance - weakly related, unlikely to be useful
- 0.0-0.1: Not relevant - completely unrelated to the query

Consider these factors:
1. Direct topic alignment (does the content address the query topic?)
2. Specificity match (does it match specific criteria like price, color, features?)
3. Content type appropriateness (product info for product queries, docs for technical questions)
4. Completeness (does it provide comprehensive information?)

Return exactly {len(nodes)} scores as a list, one for each content in order."""

    result = client.call(
        system_prompt, prompt, BatchRelevanceScore, timeout=15, fallback=False
    )
    if not isinstance(result, BatchRelevanceScore):
        return overlap_fallback_scores(query, nodes)
    scores = list(result.scores)
    while len(scores) < len(nodes):
        scores.append(0.5)
    return scores[: len(nodes)]


def _batch_process_with_llm(
    query: QueryInput,
    nodes: List[NodeInput],
    batch_size: int,
    client: Optional[LLMClient],
) -> List[float]:
    out: List[float] = []
    for i in range(0, len(nodes), batch_size):
        out.extend(batch_llm_judge(query, nodes[i : i + batch_size], client))
    return out


def _floats(t: torch.Tensor) -> List[float]:
    return [float(x) for x in t.cpu().numpy()]


def batch_semantic_similarity(
    query: QueryInput, nodes: List[NodeInput], *, device: Device = None
) -> List[float]:
    """(cosine + 1) / 2 of the query against each node."""
    if not nodes:
        return []
    dev = resolve_device(device)
    node_embs = np.stack([np.asarray(n.embeddings, np.float32) for n in nodes])
    out = semantic_similarity_scores(
        torch.from_numpy(np.asarray(query.embeddings, np.float32).copy()).to(dev),
        torch.from_numpy(node_embs).to(dev),
    )
    return _floats(out)


def batch_entity_match(
    query: QueryInput, nodes: List[NodeInput], *, device: Device = None
) -> List[float]:
    """Entity-set overlap of the query with each node, over a vocabulary of
    the nodes' and the query's entities."""
    if not nodes:
        return []
    dev = resolve_device(device)
    vocab = EntityVocab.build([n.entities for n in nodes] + [query.entities])
    node_bits, _ = vocab.encode_batch([n.entities for n in nodes])
    q_bits, q_oov = vocab.encode(query.entities)
    out = entity_match_scores(
        torch.from_numpy(q_bits.view(np.int32)).to(dev),
        torch.from_numpy(node_bits.view(np.int32)).to(dev),
        query_oov=int(q_oov),
    )
    return _floats(out)


def batch_node_type_priority(
    query: QueryInput, nodes: List[NodeInput], *, device: Device = None
) -> List[float]:
    """The priority of each node's type under the query's intent."""
    if not nodes:
        return []
    dev = resolve_device(device)
    type_ids = np.array([node_type_id(n.node_type) for n in nodes], np.int32)
    out = node_type_priority_scores(query.intent.index, torch.from_numpy(type_ids).to(dev))
    return _floats(out)


def _fused_inputs(
    query: QueryInput,
    nodes: List[NodeInput],
    scorer_type: ScorerType,
    weights: CompositeWeights,
    llm: Optional[List[float]],
    dev: torch.device,
):
    """The operands of kernel B6 for one query over `nodes`, on `dev`, and
    the strategy's reduction."""
    vocab = EntityVocab.build([n.entities for n in nodes] + [query.entities])
    # As in the JAX package, the second value of encode_batch (each node's
    # out-of-vocabulary count, 0 for every node here) is what the kernel
    # reads as the node's entity count; the empty-query rule sees it.
    node_bits, node_counts = vocab.encode_batch([n.entities for n in nodes])
    q_bits, q_oov = vocab.encode(query.entities)
    # The kernel scores raw dots; the metric is cosine, so both sides are
    # normalized here.
    q_emb = np.asarray(query.embeddings, np.float32).reshape(1, -1)
    q_emb = q_emb / max(float(np.linalg.norm(q_emb)), 1e-12)
    node_embs = np.stack([np.asarray(n.embeddings, np.float32) for n in nodes])
    node_embs = node_embs / np.maximum(
        np.linalg.norm(node_embs, axis=1, keepdims=True), 1e-12
    )
    type_ids = np.array([node_type_id(n.node_type) for n in nodes], np.int32)
    q_count = np.asarray(
        [int(np.unpackbits(q_bits.view(np.uint8)).sum()) + int(q_oov)], np.int32
    )
    w, reduction = scorer_spec(scorer_type, weights)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    args = (
        put(q_emb.astype(np.float32)),
        put(q_bits.view(np.int32).reshape(1, -1)),
        put(q_count),
        put(np.asarray([query.intent.index], np.int32)),
        put(node_embs.astype(np.float32)),
        put(node_bits.view(np.int32)),
        put(node_counts.astype(np.int32)),
        put(type_ids),
        put(np.asarray(w, np.float32)),
        put(PRIORITY_MATRIX),
        None if llm is None else put(np.asarray(llm, np.float32).reshape(1, -1)),
    )
    return args, reduction


def _fused_device_scores(
    query: QueryInput,
    nodes: List[NodeInput],
    scorer_type: ScorerType,
    weights: CompositeWeights,
    llm: Optional[List[float]] = None,
    *,
    device: Device = None,
) -> List[float]:
    """The whole metric stack and its reduction in one call of kernel B6
    (its plain version on the CPU); the judge column stays a host concern
    and rides in as `llm` when the strategy weights it."""
    args, reduction = _fused_inputs(
        query, nodes, scorer_type, weights, llm, resolve_device(device)
    )
    return _floats(batch_relevance(*args, reduction=reduction)[0])


def batch_isRelevant(
    query: QueryInput,
    nodes: List[NodeInput],
    scorer_type: ScorerType,
    batch_size: int = 10,
    weights: CompositeWeights = DEFAULT_COMPOSITE_WEIGHTS,
    client: Optional[LLMClient] = None,
    *,
    device: Device = None,
) -> List[float]:
    """The relevance of each node to the query under `scorer_type`: the
    single-metric strategies return their metric; the others reduce all
    four metrics (the judge column only where the strategy reads it)."""
    if not nodes:
        return []
    dev = resolve_device(device)

    if scorer_type == ScorerType.ROUTER_SINGLE_SEM:
        return batch_semantic_similarity(query, nodes, device=dev)
    if scorer_type == ScorerType.ROUTER_SINGLE_ENT:
        return batch_entity_match(query, nodes, device=dev)
    if scorer_type == ScorerType.ROUTER_SINGLE_TYPE:
        return batch_node_type_priority(query, nodes, device=dev)
    if scorer_type == ScorerType.ROUTER_SINGLE_LLM:
        return _batch_process_with_llm(query, nodes, batch_size, client)

    llm_col = (
        _batch_process_with_llm(query, nodes, batch_size, client)
        if scorer_needs_llm(scorer_type)
        else None
    )
    route = (
        _fused_device_scores
        if len(nodes) >= FUSED_SCORING_MIN_NODES and dev.type == "cuda"
        else _unfused_device_scores
    )
    return route(query, nodes, scorer_type, weights, llm=llm_col, device=dev)


def _unfused_device_scores(
    query: QueryInput,
    nodes: List[NodeInput],
    scorer_type: ScorerType,
    weights: CompositeWeights,
    llm: Optional[List[float]] = None,
    *,
    device: Device = None,
) -> List[float]:
    """The metric stack one metric at a time (each back on the host), then
    its reduction; zeros stand in for an absent judge column."""
    dev = resolve_device(device)
    sem = batch_semantic_similarity(query, nodes, device=dev)
    ent = batch_entity_match(query, nodes, device=dev)
    typ = batch_node_type_priority(query, nodes, device=dev)
    llm = llm if llm is not None else [0.0] * len(nodes)
    metrics = torch.from_numpy(
        np.stack([sem, llm, ent, typ], axis=-1).astype(np.float32)
    ).to(dev)
    w, reduction = scorer_spec(scorer_type, weights)
    return _floats(combine_metrics(metrics, torch.from_numpy(w).to(dev), reduction))


def isRelevant(
    query: QueryInput,
    node: NodeInput,
    scorer_type: ScorerType,
    weights: CompositeWeights = DEFAULT_COMPOSITE_WEIGHTS,
    client: Optional[LLMClient] = None,
    *,
    device: Device = None,
) -> float:
    """The relevance of one node (`batch_isRelevant` of one)."""
    return batch_isRelevant(
        query, [node], scorer_type, batch_size=1, weights=weights, client=client,
        device=device,
    )[0]
