"""Learned re-ranker: a small MLP over each candidate's metric vector.

Counterpart of `hcrag_tpu/models/reranker.py`.  The engine's final ranking
is a fixed blend (`combined = 0.7 * relevance + 0.3 * similarity`); this
module learns one instead.  An MLP of 5 -> 64 -> 64 -> 1 with ReLU over the
per-candidate features

    [semantic, llm, entity, type, raw cosine]

gives a relevance logit, trained by listwise softmax cross-entropy against
teacher scores (brute-force cosine, an LLM judge, click data).

The model and its AdamW optimizer run on the Reranker's device (CUDA unless
the caller names another) by plain autograd.  The parameters initialize as
Flax's `Dense` does (LeCun normal kernels: a normal truncated at two
standard deviations, scaled to variance 1/fan_in; zero biases), drawn from
a `torch.Generator` seeded with `seed`, and the optimizer is optax's
`adamw(lr)` (b1 0.9, b2 0.999, eps 1e-8, weight decay 1e-4).  `save` and
`restore` write and read the JAX package's checkpoint layout
(`utils/train_checkpoint.py`), so a checkpoint of either package restores in
the other.  The feature stack (`engine_candidate_features`) and
`ndcg_at_k` are host numpy, as in JAX.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from hcrag_tpu_torch.convert import (
    RERANKER_LAYERS,
    reranker_flax_params,
    reranker_leaves,
    reranker_state_from_flax,
    reranker_state_from_leaves,
)
from hcrag_tpu_torch.core.types import PRIORITY_MATRIX
from hcrag_tpu_torch.device import resolve_device
from hcrag_tpu_torch.models.flax_init import lecun_normal_
from hcrag_tpu_torch.utils.train_checkpoint import adamw_state, optax_adamw, set_adamw_state

NUM_FEATURES = 5  # sem, llm, ent, typ, raw cosine


class RerankerMLP(nn.Module):
    """feats [..., NUM_FEATURES] -> logits [...]."""

    def __init__(self, hidden: int = 64, generator: Optional[torch.Generator] = None):
        super().__init__()
        widths = [NUM_FEATURES, hidden, hidden, 1]
        self.layers = nn.ModuleList(
            nn.Linear(widths[i], widths[i + 1]) for i in range(RERANKER_LAYERS)
        )
        for layer in self.layers:
            lecun_normal_(layer, generator)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.layers[0](feats))
        x = torch.relu(self.layers[1](x))
        return self.layers[2](x)[..., 0]


def listwise_loss(logits, labels, mask) -> torch.Tensor:
    """Softmax cross-entropy of the logits against the teacher's softmax,
    masked slots at -1e9 on both sides, averaged over the batch: logits,
    labels and mask [B, K]."""
    logits = torch.where(mask, logits, -1e9)
    target = torch.where(mask, labels, -1e9)
    log_p = torch.log_softmax(logits, dim=-1)
    teacher = torch.softmax(target, dim=-1)
    return torch.mean(-torch.sum(teacher * log_p, dim=-1))


class Reranker:
    """Trainable candidate re-ranker over fused metric features."""

    def __init__(self, hidden: int = 64, learning_rate: float = 1e-3, seed: int = 0,
                 *, device=None):
        self.device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.model = RerankerMLP(hidden, generator=gen).to(self.device)
        self.optimizer = optax_adamw(self.model.parameters(), learning_rate)

    def train_state(self) -> Tuple[List[np.ndarray], List[np.ndarray]]:
        """(parameter leaves, optimizer-state leaves) as the JAX package
        flattens its `RerankerTrainState`: the 6 parameters, then AdamW's
        count (int32), its 6 first moments and its 6 second moments.  Before
        the first step the count is 0 and the moments zero."""
        params = reranker_leaves(self.model.state_dict())
        count, mu, nu = adamw_state(self.model, self.optimizer)
        return params, [np.asarray(count, np.int32)] + reranker_leaves(mu) + reranker_leaves(nu)

    def load_train_state(self, params: List[np.ndarray], opt_state: List[np.ndarray]) -> None:
        """Set the parameters and the optimizer state from leaves in the
        order `train_state` gives (torch's per-parameter step from the one
        count)."""
        n = len(params)
        self.model.load_state_dict(
            {k: v.to(self.device) for k, v in reranker_state_from_leaves(params).items()})
        set_adamw_state(self.model, self.optimizer, int(opt_state[0]),
                        reranker_state_from_leaves(opt_state[1:1 + n]),
                        reranker_state_from_leaves(opt_state[1 + n:]))

    def flax_params(self) -> dict:
        """The parameters as the JAX package's Flax tree."""
        return reranker_flax_params(self.model.state_dict())

    def load_flax_params(self, params) -> None:
        """Take the parameters of a Flax tree (the JAX `Reranker`'s
        `state.params`); the optimizer state is left as it is."""
        self.model.load_state_dict(
            {k: v.to(self.device) for k, v in reranker_state_from_flax(params).items()}
        )

    # ------------------------------------------------------------------
    def save(self, path, step: int = 0) -> None:
        """Checkpoint parameters + optimizer state (resume-exact
        training)."""
        from hcrag_tpu_torch.utils.train_checkpoint import save_train_state

        params, opt_state = self.train_state()
        save_train_state(path, params, opt_state, step)

    def restore(self, path) -> int:
        """Restore a checkpoint written by `save` (of either package);
        returns the saved step."""
        from hcrag_tpu_torch.utils.train_checkpoint import restore_train_state

        params, opt_state, step = restore_train_state(path, *self.train_state())
        self.load_train_state(params, opt_state)
        return step

    def _put(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def score(self, feats: np.ndarray) -> np.ndarray:
        """feats [..., NUM_FEATURES] -> learned relevance scores."""
        with torch.no_grad():
            out = self.model(self._put(np.asarray(feats, np.float32)))
        return out.cpu().numpy()

    def train_step(
        self, feats: np.ndarray, labels: np.ndarray, mask: Optional[np.ndarray] = None
    ) -> float:
        """One AdamW step on feats [B, K, F] against teacher labels [B, K]
        (mask [B, K], all True by default); returns the loss before the
        step."""
        if mask is None:
            mask = np.ones(np.shape(labels), dtype=bool)
        self.optimizer.zero_grad(set_to_none=True)
        loss = listwise_loss(
            self.model(self._put(np.asarray(feats, np.float32))),
            self._put(np.asarray(labels, np.float32)),
            self._put(np.asarray(mask, bool)),
        )
        loss.backward()
        self.optimizer.step()
        return float(loss.detach())

    def fit_distill(
        self,
        feats: np.ndarray,
        labels: np.ndarray,
        *,
        epochs: int = 10,
        batch_size: int = 32,
        seed: int = 0,
    ) -> list:
        """Minibatch distillation loop over `np.random.default_rng(seed)`
        permutations (the JAX package's minibatches); returns per-epoch
        mean losses."""
        rng = np.random.default_rng(seed)
        n = feats.shape[0]
        losses = []
        for _ in range(epochs):
            order = rng.permutation(n)
            epoch_loss = 0.0
            steps = 0
            for start in range(0, n, batch_size):
                sel = order[start : start + batch_size]
                epoch_loss += self.train_step(feats[sel], labels[sel])
                steps += 1
            losses.append(epoch_loss / max(steps, 1))
        return losses


def build_candidate_features(
    top_scores: np.ndarray,
    relevance_metrics: Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray],
) -> np.ndarray:
    """Stack (sem, llm, ent, typ) metric arrays + raw cosine into the
    re-ranker's feature tensor [..., NUM_FEATURES]."""
    sem, llm, ent, typ = relevance_metrics
    return np.stack([sem, llm, ent, typ, top_scores], axis=-1).astype(np.float32)


def _popcount_rows(bits: np.ndarray) -> np.ndarray:
    """Popcount over the last (uint32-words) axis of a host bitset array."""
    return np.unpackbits(
        bits.view(np.uint8).reshape(bits.shape[:-1] + (-1,)), axis=-1
    ).sum(axis=-1).astype(np.int32)


def engine_candidate_features(
    engine,
    res,
    intents=None,
    entity_lists=None,
) -> np.ndarray:
    """Host feature stack [B, k, NUM_FEATURES] of a QueryBatchResult's
    candidates, by the formulas the engine's step computes them (semantic
    (cos + 1) / 2, the entity bitset match with its 0.5 / 0.1 rules for a
    query without entities, the intent x type priority), with the llm column
    zero: the judge's score is unknown at query time, and the re-ranker is
    trained on the same zero column."""
    idx = np.asarray(res.top_indices)
    cos = np.asarray(res.top_scores, dtype=np.float32)
    b, k = idx.shape
    safe = np.clip(idx, 0, len(engine.index.type_ids) - 1)

    sem = (cos + 1.0) * 0.5
    llm = np.zeros_like(sem)

    if intents is None:
        intent_ids = np.zeros(b, np.int32)
    else:
        intent_ids = np.array([i.index for i in intents], np.int32)
    typ = np.asarray(PRIORITY_MATRIX, np.float32)[
        intent_ids[:, None], engine.index.type_ids[safe]
    ]

    vocab = engine.index.vocab
    q_bits = np.zeros((b, vocab.num_words), np.uint32)
    q_oov = np.zeros(b, np.int32)
    if entity_lists is not None:
        for i, ents in enumerate(entity_lists):
            q_bits[i], q_oov[i] = vocab.encode(ents)
    row_bits = engine.index.entity_bits[safe]  # [B, k, W]
    row_counts = engine.index.entity_counts[safe]
    q_count = _popcount_rows(q_bits) + q_oov  # [B]
    inter = _popcount_rows(q_bits[:, None, :] & row_bits)  # [B, k]
    ratio = inter.astype(np.float32) / np.maximum(
        q_count[:, None].astype(np.float32), 1.0
    )
    ent = np.where(
        (q_count == 0)[:, None],
        np.where(row_counts == 0, 0.5, 0.1),
        ratio,
    ).astype(np.float32)

    return build_candidate_features(cos, (sem, llm, ent, typ))


def distill_judge_aware(
    engine,
    reranker: Reranker,
    query_texts,
    query_embs: np.ndarray,
    *,
    intents=None,
    entity_lists=None,
    judge_fn=None,
    weights=None,
    top_m: int = 20,
    epochs: int = 30,
    seed: int = 0,
    label_temp: float = 10.0,
) -> dict:
    """Train the re-ranker to order candidates as the judge-inclusive blend
    does, without query-time LLM calls.

    Teacher: the full combined score of each query's top-m candidates,
    `0.7 * composite(sem, JUDGE, ent, typ) + 0.3 * cosine`, with the judge
    column real (`judge_fn(query_text, candidate_texts)`; by default the
    word-overlap heuristic).  Student: the same candidates' features with
    the judge column zero.  The labels are scaled by `label_temp` so the
    teacher's softmax peaks on its ranking.

    Returns {"losses": per-epoch losses, "features", "labels"}."""
    from hcrag_tpu_torch.core.types import CompositeWeights

    w = weights or CompositeWeights()
    if judge_fn is None:
        from hcrag_tpu_torch.core.types import NodeInput, QueryInput
        from hcrag_tpu_torch.pipeline.isrelevant import overlap_fallback_scores

        def judge_fn(q_text, cand_texts):
            q = QueryInput(text=q_text, embeddings=None, entities=[], intent=None)
            nodes = [
                NodeInput(
                    text=t, embeddings=None, graph_relations={},
                    node_type="unknown", entities=[],
                )
                for t in cand_texts
            ]
            return np.asarray(overlap_fallback_scores(q, nodes), np.float32)

    res = engine.query_batch(
        query_embs, top_k=top_m, intents=intents, entity_lists=entity_lists
    )
    feats = engine_candidate_features(
        engine, res, intents=intents, entity_lists=entity_lists
    )  # [B, m, F], llm column zero (the student's input)

    judge = np.stack(
        [
            judge_fn(
                query_texts[i],
                [engine.index.texts[int(j)] for j in res.top_indices[i]],
            )
            for i in range(len(query_texts))
        ]
    ).astype(np.float32)  # [B, m], the teacher's alone

    sem, _, ent, typ, cos = np.moveaxis(feats, -1, 0)
    teacher_rel = (
        w.semantic_similarity * sem
        + w.llm_judge * judge
        + w.entity_match * ent
        + w.node_type_priority * typ
    )
    labels = 0.7 * teacher_rel + 0.3 * cos

    losses = reranker.fit_distill(
        feats, labels * label_temp, epochs=epochs, seed=seed
    )
    return {"losses": losses, "features": feats, "labels": labels}


def ndcg_at_k(pred_order: np.ndarray, true_scores: np.ndarray, k: int) -> float:
    """Mean NDCG@k of a predicted ordering against teacher scores.

    pred_order [B, M]: candidate positions sorted by the predicted score;
    true_scores [B, M]: the teacher's relevance per original position."""
    b, m = pred_order.shape
    k = min(k, m)
    discounts = 1.0 / np.log2(np.arange(2, k + 2))
    gains = np.take_along_axis(true_scores, pred_order[:, :k], axis=1)
    dcg = (gains * discounts).sum(axis=1)
    ideal = np.sort(true_scores, axis=1)[:, ::-1][:, :k]
    idcg = (ideal * discounts).sum(axis=1)
    return float(np.mean(dcg / np.maximum(idcg, 1e-9)))
