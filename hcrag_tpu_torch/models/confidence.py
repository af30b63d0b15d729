"""In-domain confidence for the distilled query encoder.

Counterpart of `hcrag_tpu/models/confidence.py`, all of it.  The distilled
MiniLM encoder (`models/minilm.load_distilled_embedder`) reproduces the
reference artifact's vectors on corpus-domain text but only interpolates
them off-domain, so `process_query` can report a calibrated confidence
that the encoder's retrieval for a query matches the true model's.

Signal, computed at query time from the encoder and the loaded index:

  * ``max_sim`` — cosine of the query embedding to its nearest index row;
  * ``ensemble_agreement`` — mean top-k overlap between the query's rows
    and those of K deterministic paraphrase variants of it.

A logistic score of the two, with coefficients from
``tools/encoder_confidence_calibration.json`` where that file exists, else
``DEFAULT_CALIBRATION``.  The feature pass is host numpy, as in the JAX
package (stable argsort), over the row-normalized bank.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

#: Query-time ensemble templates.  DELIBERATELY different strings from the
#: holdout evaluation's paraphrase templates (tools/distill_minilm.py uses
#: segment reversal / "tell me about" / "information on " + rotation) so the
#: calibration labels are never computed from the same transformations that
#: generate the features.
_N_VARIANTS = 3


def confidence_variants(text: str) -> List[str]:
    """K deterministic phrasing variants of `text` (excludes the original)."""
    segs = [s for s in text.split(". ") if s]
    half = len(text) // 2
    # split at the nearest space so variants stay word-aligned
    cut = text.rfind(" ", 0, half)
    cut = cut if cut > 0 else half
    return [
        "what about " + text.lower() + "?",
        ". ".join(segs[len(segs) // 2:] + segs[: len(segs) // 2])
        if len(segs) > 1 else (text[cut:].strip() + " " + text[:cut].strip()),
        "details regarding " + text.rstrip(".").lower(),
    ]


def _topk_sets(emb: np.ndarray, bank_norm: np.ndarray, k: int) -> np.ndarray:
    """[B, k] nearest-row ids of L2-normalized `emb` against `bank_norm`."""
    emb = np.asarray(emb, np.float32)
    emb = emb / np.maximum(np.linalg.norm(emb, axis=-1, keepdims=True), 1e-12)
    sims = emb @ bank_norm.T
    return np.argsort(-sims, axis=1, kind="stable")[:, :k]


DEFAULT_CALIBRATION = {
    # Fallback prior to running tools/encoder_confidence.py: equal logit
    # weight on both features, centered so (max_sim=0.75, agreement=0.75)
    # maps to ~0.5.  Overwritten by the shipped calibration file when built.
    "bias": -6.0,
    "w_max_sim": 4.0,
    "w_agreement": 4.0,
    "auc": None,
}

_CALIB_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "tools", "encoder_confidence_calibration.json",
)


def load_calibration(path: Optional[str] = None) -> Dict:
    p = path or _CALIB_PATH
    try:
        with open(p) as f:
            return json.load(f)
    except OSError:
        return dict(DEFAULT_CALIBRATION)


def confidence_features(
    embedder,
    bank_norm: np.ndarray,
    texts: Sequence[str],
    *,
    top_k: int = 10,
    query_emb: Optional[np.ndarray] = None,
) -> Dict[str, np.ndarray]:
    """Per-text confidence features against a row-normalized bank.

    One `embedder.encode` call covers all originals + variants.  When
    `query_emb` (the [B, D] embeddings already computed by the caller's
    retrieval step) is passed, originals are not re-encoded.
    """
    texts = list(texts)
    b = len(texts)
    variants: List[str] = []
    for t in texts:
        variants.extend(confidence_variants(t))
    if query_emb is None:
        enc = np.asarray(embedder.encode(texts + variants))
        orig, var = enc[:b], enc[b:]
    else:
        orig = np.asarray(query_emb, np.float32).reshape(b, -1)
        var = np.asarray(embedder.encode(variants))
    orig_n = orig / np.maximum(
        np.linalg.norm(orig, axis=-1, keepdims=True), 1e-12
    )
    max_sim = (orig_n @ bank_norm.T).max(axis=1)

    t_orig = _topk_sets(orig, bank_norm, top_k)
    t_var = _topk_sets(var, bank_norm, top_k)
    agreement = np.zeros(b, np.float64)
    for i in range(b):
        base = set(t_orig[i].tolist())
        ov = [
            len(base & set(t_var[i * _N_VARIANTS + j].tolist())) / top_k
            for j in range(_N_VARIANTS)
        ]
        agreement[i] = float(np.mean(ov))
    return {
        "max_sim": max_sim.astype(np.float64),
        "ensemble_agreement": agreement,
    }


def confidence_scores(
    features: Dict[str, np.ndarray], calibration: Optional[Dict] = None
) -> np.ndarray:
    c = calibration or load_calibration()
    z = (
        c["bias"]
        + c["w_max_sim"] * features["max_sim"]
        + c["w_agreement"] * features["ensemble_agreement"]
    )
    return 1.0 / (1.0 + np.exp(-z))


def encoder_confidence(
    embedder,
    bank_norm: np.ndarray,
    text: str,
    *,
    top_k: int = 10,
    query_emb: Optional[np.ndarray] = None,
    calibration: Optional[Dict] = None,
) -> Dict[str, float]:
    """Single-query convenience wrapper: features + calibrated score."""
    f = confidence_features(
        embedder, bank_norm, [text], top_k=top_k, query_emb=query_emb
    )
    score = confidence_scores(f, calibration)[0]
    return {
        "score": float(score),
        "max_sim": float(f["max_sim"][0]),
        "ensemble_agreement": float(f["ensemble_agreement"][0]),
    }


def fit_logistic(x: np.ndarray, y: np.ndarray, *, l2: float = 1e-3,
                 steps: int = 500) -> np.ndarray:
    """Newton-Raphson logistic regression (x: [N, F] features, y: {0,1});
    returns [F+1] = (bias, weights).  Self-contained — no sklearn in the
    image."""
    x1 = np.concatenate([np.ones((x.shape[0], 1)), x], axis=1)
    w = np.zeros(x1.shape[1])
    for _ in range(steps):
        p = 1.0 / (1.0 + np.exp(-(x1 @ w)))
        g = x1.T @ (p - y) + l2 * w
        s = np.maximum(p * (1 - p), 1e-6)
        h = (x1 * s[:, None]).T @ x1 + l2 * np.eye(x1.shape[1])
        step = np.linalg.solve(h, g)
        w = w - step
        if np.abs(step).max() < 1e-10:
            break
    return w


def auc_score(scores: np.ndarray, labels: np.ndarray) -> float:
    """Rank-based ROC AUC (Mann-Whitney U), ties get half credit."""
    scores = np.asarray(scores, np.float64)
    labels = np.asarray(labels).astype(bool)
    pos, neg = scores[labels], scores[~labels]
    if len(pos) == 0 or len(neg) == 0:
        return float("nan")
    order = np.argsort(np.concatenate([pos, neg]), kind="stable")
    ranks = np.empty(len(order), np.float64)
    ranks[order] = np.arange(1, len(order) + 1)
    # average ranks over ties
    allv = np.concatenate([pos, neg])
    for v in np.unique(allv):
        m = allv == v
        ranks[m] = ranks[m].mean()
    u = ranks[: len(pos)].sum() - len(pos) * (len(pos) + 1) / 2
    return float(u / (len(pos) * len(neg)))
