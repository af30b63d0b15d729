"""Calibrate the query encoder's in-domain confidence on held-out pairs.

    python -m hcrag_tpu_torch.tools.encoder_confidence --pickle PAIRS.pkl            # one NVIDIA GPU
    python -m hcrag_tpu_torch.tools.encoder_confidence --pickle PAIRS.pkl --device cpu

Counterpart of `tools/encoder_confidence.py`.  It fits the logistic that
`models/confidence.load_calibration` reads, against labels the encoder has
not seen:

  1. loads the held-out encoder (`distill_minilm --holdout-frac 0.2
     --augment K` writes `<base>_holdout.npz`, `_vocab.txt`, `_meta.json`);
  2. builds the evaluation set: the held-out texts and three paraphrases of
     each (`distill_minilm.paraphrase`, not the query-time variants of
     `confidence_variants`);
  3. labels each query by the top-10 agreement of its retrieval with the
     golden index's (>= 0.5: the encoder serves it faithfully);
  4. computes `confidence_features`, fits `fit_logistic` on the queries of
     half the source texts (`default_rng(7)`), scores the other half (ROC
     AUC), then fits on all of them;
  5. writes `<out>_calibration.json` (the fit on all) and `<out>_report.json`
     (with the lift of encoding each held-out text as the mean of it and its
     query-time variants).

The encoder runs on the tool's device (CUDA unless `--device`); the
features, the fit and the AUC are host numpy, as in the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from hcrag_tpu_torch.models.confidence import (
    auc_score,
    confidence_features,
    confidence_scores,
    confidence_variants,
    fit_logistic,
)
from hcrag_tpu_torch.models.minilm import load_distilled_embedder
from hcrag_tpu_torch.tools.distill_minilm import (
    DEFAULT_OUT,
    DEFAULT_PICKLE,
    PACKAGE,
    agreement,
    load_pairs,
    paraphrase,
    top10,
)

DEFAULT_CALIBRATION_OUT = os.path.join(PACKAGE, "_trained", "encoder_confidence")


def load_holdout_embedder(base: str, device=None):
    """(the held-out encoder of `base`, its held-out row ids)."""
    meta_p = base + "_holdout_meta.json"
    emb = load_distilled_embedder(base + "_holdout", device=device)
    if emb is None:
        raise SystemExit(
            f"missing {base}_holdout.npz / _vocab.txt / _meta.json: run "
            "python -m hcrag_tpu_torch.tools.distill_minilm --holdout-frac 0.2 "
            "--augment 2 first"
        )
    with open(meta_p) as f:
        return emb, [int(i) for i in json.load(f)["holdout_idx"]]


def main(argv=None) -> dict:
    """Fit, score and write the calibration and the report; returns the
    report."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", default=DEFAULT_OUT,
                    help="distill_minilm's --out: the held-out encoder is <base>_holdout")
    ap.add_argument("--pickle", default=DEFAULT_PICKLE,
                    help="the golden pairs the encoder was distilled on")
    ap.add_argument("--out", default=DEFAULT_CALIBRATION_OUT,
                    help="writes <out>_calibration.json and <out>_report.json")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without CUDA)")
    args = ap.parse_args(argv)

    emb, holdout_idx = load_holdout_embedder(args.base, device=args.device)
    all_texts, golden_n = load_pairs(args.pickle)
    hold_texts = [all_texts[i] for i in holdout_idx]
    gold_hold = golden_n[holdout_idx]

    def retrieve(v):  # unit rows, then their ten nearest golden vectors
        v = np.asarray(v, np.float32)
        return top10(v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-12), golden_n)

    t_gold = retrieve(gold_hold)  # the golden vectors' retrieval sets

    # ---- evaluation queries: the originals + 3 unseen paraphrases each ----
    queries, gold_of = list(hold_texts), list(range(len(hold_texts)))
    for mode in range(3):
        for i, t in enumerate(hold_texts):
            queries.append(paraphrase(t, mode))
            gold_of.append(i)
    print(f"eval set: {len(queries)} queries "
          f"({len(hold_texts)} originals + {3 * len(hold_texts)} paraphrases)")

    q_emb = np.asarray(emb.encode(queries))
    agree = agreement(retrieve(q_emb), t_gold, gold_of)
    labels = (agree >= 0.5).astype(np.float64)
    print(f"label balance: {labels.mean():.3f} positive "
          f"(agreement mean {agree.mean():.3f})")

    feats = confidence_features(emb, golden_n, queries, query_emb=q_emb)
    x = np.stack([feats["max_sim"], feats["ensemble_agreement"]], axis=1)

    # ---- AUC on a split by source text (a query and its paraphrases never
    # straddle it) ------------------------------------------------------------
    src_perm = np.random.default_rng(7).permutation(len(hold_texts))
    half = set(src_perm[: len(hold_texts) // 2].tolist())
    tr = np.array([g in half for g in gold_of])
    te = ~tr
    w = fit_logistic(x[tr], labels[tr])
    cal = {"bias": float(w[0]), "w_max_sim": float(w[1]), "w_agreement": float(w[2])}
    s_te = confidence_scores({"max_sim": x[te, 0], "ensemble_agreement": x[te, 1]}, cal)
    auc_te = auc_score(s_te, labels[te])
    auc_ms = auc_score(x[te, 0], labels[te])
    auc_ag = auc_score(x[te, 1], labels[te])
    print(f"held-out-split AUC: combined {auc_te:.4f} "
          f"(max_sim alone {auc_ms:.4f}, agreement alone {auc_ag:.4f})")

    # ---- the calibration: fit on every query ---------------------------------
    w_all = fit_logistic(x, labels)
    cal_all = {
        "bias": float(w_all[0]),
        "w_max_sim": float(w_all[1]),
        "w_agreement": float(w_all[2]),
        "auc": float(auc_te),
        "auc_split": "fit on half the source texts, scored on the rest",
        "n_eval_queries": int(len(queries)),
        "label": "top-10 retrieval agreement vs golden index >= 0.5",
        "encoder": "holdout-trained (never saw eval texts)",
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out + "_calibration.json", "w") as f:
        json.dump(cal_all, f, indent=1)
    print("wrote", args.out + "_calibration.json")

    # ---- the lift of encoding a text as the mean over its variants ------------
    ens_texts = []
    for t in hold_texts:
        ens_texts.extend([t] + confidence_variants(t))
    k = 1 + len(confidence_variants(hold_texts[0]))
    e = np.asarray(emb.encode(ens_texts)).reshape(len(hold_texts), k, -1)
    e = e / np.maximum(np.linalg.norm(e, axis=-1, keepdims=True), 1e-12)
    own = range(len(hold_texts))
    a_single = agreement(retrieve(e[:, 0]), t_gold, own)
    a_ens = agreement(retrieve(e.mean(axis=1)), t_gold, own)
    print(f"holdout top-10 agreement: single {a_single.mean():.4f} "
          f"-> ensemble {a_ens.mean():.4f}")

    report = {
        "n_holdout": len(hold_texts),
        "n_eval_queries": len(queries),
        "label_positive_frac": float(labels.mean()),
        "auc_combined_heldout_split": float(auc_te),
        "auc_max_sim_only": float(auc_ms),
        "auc_agreement_only": float(auc_ag),
        "calibration": cal_all,
        "ensemble_encoding": {
            "holdout_agreement_single": float(a_single.mean()),
            "holdout_agreement_ensemble": float(a_ens.mean()),
        },
        "note": (
            "labels + features from the HOLDOUT-trained encoder; "
            "confidence.py's query-time templates differ from the eval "
            "paraphrase templates by construction"
        ),
    }
    with open(args.out + "_report.json", "w") as f:
        json.dump(report, f, indent=1)
    print("wrote", args.out + "_report.json")
    print(json.dumps({"auc": round(float(auc_te), 4),
                      "target": 0.8, "pass": bool(auc_te >= 0.8)}))
    return report


if __name__ == "__main__":
    main()
