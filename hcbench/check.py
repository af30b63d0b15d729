"""The comparison that decides `correct`.

Each kept batch (the queries and what the timed path answered for them) is
judged against the reference (`hcbench/reference.py`), which reads the
program's answers only to judge them.  The numbers, each the worst over
every answer judged:

  bad_index     returned rows outside the bank, or a row twice in one answer
  sel_gap       how far the worst returned row's exact similarity lies below
                the reference's k-th best (0 when the top-k is exact)
  score_err     |returned similarity - exact similarity of that row|
  rel_err       |relevance or blend - the reference's for the returned rows|
  exp_mismatch  expanded nodes and node counts that differ from the
                reference's expansion of the returned rows
  exp_rel_err   |expanded-node relevance - the reference's|

`control_outputs` puts the reference, one precision step lower, in the
program's place.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from hcbench.reference import Reference, relevance


def _max(x: torch.Tensor) -> float:
    return float(x.max()) if x.numel() else 0.0


def judge_batch(ref: Reference, traffic: Dict, q: torch.Tensor, out: Dict) -> Dict:
    """The numbers of one batch of answers, and the share of full subgraphs."""
    dev, n = ref.device, ref.corpus["emb"].shape[0]
    k = int(traffic["top_k"])
    q = q.to(dev)
    idx = out["top_indices"].to(dev, torch.int64)
    val = out["top_scores"].to(dev, torch.float64)
    inside = (idx >= 0) & (idx < n)
    srt = torch.sort(idx, dim=1).values
    twice = srt[:, 1:] == srt[:, :-1]
    exact = ref.score_rows(q, idx)
    ref_vals, _ = ref.retrieve(q, k)
    worst = torch.where(inside, exact, -torch.inf).min(dim=1).values
    nums = {
        "bad_index": float((~inside).sum() + twice.sum()),
        "sel_gap": max(0.0, _max(ref_vals[:, k - 1] - worst)),
        "score_err": _max((val - exact).abs()[inside]),
    }
    c = ref.corpus
    safe = idx.clamp(0, n - 1)
    sc = ref.config["scoring"]
    rel = relevance(exact, c["type_ids"][safe], c["counts"][safe], sc)
    blend = sc["combine"][0] * rel + sc["combine"][1] * exact
    nums["rel_err"] = max(
        _max((out["relevance"].to(dev, torch.float64) - rel).abs()),
        _max((out["combined"].to(dev, torch.float64) - blend).abs()))
    cap = int(traffic["max_expanded"])
    seeds = torch.where(val >= -1.0, idx, -1)
    nodes, counts = ref.expansion(seeds, int(traffic["depth"]), cap)
    got_nodes = out["expanded_nodes"].to(dev, torch.int64)
    got_counts = out["expanded_counts"].to(dev, torch.int64)
    nums["exp_mismatch"] = float((got_nodes != nodes).sum() + (got_counts != counts).sum())
    rel_e = ref.expanded_relevance(q, nodes)
    nums["exp_rel_err"] = _max(
        (out["expanded_relevance"].to(dev, torch.float64) - rel_e).abs())
    info = {"full_subgraphs": float((got_counts == cap).sum()),
            "queries": float(got_counts.shape[0])}
    return {"numbers": nums, "info": info}


def judge(ref: Reference, traffic: Dict, batches: List[Tuple[torch.Tensor, Dict]]) -> Tuple[Dict, Dict]:
    """(the worst of each number over every batch, summed info)."""
    worst: Dict[str, float] = {}
    info: Dict[str, float] = {"answers": 0.0}
    for q, out in batches:
        r = judge_batch(ref, traffic, q, out)
        for name, v in r["numbers"].items():
            worst[name] = max(worst.get(name, 0.0), v)
        for name, v in r["info"].items():
            info[name] = info.get(name, 0.0) + v
        info["answers"] += q.shape[0]
    return worst, info


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, List[Dict]]:
    """Correct when every number is at or under its limit; a cell that
    judged no answer, or lacks a limit for a number, is not correct."""
    rows = [dict(name=k, value=v, limit=limits.get(k)) for k, v in sorted(numbers.items())]
    ok = bool(rows) and all(r["limit"] is not None and r["value"] <= r["limit"] for r in rows)
    return ok, rows


def control_outputs(low: Reference, traffic: Dict, q: torch.Tensor) -> Dict:
    """What the reference at `low`'s (lower) precision answers for q, in the
    program's output layout."""
    k = int(traffic["top_k"])
    vals, idx = low.retrieve(q, k)
    out = {"top_scores": vals.to(torch.float32), "top_indices": idx}
    c, sc = low.corpus, low.config["scoring"]
    rel = relevance(vals, c["type_ids"][idx], c["counts"][idx], sc)
    out["relevance"] = rel.to(torch.float32)
    out["combined"] = (sc["combine"][0] * rel + sc["combine"][1] * vals).to(torch.float32)
    nodes, counts = low.expansion(idx, int(traffic["depth"]), int(traffic["max_expanded"]))
    out["expanded_nodes"], out["expanded_counts"] = nodes, counts
    out["expanded_relevance"] = low.expanded_relevance(q, nodes).to(torch.float32)
    return out
