"""Distil the MiniLM query encoder onto golden (text, vector) pairs.

    python -m hcrag_tpu_torch.tools.distill_minilm --pickle PAIRS.pkl            # one NVIDIA GPU
    python -m hcrag_tpu_torch.tools.distill_minilm --pickle PAIRS.pkl --device cpu --steps 2

Counterpart of `tools/distill_minilm.py`, with its flags, its arithmetic and
its outputs.  The pickle holds the reference layout's {embeddings, metadata,
texts, generation_info}: the golden vectors of all-MiniLM-L6-v2 for the
corpus texts.  The tool trains `models/minilm.MiniLMEncoder` (6 layers, 384
wide, 12 heads, FFN 1536) to reproduce them:

  * tokenizer: a WordPiece vocabulary built from the corpus
    (`build_corpus_vocab`: whole words by frequency, then single-character
    pieces, so a novel word splits into characters instead of [UNK]);
  * objective: 1 - cos(model(text), golden vector), AdamW (optax's
    `adamw`: b1 0.9, b2 0.999, eps 1e-8, weight decay 1e-4 on every
    parameter) under optax's `warmup_cosine_decay_schedule`
    (`learning_rate`, taken at the count before each step);
  * batches: `np.random.default_rng(0).choice` per step, so `--resume`
    replays the draws and a resumed run equals an uninterrupted one;
  * every `--scan-chunk` steps: the cosine of every example (no_grad, in
    blocks of `EVAL_ROWS` rows), a report {step, loss (the chunk's last),
    cos_mean, cos_min, elapsed_s}, a checkpoint when `--resume` names one,
    and a stop once cos_min >= `--target-cos`.

Outputs at `--out` (by default under `hcrag_tpu_torch/_trained/`, which git
ignores): `.npz` (the Flax tree's flattened arrays), `_vocab.txt` and
`_meta.json`, which `load_distilled_embedder(base)` of either package
reads.  With `--holdout-frac` the tool holds a seeded share of the pairs
out of training, evaluates the encoder on them (cosine, top-10 agreement
with the golden index, templated paraphrases, the hashing-encoder ensemble
sweep) and writes `_holdout.npz`, `_holdout_vocab.txt`,
`_holdout_meta.json` and `_holdout_report.json` instead.

The training state checkpoints through `utils/train_checkpoint.py` in the
JAX package's leaf order (`Distiller.train_state`), so a checkpoint that
either package writes resumes in the other.  The products are plain
`torch.matmul` in full float32 (no kernel of the port: the JAX trainer runs
none); every step runs on the tool's device (CUDA unless `--device`).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import pickle
import re
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from hcrag_tpu_torch.device import resolve_device
from hcrag_tpu_torch.models.minilm import (
    MiniLMConfig,
    MiniLMEmbedder,
    MiniLMEncoder,
    WordPieceTokenizer,
    flax_from_state,
    flax_to_state,
)
from hcrag_tpu_torch.utils.train_checkpoint import (
    _npz_path,
    adamw_state,
    optax_adamw,
    restore_train_state,
    save_train_state,
    set_adamw_state,
)

PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_PICKLE = "experiments/knowledge_graph_embeddings.pkl"
DEFAULT_OUT = os.path.join(PACKAGE, "_trained", "minilm_distilled")
EVAL_ROWS = 512  # examples per no_grad forward of the evaluation
_WORD_RE = re.compile(r"[a-z0-9]+|[^\sa-z0-9]")
_AUG_PREFIXES = ["show me ", "find ", "looking for ", "details about ",
                 "what about ", "i need ", "search for "]


def build_corpus_vocab(texts, out_path) -> str:
    """Whole corpus words by frequency + single-char fallback pieces.

    Greedy longest-match WordPiece over this vocab tokenizes every corpus
    word to itself and any novel word to characters — deterministic, no
    [UNK] explosions."""
    freq = {}
    chars = set()
    for t in texts:
        for w in _WORD_RE.findall(t.lower()):
            freq[w] = freq.get(w, 0) + 1
            chars.update(w)
    words = sorted(freq, key=lambda w: (-freq[w], w))
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]"]
    vocab += words
    vocab += sorted(c for c in chars if c not in freq)
    vocab += sorted("##" + c for c in chars)
    with open(out_path, "w", encoding="utf-8") as f:
        f.write("\n".join(vocab) + "\n")
    return out_path


def load_pairs(path: str) -> Tuple[List[str], np.ndarray]:
    """(texts, unit-norm golden vectors [N, D] f32) of a pickle in the
    reference layout.  Unpickling runs code the file names: read only files
    this program or a trusted tool wrote."""
    with open(path, "rb") as f:
        data = pickle.load(f)
    targets = np.asarray(data["embeddings"], dtype=np.float32)
    targets /= np.maximum(np.linalg.norm(targets, axis=1, keepdims=True), 1e-12)
    return list(data["texts"]), targets


def holdout_split(n: int, frac: float, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """(held-out rows, training rows), each sorted: the first
    max(1, int(n * frac)) of a seeded permutation are held out."""
    perm = np.random.default_rng(seed).permutation(n)
    n_hold = max(1, int(n * frac))
    return np.sort(perm[:n_hold]), np.sort(perm[n_hold:])


def augment(texts: Sequence[str], targets: np.ndarray, variants: int):
    """The texts followed by `variants` rounds of one surface variant per
    text (segment shuffle, query prefix, segment dropout, word dropout,
    within-segment word swap, punctuation strip; `default_rng(23)`), each
    mapped to its text's target."""
    rng = np.random.default_rng(23)

    def variant(t):
        segs = [s for s in t.split(". ") if s]
        mode = int(rng.integers(0, 6))
        if mode == 0 and len(segs) > 1:      # segment shuffle
            order = rng.permutation(len(segs))
            return ". ".join(segs[i] for i in order)
        if mode == 1:                        # query prefix
            return _AUG_PREFIXES[int(rng.integers(0, len(_AUG_PREFIXES)))] + t.lower()
        if mode == 2:                        # segment dropout
            keep = [s for s in segs if len(segs) <= 1 or rng.random() > 0.25]
            return ". ".join(keep) if keep else t
        if mode == 3:                        # word dropout (~12%)
            words = t.split(" ")
            keep = [w for w in words if len(words) <= 3 or rng.random() > 0.12]
            return " ".join(keep) if keep else t
        if mode == 4:                        # within-segment word shuffle
            out = []
            for s in segs or [t]:
                ws = s.split(" ")
                if len(ws) > 2 and rng.random() < 0.7:
                    i, j = rng.integers(0, len(ws), size=2)
                    ws[i], ws[j] = ws[j], ws[i]
                out.append(" ".join(ws))
            return ". ".join(out)
        # mode 5: punctuation strip + lowercase (query-style surface)
        return re.sub(r"[.,:;!?]", " ", t.lower()).strip()

    out_texts = list(texts)
    for _ in range(variants):
        out_texts.extend(variant(t) for t in texts)
    return out_texts, np.concatenate([targets] * (variants + 1), axis=0)


def paraphrase(t: str, mode: int) -> str:
    """The held-out evaluation's templates: segments reversed, "tell me
    about", "information on" + segments rotated."""
    segs = [s for s in t.split(". ") if s]
    if mode == 0:
        return ". ".join(reversed(segs))
    if mode == 1:
        return "tell me about " + t.lower()
    return "information on " + ". ".join(segs[1:] + segs[:1]).lower()


def learning_rate(count: int, lr: float, steps: int) -> float:
    """optax.warmup_cosine_decay_schedule(0, lr, warmup_steps=min(200,
    steps // 4), decay_steps=steps, end_value=0.02 * lr) at `count`: a
    linear rise from 0 over the warmup counts (so the first step's rate is
    0), then a cosine decay to 0.02 * lr over the steps - warmup counts
    after it.  In float64: optax's float32 values (which differ in the last
    bit between its jitted and eager forms) agree within float32 rounding."""
    warmup = min(200, steps // 4)
    if count < warmup:
        return lr * count / warmup
    decay = steps - warmup
    t = min(count - warmup, decay)
    return lr * (0.02 + 0.98 * 0.5 * (1.0 + math.cos(math.pi * t / decay)))


class Distiller:
    """The encoder's training on its device: the example bank (token ids,
    masks, unit targets), AdamW over every parameter and the schedule's
    count."""

    def __init__(self, model: MiniLMEncoder, ids: np.ndarray, mask: np.ndarray,
                 targets: np.ndarray, *, lr: float, steps: int):
        self.model, self.lr, self.steps = model, lr, steps
        self.device = next(model.parameters()).device
        self.ids = torch.from_numpy(np.asarray(ids)).to(self.device, torch.int64)
        self.mask = torch.from_numpy(np.asarray(mask)).to(self.device)
        self.targets = torch.from_numpy(np.asarray(targets, np.float32)).to(self.device)
        self.optimizer = optax_adamw(model.parameters(), 0.0)
        self.count = 0  # optax's schedule count: steps taken
        # The Flax tree's leaf names in `jax.tree_util`'s order (dict keys
        # sorted level by level).
        self._order = sorted(flax_from_state(model.state_dict(), model.cfg),
                             key=lambda k: tuple(k.split("/")))

    def step(self, rows: torch.Tensor) -> torch.Tensor:
        """One AdamW step on the examples `rows` (a device tensor) at the
        schedule's rate for the count before it; returns the loss before
        the step (a device scalar)."""
        for group in self.optimizer.param_groups:
            group["lr"] = learning_rate(self.count, self.lr, self.steps)
        self.optimizer.zero_grad(set_to_none=True)
        out = self.model(self.ids[rows], self.mask[rows])  # already L2-normalized
        loss = 1.0 - torch.mean(torch.sum(out * self.targets[rows], dim=-1))
        loss.backward()
        self.optimizer.step()
        self.count += 1
        return loss.detach()

    def train(self, batch_ids: np.ndarray) -> np.ndarray:
        """One step per row of batch_ids [k, batch]; the k losses."""
        rows = torch.from_numpy(np.asarray(batch_ids)).to(self.device, torch.int64)
        return torch.stack([self.step(r) for r in rows]).cpu().numpy()

    def evaluate(self) -> np.ndarray:
        """The cosine of every example's embedding with its target, without
        gradients, in blocks of `EVAL_ROWS` examples."""
        with torch.no_grad():
            out = torch.cat([self.model(self.ids[i:i + EVAL_ROWS], self.mask[i:i + EVAL_ROWS])
                             for i in range(0, len(self.ids), EVAL_ROWS)])
        return torch.sum(out * self.targets, dim=-1).cpu().numpy()

    def train_state(self) -> Tuple[List[np.ndarray], List[np.ndarray]]:
        """(parameter leaves, optimizer-state leaves) as the JAX trainer
        flattens its params and `optax.adamw` state: the 101 Flax leaves
        in tree order; then Adam's count (int32), its 101 first and 101
        second moments, and the schedule's count (int32)."""
        params = self._leaves(dict(self.model.named_parameters()))
        count, mu, nu = adamw_state(self.model, self.optimizer)
        return params, ([np.asarray(count, np.int32)] + self._leaves(mu) + self._leaves(nu)
                        + [np.asarray(self.count, np.int32)])

    def load_train_state(self, params: Sequence, opt_state: Sequence) -> None:
        """Set the parameters, the moments and both counts from leaves in
        `train_state`'s order (torch's per-parameter step from Adam's
        count)."""
        n = len(self._order)
        cfg = self.model.cfg
        self.model.load_state_dict(flax_to_state(dict(zip(self._order, params)), cfg))
        set_adamw_state(self.model, self.optimizer, int(opt_state[0]),
                        flax_to_state(dict(zip(self._order, opt_state[1:1 + n])), cfg),
                        flax_to_state(dict(zip(self._order, opt_state[1 + n:1 + 2 * n])), cfg))
        self.count = int(opt_state[-1])

    def _leaves(self, tensors) -> List[np.ndarray]:
        flat = flax_from_state(tensors, self.model.cfg)
        return [flat[k] for k in self._order]


def top10(qv: np.ndarray, bank: np.ndarray) -> np.ndarray:
    """The ten rows of `bank` with the largest dot product, per query row."""
    return np.argsort(-(qv @ bank.T), axis=1, kind="stable")[:, :10]


def agreement(got: np.ndarray, want: np.ndarray, src=None) -> np.ndarray:
    """The share of `got[j]`'s ten rows that `want[src[j]]` holds too."""
    src = range(len(got)) if src is None else src
    return np.array([len(set(got[j]) & set(want[i])) / 10.0 for j, i in enumerate(src)])


def holdout_report(emb: MiniLMEmbedder, all_texts, all_targets, holdout_idx) -> dict:
    """The held-out evaluation's numbers (as the JAX tool computes them):
    cosine and top-10 agreement of the held-out texts with the golden
    index, the agreement of three templated paraphrases of each, and the
    agreement of the encoder's scores blended with the corpus-IDF hashing
    encoder's at six weights."""
    from hcrag_tpu_torch.models.embedder import HashingEmbedder

    hold_texts = [all_texts[i] for i in holdout_idx]
    hold_tgt = all_targets[holdout_idx]
    h_out = emb.encode(hold_texts)
    cos_h = np.sum(h_out * hold_tgt, axis=-1)
    t_gold = top10(hold_tgt, all_targets)
    agree = agreement(top10(h_out, all_targets), t_gold)

    p_texts, p_src = [], []
    for mode in range(3):
        for i, t in enumerate(hold_texts):
            p_texts.append(paraphrase(t, mode))
            p_src.append(i)
    p_agree = agreement(top10(emb.encode(p_texts), all_targets), t_gold, p_src)

    hash_emb = HashingEmbedder().fit(all_texts)
    bank_hash = np.asarray(hash_emb.encode(all_texts), np.float32)
    bank_hash /= np.maximum(np.linalg.norm(bank_hash, axis=1, keepdims=True), 1e-12)
    q_hash = np.asarray(hash_emb.encode(hold_texts), np.float32)
    q_hash /= np.maximum(np.linalg.norm(q_hash, axis=1, keepdims=True), 1e-12)
    s_model = h_out @ all_targets.T
    s_hash = q_hash @ bank_hash.T
    ensemble = {}
    for alpha in (1.0, 0.8, 0.7, 0.5, 0.3, 0.0):
        s = alpha * s_model + (1 - alpha) * s_hash
        t_mix = np.argsort(-s, axis=1, kind="stable")[:, :10]
        ensemble[f"alpha_{alpha}"] = round(float(np.mean(agreement(t_mix, t_gold))), 4)
    return {
        "n_holdout": int(len(hold_texts)),
        "ensemble_top10_agreement": ensemble,
        "holdout_cos_mean": float(cos_h.mean()),
        "holdout_cos_min": float(cos_h.min()),
        "holdout_cos_p10": float(np.percentile(cos_h, 10)),
        "holdout_top10_agreement_mean": float(agree.mean()),
        "holdout_top10_agreement_min": float(agree.min()),
        "paraphrase_top10_agreement_mean": float(p_agree.mean()),
        "paraphrase_top10_agreement_p10": float(np.percentile(p_agree, 10)),
    }


def _config_json(cfg: MiniLMConfig) -> dict:
    return {k: getattr(cfg, k) for k in ("vocab_size", "hidden_size", "num_layers",
                                         "num_heads", "intermediate_size", "max_position")}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=12000)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--lr", type=float, default=4e-4)
    ap.add_argument("--max-len", type=int, default=192)
    ap.add_argument("--target-cos", type=float, default=0.999)
    ap.add_argument("--scan-chunk", type=int, default=50,
                    help="steps between evaluations, reports and checkpoints")
    ap.add_argument("--pickle", default=DEFAULT_PICKLE,
                    help="the golden pairs: {embeddings, metadata, texts, generation_info}")
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="artifact base path (.npz, _vocab.txt, _meta.json)")
    ap.add_argument("--resume", default=None,
                    help="train-state checkpoint to resume from (and where "
                         "periodic checkpoints are written)")
    ap.add_argument("--holdout-frac", type=float, default=0.0,
                    help="evaluation mode: hold this fraction of the pairs out of "
                         "training (seeded split), report held-out cosine and top-10 "
                         "agreement, write the _holdout artifacts only")
    ap.add_argument("--holdout-seed", type=int, default=17)
    ap.add_argument("--augment", type=int, default=0,
                    help="surface variants per training text, each mapped to the "
                         "text's golden vector")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without CUDA)")
    return ap.parse_args(argv)


def main(argv=None, init: Optional[dict] = None) -> dict:
    """Train, report and write the artifacts; returns {"reports": the
    per-chunk reports, "embedder": the trained `MiniLMEmbedder`,
    "holdout": the held-out report or None}.  `init` (the Flax tree's
    flattened arrays) replaces the seeded initial weights."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    texts, targets = load_pairs(args.pickle)
    holdout_idx = np.zeros(0, dtype=np.int64)
    all_texts, all_targets = texts, targets
    if args.holdout_frac > 0:
        # The vocabulary still comes from every text: what must generalize
        # is the encoder's weights, not the tokenizer.
        holdout_idx, train_idx = holdout_split(len(texts), args.holdout_frac,
                                               args.holdout_seed)
        print(f"holdout eval: {len(train_idx)} train / {len(holdout_idx)} held-out pairs")
        texts = [all_texts[i] for i in train_idx]
        targets = all_targets[train_idx]
    if args.augment > 0:
        texts, targets = augment(texts, targets, args.augment)
        print(f"augmented: {len(texts)} training examples "
              f"({args.augment} variants per text)")

    base = args.out + ("_holdout" if args.holdout_frac > 0 else "")
    os.makedirs(os.path.dirname(os.path.abspath(base)), exist_ok=True)
    tok = WordPieceTokenizer(build_corpus_vocab(all_texts, base + "_vocab.txt"),
                             max_len=args.max_len)
    ids, mask = tok.encode_batch(texts)
    print(f"vocab={tok.vocab_size} examples={len(texts)} max_len={args.max_len} "
          f"device={device}")

    cfg = MiniLMConfig(vocab_size=tok.vocab_size, max_position=args.max_len)
    emb = MiniLMEmbedder(cfg, tokenizer=tok, max_len=args.max_len, device=device)
    if init is not None:
        emb.model.load_state_dict(flax_to_state(init, cfg))
    trainer = Distiller(emb.model, ids, mask, targets, lr=args.lr, steps=args.steps)

    n = len(texts)
    rng = np.random.default_rng(0)
    step = 0
    if args.resume and os.path.exists(_npz_path(args.resume)):
        params, opt_state, step = restore_train_state(args.resume, *trainer.train_state())
        trainer.load_train_state(params, opt_state)
        # Replay the batch draws to the resume point: they are the only
        # randomness, so a resumed run equals an uninterrupted one.
        for _ in range(step):
            rng.choice(n, size=args.batch, replace=args.batch > n)
        print(f"resumed from {args.resume} at step {step}")
    t0 = time.time()
    report, reports = {}, []
    while step < args.steps:
        k = min(args.scan_chunk, args.steps - step)
        batch_ids = np.stack([rng.choice(n, size=args.batch, replace=args.batch > n)
                              for _ in range(k)])
        losses = trainer.train(batch_ids)
        step += k
        cos = trainer.evaluate()
        report = {
            "step": step,
            "loss": float(losses[-1]),
            "cos_mean": float(cos.mean()),
            "cos_min": float(cos.min()),
            "elapsed_s": round(time.time() - t0, 1),
        }
        print(report)
        reports.append(report)
        if args.resume:
            save_train_state(args.resume, *trainer.train_state(), step)
        if report["cos_min"] >= args.target_cos:
            break

    result = {"reports": reports, "embedder": emb, "holdout": None}
    meta = {"config": _config_json(cfg), "max_len": args.max_len}
    if args.holdout_frac > 0:
        hold = holdout_report(emb, all_texts, all_targets, holdout_idx)
        hold_report = {
            "n_train": int(len(all_texts) - len(holdout_idx)),  # raw pairs
            "n_train_examples": int(len(texts)),  # with the augmented variants
            "holdout_seed": args.holdout_seed,
            "train": report,
            **hold,
            "note": (
                "encoder trained WITHOUT these pairs; agreement = top-10 "
                "retrieval-set overlap vs querying the golden-vector index "
                "with the true MiniLM vector"
            ),
        }
        print(json.dumps(hold_report, indent=1))
        with open(base + "_report.json", "w") as f:
            json.dump(hold_report, f, indent=1)
        # The calibration (tools/encoder_confidence.py) needs an encoder that
        # has not seen the held-out pairs.
        emb.save_params(base + ".npz")
        meta.update(holdout_idx=[int(i) for i in holdout_idx],
                    holdout_seed=args.holdout_seed, train=report)
        with open(base + "_meta.json", "w") as f:
            json.dump(meta, f, indent=1)
        print("saved", base + "_report.json", "and", base + ".npz")
        result["holdout"] = hold_report
        return result

    emb.save_params(base + ".npz")
    meta.update(
        train=report,
        source=os.path.abspath(args.pickle),
        note=("distilled to the golden pairs' MiniLM vectors; corpus cosine "
              "floor is the golden-test bar, novel text interpolates"),
    )
    with open(base + "_meta.json", "w") as f:
        json.dump(meta, f, indent=1)
    print("saved", base + ".npz", "report:", report)
    return result


if __name__ == "__main__":
    main()
