"""text: batches of natural-language queries into
`QueryEngine.query_text_batch_device`: the query encoder (all-MiniLM-L6-v2's
architecture) tokenizes and embeds each batch on the card, then the
retrieval kind's step runs on its embeddings.  Judged by the retrieval
numbers of `hcbench/check.py` over the program's own embeddings, and by

  emb_err       the largest |program's embedding - the plain encoder's|
                (`hcbench/reference_text.py`, float64, on the reference
                tokenizer's ids), over every element judged
  tok_mismatch  the texts whose ids or mask differ from the reference
                tokenizer's

Texts are drawn from the seed: every step holds the same multiset of
lengths (in word pieces, with [CLS] and [SEP]): the quantiles (i + 1/2) / B
of the traffic's log-normal, rounded and clipped, in an order drawn anew
each step; a text of n pieces is n - 2 whole words of the vocabulary, each
one piece.  A pool of `pool_steps` steps is drawn at set-up; past it, each
step draws its own.  No text batch is sent twice.
"""

from __future__ import annotations

import collections
import math
import re
from itertools import islice
from statistics import NormalDist
from typing import Dict, List, Sequence, Tuple

import torch

from hcbench import check, data, loops, reference, spec
from hcbench.bounds import select_bound_ms
from hcbench.reference_text import WordPiece, encode
from hcbench.spec import ROOT
from hcbench.system_text import WEIGHTS, System  # noqa: F401  (the kind's System)

lowered = reference.lowered
#: The reference's arithmetic at each stated precision of the encoder: the
#: stated float32 is checked against float64; the control runs in bf16.
ARITHMETIC = {"f32": torch.float64, "bf16": torch.bfloat16}


# ---------------------------------------------------------------------------
# The deployment's inputs: the retrieval kind's corpus, then the weights
# ---------------------------------------------------------------------------
def weight_shapes(enc: Dict) -> Dict[str, Tuple[int, ...]]:
    """The published BertModel names and shapes at the `encoder` widths."""
    h, f = int(enc["hidden_size"]), int(enc["intermediate_size"])
    shapes = {
        "embeddings.word_embeddings.weight": (int(enc["vocab_size"]), h),
        "embeddings.position_embeddings.weight": (int(enc["max_position_embeddings"]), h),
        "embeddings.token_type_embeddings.weight": (int(enc["type_vocab_size"]), h),
        "embeddings.LayerNorm.weight": (h,), "embeddings.LayerNorm.bias": (h,),
    }
    for i in range(int(enc["num_hidden_layers"])):
        p = f"encoder.layer.{i}."
        for name, (n_out, n_in) in {
                "attention.self.query": (h, h), "attention.self.key": (h, h),
                "attention.self.value": (h, h), "attention.output.dense": (h, h),
                "intermediate.dense": (f, h), "output.dense": (h, f)}.items():
            shapes[p + name + ".weight"] = (n_out, n_in)
            shapes[p + name + ".bias"] = (n_out,)
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            shapes[p + name + ".weight"] = (h,)
            shapes[p + name + ".bias"] = (h,)
    return shapes


def make_inputs(config: Dict, g: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """`data.make_corpus`, then the encoder's weights drawn on `device`
    under the published names (prefixed `minilm/`): every matrix,
    embedding and bias N(0, r^2), every LayerNorm weight 1 + N(0, r^2), r
    the configuration's `initializer_range`."""
    out = data.make_corpus(config, g, device)
    r = float(config["encoder"]["initializer_range"])
    for name, shape in weight_shapes(config["encoder"]).items():
        w = r * torch.randn(shape, generator=g, device=device, dtype=torch.float32)
        out[WEIGHTS + name] = w + 1.0 if name.endswith("LayerNorm.weight") else w
    return out


# ---------------------------------------------------------------------------
# The traffic
# ---------------------------------------------------------------------------
def lengths(traffic: Dict) -> List[int]:
    """The step's multiset of lengths in pieces: the quantiles (i + 1/2) / B
    of exp(log(median) + sigma Z), rounded, clipped to [min, max]."""
    ln, b = traffic["lengths"], int(traffic["batch"])
    z = NormalDist()
    mu, sigma = math.log(float(ln["median"])), float(ln["sigma"])
    return [min(int(ln["max"]), max(int(ln["min"]), round(math.exp(mu + sigma * z.inv_cdf(
        (i + 0.5) / b))))) for i in range(b)]


def whole_words(vocab_path) -> List[str]:
    """The vocabulary's entries that are whole lowercase words of letters
    and digits: each one word and one piece to either tokenizer."""
    with open(vocab_path, encoding="utf-8") as f:
        return [w for w in f.read().split("\n") if re.fullmatch(r"[a-z0-9]+", w)]


def draw_texts(g: torch.Generator, device, words: Sequence[str], pieces: Sequence[int],
               steps: int) -> List[List[str]]:
    """`steps` batches of texts: the lengths `pieces` in an order drawn
    from `g` per batch, a text of n pieces n - 2 words drawn uniformly."""
    n_words = torch.tensor(pieces, dtype=torch.int64) - 2
    order = torch.stack([torch.randperm(len(pieces), generator=g, device=device)
                         for _ in range(steps)]).cpu()
    per_text = n_words[order]
    ids = torch.randint(0, len(words), (int(per_text.sum()),), generator=g, device=device)
    it = map(words.__getitem__, ids.cpu().tolist())
    return [[" ".join(islice(it, n)) for n in row] for row in per_text.tolist()]


class TextLoop(loops.ClosedLoop):
    """The closed loop of `hcbench/loops.py` over batches of texts: the
    step (`query_text_batch_device`) back to back on fresh texts, at most
    `in_flight` steps queued on the device, `check_steps` steps kept by
    reservoir sampling over the window."""

    def __init__(self, system, traffic: Dict, g: torch.Generator, seed: int,
                 device: torch.device, dim: int):
        super().__init__(system, traffic, g, seed, device, dim)
        self.words = whole_words(ROOT / system.config["tokenizer"]["vocab"])
        self.pieces = lengths(traffic)
        self.pool = collections.deque(draw_texts(g, device, self.words, self.pieces,
                                                 int(traffic["pool_steps"])))

    def queries(self) -> List[str]:
        """The next batch of texts: the pool's, then drawn one at a time."""
        if self.pool:
            return self.pool.popleft()
        return draw_texts(self.g, self.device, self.words, self.pieces, 1)[0]

    def kept_batches(self) -> List[Tuple[List[str], Dict]]:
        native = self.system.native_tokenizer()
        out = []
        for _, (texts, (step, ids, mask)) in sorted(self.kept.items()):
            o = {n: t.cpu() for n, t in zip(loops.STEP_OUTPUTS + ("embeddings",), step)}
            o.update(ids=torch.from_numpy(ids), mask=torch.from_numpy(mask),
                     native_tokenizer=native)
            out.append((texts, o))
        return out

    def close(self) -> None:
        super().close()
        self.pool.clear()


LOOPS = {"closed": TextLoop}


# ---------------------------------------------------------------------------
# The reference and the judge
# ---------------------------------------------------------------------------
class Reference:
    """The retrieval reference (`hcbench/reference.py`) over the corpus,
    the reference tokenizer and the plain encoder over the weights, at the
    configuration's precision or at another `precision` block."""

    def __init__(self, config: Dict, inputs: Dict[str, torch.Tensor], device, precision=None):
        self.config = config
        self.precision = precision or config["precision"]
        corpus = {k: v for k, v in inputs.items() if not k.startswith(WEIGHTS)}
        self.retrieval = reference.Reference(config, corpus, device, self.precision)
        p = self.precision["encoder"]
        self.weights = {k[len(WEIGHTS):]: reference.rounded(v.to(device), p["weights"])
                        for k, v in inputs.items() if k.startswith(WEIGHTS)}
        self.dtype = ARITHMETIC[p["activations"]]
        self.tokenizer = WordPiece(ROOT / config["tokenizer"]["vocab"],
                                   bool(config["tokenizer"]["lowercase"]))

    def tokenize(self, texts: Sequence[str], max_len: int):
        return self.tokenizer.batch(texts, max_len)

    def encode(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        enc = self.config["encoder"]
        return encode(self.weights, ids, mask, int(enc["num_attention_heads"]),
                      float(enc["layer_norm_eps"]), dtype=self.dtype)


def judge(ref: Reference, traffic: Dict, batches) -> Tuple[Dict, Dict]:
    """(the worst of each number over every batch, summed info)."""
    worst: Dict[str, float] = {}
    info: Dict[str, float] = {"answers": 0.0, "native_batches": 0.0, "batches": 0.0}
    for texts, out in batches:
        emb = out["embeddings"]
        r = check.judge_batch(ref.retrieval, traffic, emb, out)
        nums = r["numbers"]
        ids, mask = ref.tokenize(texts, int(traffic["max_len"]))
        nums["tok_mismatch"] = float(((out["ids"] != ids) | (out["mask"] != mask))
                                     .any(dim=1).sum())
        want = ref.encode(ids, mask).to(torch.float64)
        nums["emb_err"] = float((emb.to(want.device, torch.float64) - want).abs().max())
        for name, v in nums.items():
            worst[name] = max(worst.get(name, 0.0), v)
        for name, v in r["info"].items():
            info[name] = info.get(name, 0.0) + v
        info["answers"] += len(texts)
        info["batches"] += 1
        info["native_batches"] += float(bool(out.get("native_tokenizer")))
    return worst, info


def control_outputs(low: Reference, traffic: Dict, texts: Sequence[str]) -> Dict:
    """What the reference at `low`'s precision answers for the texts: its
    tokens, its encoder's embeddings (bf16 below f32) and the retrieval
    reference's answers for them, in the program's layout."""
    ids, mask = low.tokenize(texts, int(traffic["max_len"]))
    emb = low.encode(ids, mask).to(torch.float32)
    out = check.control_outputs(low.retrieval, traffic, emb)
    out.update(embeddings=emb, ids=ids, mask=mask)
    return out


def work_problem(traffic: Dict, config: Dict):
    """Why the traffic's work could depend on the seed, or None: the
    retrieval kind's check, then the lengths, which must be the fixed
    quantile multiset and fit `max_len` uncut, itself within the
    configuration's."""
    problem = spec.fixed_work_problem(traffic, config)
    if problem:
        return problem
    ln = traffic.get("lengths", {})
    if ln.get("draw") != "quantiles":
        return ("lengths must be drawn as \"quantiles\": the same multiset on every seed; "
                f"got {ln.get('draw')!r}")
    if int(traffic["max_len"]) > int(config["max_len"]):
        return f"max_len {traffic['max_len']} exceeds the configuration's {config['max_len']}"
    if not 3 <= int(ln["min"]) <= int(ln["max"]) <= int(traffic["max_len"]):
        return (f"lengths [{ln['min']}, {ln['max']}] must hold a word and fit max_len "
                f"{traffic['max_len']} uncut")
    return None


# ---------------------------------------------------------------------------
# What the readers need, and the last words on info
# ---------------------------------------------------------------------------
def model_flops(pieces: Sequence[int], enc: Dict) -> float:
    """The encoder's model FLOPs for texts of these lengths (padding not
    counted): per layer and text of n tokens, n (8 h^2 + 4 h f) for the
    four projections and the feed-forward, 4 n^2 h for the attention's two
    products; embeddings, norms, softmax and pooling not counted."""
    h, f = int(enc["hidden_size"]), int(enc["intermediate_size"])
    return float(int(enc["num_hidden_layers"]) * sum(
        n * (8 * h * h + 4 * h * f) + 4 * n * n * h for n in pieces))


def trace_info(config: Dict, traffic: Dict) -> Dict:
    """The selection's kernels and bound (`select_roofline.text`) and the
    encoder's model FLOPs per step (`mfu.text`)."""
    return {"select_kernels": config.get("select_kernels"),
            "select_bound_ms": select_bound_ms(
                int(traffic["batch"]), int(config["rows"]), int(config["dim"]),
                config["select_bank"], int(traffic["top_k"])),
            "model_flops_per_step": model_flops(lengths(traffic), config["encoder"])}


def finish_info(info: Dict) -> None:
    """The tokenizer path that ran (`native` or `python`) and the share of
    judged queries whose subgraph reached `max_expanded`, in place of their
    sums."""
    native, batches = info.pop("native_batches", 0.0), info.pop("batches", 0.0)
    if batches:
        info["tokenizer"] = "native" if native == batches else "python"
    if "queries" in info:
        info["full_subgraph_share"] = info.pop("full_subgraphs") / info.pop("queries")
