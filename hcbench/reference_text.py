"""The plain reference of the text kind's encoder and tokenizer, in PyTorch.

A copy of the published forward (all-MiniLM-L6-v2: a BertModel, then the
mean over valid tokens and the L2 norm), kept here so that no change to
the program moves the yardstick, and a plain greedy WordPiece.  It imports
nothing of the program.

  * `WordPiece`: BERT's basic tokenization (lowercase, split on
    whitespace, every punctuation character a word of its own), then
    greedy longest-match-first pieces, "##" marking a piece inside a word,
    `[UNK]` for a word with no split; `[CLS]`, at most `max_len` - 2
    pieces, `[SEP]`, then `[PAD]` to `max_len`.  BERT's accent stripping
    and its splitting of CJK characters are left out: the traffic's texts
    are ASCII words.
  * `forward`: token + position + segment-0 embeddings, LayerNorm (two-pass
    variance, eps 1e-12); per layer the scaled dot-product attention of
    `num_heads` heads with padded keys left out of the softmax, the output
    projection, residual and LayerNorm, the exact-GELU feed-forward,
    residual and LayerNorm; the masked mean and the L2 norm.  The
    program's one known departure: its LayerNorm takes the variance in one
    pass, mean(x^2) - mean(x)^2, as Flax does.
  * `encode`: `forward` over blocks of texts, in `dtype`, TF32 off.
"""

from __future__ import annotations

import math
import unicodedata
from typing import Dict, List, Sequence, Tuple

import torch


def _is_punctuation(ch: str) -> bool:
    """BERT's rule: the ASCII symbols, and every Unicode punctuation."""
    cp = ord(ch)
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
        return True
    return unicodedata.category(ch).startswith("P")


class WordPiece:
    def __init__(self, vocab_path, lowercase: bool = True):
        with open(vocab_path, encoding="utf-8") as f:
            words = f.read().split("\n")
        if words and words[-1] == "":
            words.pop()
        self.vocab = {w: i for i, w in enumerate(words)}
        self.lowercase = lowercase
        self.pad, self.unk = self.vocab["[PAD]"], self.vocab["[UNK]"]
        self.cls, self.sep = self.vocab["[CLS]"], self.vocab["[SEP]"]

    def words(self, text: str) -> List[str]:
        if self.lowercase:
            text = text.lower()
        out = []
        for chunk in text.split():
            word = ""
            for ch in chunk:
                if _is_punctuation(ch):
                    if word:
                        out.append(word)
                    out.append(ch)
                    word = ""
                else:
                    word += ch
            if word:
                out.append(word)
        return out

    def pieces(self, word: str) -> List[int]:
        out, start = [], 0
        while start < len(word):
            end = len(word)
            while end > start:
                sub = word[start:end] if start == 0 else "##" + word[start:end]
                if sub in self.vocab:
                    out.append(self.vocab[sub])
                    break
                end -= 1
            if end == start:
                return [self.unk]
            start = end
        return out

    def ids(self, text: str, max_len: int) -> List[int]:
        pieces = [p for w in self.words(text) for p in self.pieces(w)]
        return [self.cls] + pieces[:max_len - 2] + [self.sep]

    def batch(self, texts: Sequence[str], max_len: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(ids [B, max_len] int32, mask [B, max_len] int32)."""
        ids = torch.full((len(texts), max_len), self.pad, dtype=torch.int32)
        mask = torch.zeros((len(texts), max_len), dtype=torch.int32)
        for i, text in enumerate(texts):
            row = self.ids(text, max_len)
            ids[i, :len(row)] = torch.tensor(row, dtype=torch.int32)
            mask[i, :len(row)] = 1
        return ids, mask


def layer_norm(x, weight, bias, eps):
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * weight + bias


def gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def linear(x, state, name):
    return x @ state[name + ".weight"].T + state[name + ".bias"]


def num_layers(state) -> int:
    return len({k.split(".")[2] for k in state if k.startswith("encoder.layer.")})


def forward(state: Dict[str, torch.Tensor], ids, mask, num_heads: int, eps: float):
    """Unit sentence embeddings [B, H] of ids [B, L] with mask [B, L]."""
    b, length = ids.shape
    x = (state["embeddings.word_embeddings.weight"][ids.long()]
         + state["embeddings.position_embeddings.weight"][:length][None]
         + state["embeddings.token_type_embeddings.weight"][0])
    x = layer_norm(x, state["embeddings.LayerNorm.weight"],
                   state["embeddings.LayerNorm.bias"], eps)
    hidden = x.shape[-1]
    head = hidden // num_heads
    keep = mask.bool()[:, None, None, :]
    for i in range(num_layers(state)):
        p = f"encoder.layer.{i}."

        def heads(t):
            return t.view(b, length, num_heads, head).transpose(1, 2)

        q = heads(linear(x, state, p + "attention.self.query"))
        k = heads(linear(x, state, p + "attention.self.key"))
        v = heads(linear(x, state, p + "attention.self.value"))
        scores = (q @ k.transpose(-1, -2)) / math.sqrt(head)
        scores = scores.masked_fill(~keep, float("-inf"))
        ctx = (torch.softmax(scores, dim=-1) @ v).transpose(1, 2).reshape(b, length, hidden)
        x = layer_norm(x + linear(ctx, state, p + "attention.output.dense"),
                       state[p + "attention.output.LayerNorm.weight"],
                       state[p + "attention.output.LayerNorm.bias"], eps)
        ffn = linear(gelu(linear(x, state, p + "intermediate.dense")), state, p + "output.dense")
        x = layer_norm(x + ffn, state[p + "output.LayerNorm.weight"],
                       state[p + "output.LayerNorm.bias"], eps)
    m = mask[..., None].to(x.dtype)
    pooled = (x * m).sum(dim=1) / m.sum(dim=1).clamp_min(1e-9)
    return pooled / pooled.norm(dim=-1, keepdim=True).clamp_min(1e-12)


def encode(state: Dict[str, torch.Tensor], ids, mask, num_heads: int, eps: float,
           dtype=torch.float64, block: int = 256) -> torch.Tensor:
    """`forward` in `dtype` over blocks of `block` texts, on the weights'
    device, with TF32 off; [B, H] in `dtype`."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            cast = {k: v.to(dtype) for k, v in state.items()}
            dev = next(iter(cast.values())).device
            return torch.cat([
                forward(cast, ids[s:s + block].to(dev), mask[s:s + block].to(dev),
                        num_heads, eps)
                for s in range(0, ids.shape[0], block)])
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
