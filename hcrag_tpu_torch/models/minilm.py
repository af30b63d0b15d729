"""MiniLM — the sentence encoder on the card.

Counterpart of `hcrag_tpu/models/minilm.py`: `MiniLMConfig`,
`TransformerLayer` and `MiniLMEncoder` as `torch.nn.Module`s, the
`SimpleTokenizer` and the `WordPieceTokenizer` (its Python path), the
embedder (`MiniLMEmbedder`: `encode`, `load_params`, `save_params`) and
`load_distilled_embedder`, which reads the distilled weights committed under
`tools/minilm_distilled*`.

The forward pass follows the Flax module's arithmetic in float32: token +
position + segment embeddings, LayerNorm (eps 1e-12; the mean of squares
minus the squared mean, as Flax computes the variance), then post-LN layers:
q, k, v projections to 12 heads of 32, the query scaled by 1/sqrt(32) before
its product with the keys, the logits of padded keys set to float32's
minimum, softmax, the out projection, the residual and LayerNorm, an exact
GELU feed-forward, the residual and LayerNorm; then the mean over valid
tokens (count clamped at 1e-9) and the L2 norm (clamped at 1e-12).  Flax
runs all of it outside any Pallas kernel, so the products here are
`nn.Linear` and `torch.matmul` (attention is written out: no fused-attention
call), and the CPU and the card run the same arithmetic.  Products run in
full float32: the forward refuses TF32 (`check_exact_matmul`).

`load_params` / `save_params` read and write the Flax parameter tree's
`.npz` (flattened "/"-joined names, `params/TransformerLayer_0/...`), so a
file written by either package loads in the other: `flax_to_state` and
`state_to_flax` map a DenseGeneral kernel [384, 12, 32] to a Linear weight
[384, 384] and back.  Without loaded weights the encoder's random weights
come from `seed` through PyTorch's generator, not Flax's.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import re
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from hcrag_tpu_torch.device import resolve_device
from hcrag_tpu_torch.ops.quantize import check_exact_matmul


@dataclasses.dataclass
class MiniLMConfig:
    vocab_size: int = 30522
    hidden_size: int = 384
    num_layers: int = 6
    num_heads: int = 12
    intermediate_size: int = 1536
    max_position: int = 512
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0


class LayerNorm(nn.Module):
    """Flax's LayerNorm: var = max(0, mean(x^2) - mean(x)^2), then
    (x - mean) * (rsqrt(var + eps) * scale) + bias."""

    def __init__(self, width: int, eps: float):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(width))
        self.bias = nn.Parameter(torch.zeros(width))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=-1, keepdim=True)
        var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.scale) + self.bias


class TransformerLayer(nn.Module):
    """Post-LN encoder layer: self-attention, residual, LayerNorm, an exact
    GELU feed-forward, residual, LayerNorm."""

    def __init__(self, cfg: MiniLMConfig):
        super().__init__()
        h = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.head_dim = h // cfg.num_heads
        self.query = nn.Linear(h, h)
        self.key = nn.Linear(h, h)
        self.value = nn.Linear(h, h)
        self.out = nn.Linear(h, h)
        self.attn_norm = LayerNorm(h, cfg.layer_norm_eps)
        self.dense_in = nn.Linear(h, cfg.intermediate_size)
        self.dense_out = nn.Linear(cfg.intermediate_size, h)
        self.ffn_norm = LayerNorm(h, cfg.layer_norm_eps)

    def forward(self, x: torch.Tensor, key_mask: torch.Tensor) -> torch.Tensor:
        """x [B, S, H] f32, key_mask [B, S] bool (True: a token to attend
        to) -> [B, S, H]."""
        b, s, h = x.shape
        heads = (b, s, self.num_heads, self.head_dim)
        q = self.query(x).view(heads) / math.sqrt(self.head_dim)
        k = self.key(x).view(heads)
        v = self.value(x).view(heads)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
        logits = torch.where(key_mask[:, None, None, :], logits,
                             torch.finfo(logits.dtype).min)
        weights = torch.softmax(logits, dim=-1)
        attn = torch.einsum("bhqk,bkhd->bqhd", weights, v).reshape(b, s, h)
        x = self.attn_norm(x + self.out(attn))
        hidden = nn.functional.gelu(self.dense_in(x), approximate="none")
        return self.ffn_norm(x + self.dense_out(hidden))


class MiniLMEncoder(nn.Module):
    """Token ids and attention mask -> L2-normalized mean-pooled sentence
    embeddings [B, H]."""

    def __init__(self, cfg: MiniLMConfig):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.tok = nn.Embedding(cfg.vocab_size, h)
        self.pos = nn.Embedding(cfg.max_position, h)
        self.seg = nn.Embedding(2, h)
        self.norm = LayerNorm(h, cfg.layer_norm_eps)
        self.layers = nn.ModuleList(TransformerLayer(cfg) for _ in range(cfg.num_layers))

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        check_exact_matmul()
        s = input_ids.shape[1]
        pos = torch.arange(s, device=input_ids.device)[None, :]
        x = self.norm(self.tok(input_ids) + self.pos(pos)
                      + self.seg(torch.zeros_like(input_ids)))
        key_mask = attention_mask.to(torch.bool)
        for layer in self.layers:
            x = layer(x, key_mask)
        m = attention_mask[..., None].to(x.dtype)
        pooled = (x * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1e-9)
        norm = torch.linalg.norm(pooled, dim=-1, keepdim=True)
        return pooled / torch.clamp(norm, min=1e-12)


# ---------------------------------------------------------------------------
# The Flax parameter tree <-> the module's state
# ---------------------------------------------------------------------------
_ATTENTION = "MultiHeadDotProductAttention_0"
_PROJECTIONS = ("query", "key", "value")
_LAYER_NORMS = {"attn_norm": "LayerNorm_0", "ffn_norm": "LayerNorm_1"}
_DENSES = {"dense_in": "Dense_0", "dense_out": "Dense_1"}


def flax_to_state(flat: Dict[str, np.ndarray], cfg: MiniLMConfig) -> Dict[str, torch.Tensor]:
    """The module's state dict from the Flax tree's flattened arrays (names
    joined by "/", with or without the leading "params/")."""
    p = {k[len("params/"):] if k.startswith("params/") else k: np.asarray(v, np.float32)
         for k, v in flat.items()}
    h = cfg.hidden_size

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    state = {
        "tok.weight": t(p["Embed_0/embedding"]),
        "pos.weight": t(p["Embed_1/embedding"]),
        "seg.weight": t(p["Embed_2/embedding"]),
        "norm.scale": t(p["LayerNorm_0/scale"]),
        "norm.bias": t(p["LayerNorm_0/bias"]),
    }
    for i in range(cfg.num_layers):
        src, dst = f"TransformerLayer_{i}/", f"layers.{i}."
        for name in _PROJECTIONS:  # kernel [H, heads, head_dim]
            state[dst + name + ".weight"] = t(p[f"{src}{_ATTENTION}/{name}/kernel"].reshape(h, h).T)
            state[dst + name + ".bias"] = t(p[f"{src}{_ATTENTION}/{name}/bias"].reshape(h))
        state[dst + "out.weight"] = t(p[f"{src}{_ATTENTION}/out/kernel"].reshape(h, h).T)
        state[dst + "out.bias"] = t(p[f"{src}{_ATTENTION}/out/bias"])
        for mine, theirs in _DENSES.items():
            state[dst + mine + ".weight"] = t(p[f"{src}{theirs}/kernel"].T)
            state[dst + mine + ".bias"] = t(p[f"{src}{theirs}/bias"])
        for mine, theirs in _LAYER_NORMS.items():
            state[dst + mine + ".scale"] = t(p[f"{src}{theirs}/scale"])
            state[dst + mine + ".bias"] = t(p[f"{src}{theirs}/bias"])
    return state


def state_to_flax(model: MiniLMEncoder) -> Dict[str, np.ndarray]:
    """The Flax tree's flattened arrays ("params/..." names) of the
    module's weights: the inverse of `flax_to_state`."""
    cfg = model.cfg
    h, heads = cfg.hidden_size, cfg.num_heads
    sd = {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}
    flat = {
        "Embed_0/embedding": sd["tok.weight"],
        "Embed_1/embedding": sd["pos.weight"],
        "Embed_2/embedding": sd["seg.weight"],
        "LayerNorm_0/scale": sd["norm.scale"],
        "LayerNorm_0/bias": sd["norm.bias"],
    }
    for i in range(cfg.num_layers):
        src, dst = f"layers.{i}.", f"TransformerLayer_{i}/"
        for name in _PROJECTIONS:
            flat[f"{dst}{_ATTENTION}/{name}/kernel"] = sd[src + name + ".weight"].T.reshape(
                h, heads, h // heads)
            flat[f"{dst}{_ATTENTION}/{name}/bias"] = sd[src + name + ".bias"].reshape(
                heads, h // heads)
        flat[f"{dst}{_ATTENTION}/out/kernel"] = sd[src + "out.weight"].T.reshape(
            heads, h // heads, h)
        flat[f"{dst}{_ATTENTION}/out/bias"] = sd[src + "out.bias"]
        for mine, theirs in _DENSES.items():
            flat[f"{dst}{theirs}/kernel"] = sd[src + mine + ".weight"].T
            flat[f"{dst}{theirs}/bias"] = sd[src + mine + ".bias"]
        for mine, theirs in _LAYER_NORMS.items():
            flat[f"{dst}{theirs}/scale"] = sd[src + mine + ".scale"]
            flat[f"{dst}{theirs}/bias"] = sd[src + mine + ".bias"]
    return {"params/" + k: np.ascontiguousarray(v) for k, v in flat.items()}


# ---------------------------------------------------------------------------
# Tokenizers
# ---------------------------------------------------------------------------
_WORD_RE = re.compile(r"[a-z0-9]+|[^\sa-z0-9]")


class SimpleTokenizer:
    """Deterministic hash tokenizer: words -> stable vocabulary buckets;
    ids 0 / 101 / 102 are pad / CLS / SEP, as in BERT."""

    def __init__(self, vocab_size: int = 30522, max_len: int = 128):
        self.vocab_size = vocab_size
        self.max_len = max_len

    def encode_batch(self, texts: Sequence[str], max_len: int = 0):
        max_len = min(max_len, self.max_len) if max_len else self.max_len
        ids = np.zeros((len(texts), max_len), dtype=np.int32)
        mask = np.zeros((len(texts), max_len), dtype=np.int32)
        reserved = min(999, max(self.vocab_size // 4, 103))
        bucket_range = self.vocab_size - reserved
        for i, text in enumerate(texts):
            words = _WORD_RE.findall(text.lower())[: max_len - 2]
            row = [101]
            for w in words:
                h = int.from_bytes(hashlib.blake2b(w.encode(), digest_size=4).digest(), "little")
                row.append(reserved + h % bucket_range)
            row.append(102)
            ids[i, : len(row)] = row
            mask[i, : len(row)] = 1
        return ids, mask


class WordPieceTokenizer:
    """Greedy longest-match-first WordPiece (BERT's tokenization) over a
    vocab.txt, in Python (the JAX package's C++ tokenizer computes the same
    ids)."""

    def __init__(self, vocab_path: str, max_len: int = 128, lowercase: bool = True):
        self.vocab = {}
        with open(vocab_path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                self.vocab[line.rstrip("\n")] = i
        self.max_len = max_len
        self.lowercase = lowercase
        self.cls_id = self.vocab.get("[CLS]", 101)
        self.sep_id = self.vocab.get("[SEP]", 102)
        self.unk_id = self.vocab.get("[UNK]", 100)
        self.vocab_size = len(self.vocab)

    def _wordpiece(self, word: str):
        if word in self.vocab:
            return [self.vocab[word]]
        pieces = []
        start = 0
        while start < len(word):
            end = len(word)
            piece_id = None
            while end > start:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    piece_id = self.vocab[sub]
                    break
                end -= 1
            if piece_id is None:
                return [self.unk_id]
            pieces.append(piece_id)
            start = end
        return pieces

    def encode_batch(self, texts: Sequence[str], max_len: int = 0):
        """(ids [B, L] int32, mask [B, L] int32), L = `max_len` capped at
        the tokenizer's own (which it is by default): [CLS], the word
        pieces, [SEP], zeros."""
        max_len = min(max_len, self.max_len) if max_len else self.max_len
        ids = np.zeros((len(texts), max_len), dtype=np.int32)
        mask = np.zeros((len(texts), max_len), dtype=np.int32)
        for i, text in enumerate(texts):
            if self.lowercase:
                text = text.lower()
            row = [self.cls_id]
            for word in _WORD_RE.findall(text):
                row.extend(self._wordpiece(word))
                if len(row) >= max_len - 1:
                    break
            row = row[: max_len - 1]
            row.append(self.sep_id)
            ids[i, : len(row)] = row
            mask[i, : len(row)] = 1
        return ids, mask


# ---------------------------------------------------------------------------
# The embedder
# ---------------------------------------------------------------------------
class MiniLMEmbedder:
    """Batched text embedder with the MiniLM architecture on one device
    (CUDA unless the caller names another)."""

    def __init__(
        self,
        cfg: Optional[MiniLMConfig] = None,
        tokenizer=None,
        seed: int = 0,
        max_len: int = 128,
        device: Optional[Union[str, torch.device]] = None,
    ):
        self.cfg = cfg or MiniLMConfig()
        self.dim = self.cfg.hidden_size
        self.device = resolve_device(device)
        self.tokenizer = tokenizer or SimpleTokenizer(self.cfg.vocab_size, max_len=max_len)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = MiniLMEncoder(self.cfg)
        self.model = model.to(self.device).eval()

    def load_params(self, npz_path: str) -> None:
        """Load the weights of an `.npz` of the Flax tree's flattened
        arrays."""
        with np.load(npz_path) as z:
            flat = {k: z[k] for k in z.files}
        self.model.load_state_dict(flax_to_state(flat, self.cfg))

    def save_params(self, npz_path: str) -> None:
        np.savez(npz_path, **state_to_flax(self.model))

    def encode(self, texts: Sequence[str], max_len: int = 0) -> np.ndarray:
        """Embeddings [B, H] f32 of `texts`.  `max_len` (optional) caps
        the padded length: short query batches at 64 cut the attention
        work, with the same embeddings for texts that fit."""
        ids, mask = self.tokenizer.encode_batch(list(texts), max_len=max_len)
        with torch.no_grad():
            out = self.model(torch.from_numpy(ids).to(self.device, torch.int64),
                             torch.from_numpy(mask).to(self.device))
        return out.cpu().numpy()


def load_distilled_embedder(
    base: Optional[str] = None, device: Optional[Union[str, torch.device]] = None
) -> Optional[MiniLMEmbedder]:
    """The distilled encoder (`tools/minilm_distilled.npz`, `_vocab.txt`,
    `_meta.json`: the MiniLM architecture trained to reproduce the
    reference artifact's all-MiniLM-L6-v2 vectors, with a corpus-built
    WordPiece vocabulary) on `device`, read in place; None when the files
    are absent."""
    if base is None:
        repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        base = os.path.join(repo, "tools", "minilm_distilled")
    npz, vocab, meta_p = base + ".npz", base + "_vocab.txt", base + "_meta.json"
    if not (os.path.exists(npz) and os.path.exists(vocab) and os.path.exists(meta_p)):
        return None
    with open(meta_p) as f:
        meta = json.load(f)
    cfg = MiniLMConfig(**meta["config"])
    tok = WordPieceTokenizer(vocab, max_len=meta["max_len"])
    emb = MiniLMEmbedder(cfg, tokenizer=tok, max_len=meta["max_len"], device=device)
    emb.load_params(npz)
    return emb
