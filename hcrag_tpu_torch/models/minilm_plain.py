"""The plain reference of the query encoder: all-MiniLM-L6-v2 as published.

A BertModel forward over the published state-dict names
(`embeddings.word_embeddings.weight`, `encoder.layer.{i}.attention.self.
query.weight`, ...), then sentence-transformers' pooling:

  * token + position + segment-0 embeddings, LayerNorm;
  * per layer (post-LN): q, k, v projections to `num_heads` heads, the
    scaled dot products, padded keys left out of the softmax, the weighted
    values, the output projection, the residual and LayerNorm; the
    feed-forward with the exact GELU, 0.5 x (1 + erf(x / sqrt 2)), the
    residual and LayerNorm;
  * the mean of the last hidden states over the valid tokens, then the L2
    norm.

LayerNorm takes the variance in two passes, mean((x - mean(x))^2), with
eps 1e-12.  The program's one departure: its LayerNorm follows Flax's
one-pass variance, mean(x^2) - mean(x)^2 (`models/minilm.py`).

It imports only torch and math: nothing of the program and no kernel.  It
computes in `dtype` (float32 by default) with TF32 off for the call, and
batches nothing beyond the tensors given.
"""

import math

import torch


def layer_norm(x, weight, bias, eps):
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * weight + bias


def gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def linear(x, state, name):
    return x @ state[name + ".weight"].T + state[name + ".bias"]


def num_layers(state):
    return len({k.split(".")[2] for k in state if k.startswith("encoder.layer.")})


def forward(state, ids, mask, num_heads=12, eps=1e-12):
    """Unit sentence embeddings [B, H] of token ids [B, L] with mask [B, L]
    (1 for a token, 0 for padding), from `state`'s tensors as they are."""
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


def encode(state, ids, mask, num_heads=12, eps=1e-12, dtype=torch.float32):
    """`forward` with every weight cast to `dtype`, on the weights' device,
    with TF32 off for float32 products."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            cast = {k: v.to(dtype) for k, v in state.items()
                    if k.startswith(("embeddings.", "encoder."))}
            dev = cast["embeddings.word_embeddings.weight"].device
            return forward(cast, ids.to(dev), mask.to(dev), num_heads, eps)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
