"""Convert HuggingFace all-MiniLM-L6-v2 weights to the MiniLM `.npz` layout.

    python -m hcrag_tpu_torch.tools.convert_minilm MODEL_DIR OUT.npz            # checked on one NVIDIA GPU
    python -m hcrag_tpu_torch.tools.convert_minilm MODEL_DIR OUT.npz --device cpu

Counterpart of `tools/convert_minilm.py`: it maps a HuggingFace BERT
checkpoint (`model.safetensors` where the safetensors package imports, else
`pytorch_model.bin`) onto the Flax tree's flattened names, array for array
as the JAX tool does (through `models/minilm.py`'s `bert_to_state` and
`flax_from_state`), and writes the `.npz` that `MiniLMEmbedder.load_params`
of either package reads.  Then it loads the file into the port's encoder on
the device (CUDA unless `--device`) and checks one forward.  Nothing is
downloaded: the weights must already be on disk.

Mapping (HF BertModel -> MiniLMEncoder):
  embeddings.word_embeddings.weight        -> Embed_0.embedding
  embeddings.position_embeddings.weight    -> Embed_1.embedding
  embeddings.token_type_embeddings.weight  -> Embed_2.embedding
  embeddings.LayerNorm.{weight,bias}       -> LayerNorm_0.{scale,bias}
  encoder.layer.{i}.attention.self.{query,key,value}.{weight,bias}
      -> TransformerLayer_{i}.MultiHeadDotProductAttention_0.{query,key,value}
         .kernel [D, H, Dh] / bias [H, Dh]
  encoder.layer.{i}.attention.output.dense -> ...attention out kernel [H, Dh, D]
  encoder.layer.{i}.attention.output.LayerNorm -> LayerNorm_0 of the layer
  encoder.layer.{i}.intermediate.dense     -> Dense_0
  encoder.layer.{i}.output.dense           -> Dense_1
  encoder.layer.{i}.output.LayerNorm       -> LayerNorm_1
"""

from __future__ import annotations

import argparse
import os
import re

import numpy as np


def load_hf_state_dict(model_dir: str) -> dict:
    """Tensors as numpy arrays from `model.safetensors` (when the
    safetensors package imports) or `pytorch_model.bin` (through
    `torch.load(weights_only=True)`), whichever is found first."""
    st_path = os.path.join(model_dir, "model.safetensors")
    if os.path.exists(st_path):
        try:
            from safetensors.numpy import load_file
        except ImportError:
            load_file = None
        if load_file is not None:
            return load_file(st_path)
    bin_path = os.path.join(model_dir, "pytorch_model.bin")
    if os.path.exists(bin_path):
        import torch

        sd = torch.load(bin_path, map_location="cpu", weights_only=True)
        return {k: v.numpy() for k, v in sd.items()}
    raise FileNotFoundError(f"no readable checkpoint under {model_dir}")


def convert(state: dict, num_layers: int = 6, num_heads: int = 12) -> dict:
    """HF BERT state dict -> flat '/'-joined Flax parameter names: the
    published names onto the encoder's (`minilm.bert_to_state`), then the
    Flax tree's (`minilm.flax_from_state`)."""
    from hcrag_tpu_torch.models.minilm import MiniLMConfig, bert_to_state, flax_from_state

    word = "embeddings.word_embeddings.weight"
    hidden = np.asarray(state[word] if word in state else state["bert." + word]).shape[1]
    cfg = MiniLMConfig(hidden_size=hidden, num_layers=num_layers, num_heads=num_heads)
    return flax_from_state(bert_to_state(state, cfg), cfg)


def num_layers_of(state: dict) -> int:
    """The count of `encoder.layer.{i}` blocks in an HF state dict."""
    pat = re.compile(r"(?:bert\.)?encoder\.layer\.(\d+)\.")
    return 1 + max(int(m.group(1)) for m in map(pat.match, state) if m)


def config_of(params: dict):
    """The `MiniLMConfig` whose encoder takes these converted weights (12
    heads, as `convert` splits them)."""
    from hcrag_tpu_torch.models.minilm import MiniLMConfig

    vocab, hidden = params["params/Embed_0/embedding"].shape
    layers = sum(k.endswith("/Dense_0/kernel") for k in params)
    return MiniLMConfig(
        vocab_size=vocab, hidden_size=hidden, num_layers=layers, num_heads=12,
        intermediate_size=params["params/TransformerLayer_0/Dense_0/kernel"].shape[1],
        max_position=params["params/Embed_1/embedding"].shape[0],
    )


def main(argv=None) -> dict:
    """Convert, write, and check the file on the device; returns the
    converted arrays."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("model_dir")
    ap.add_argument("out_path")
    ap.add_argument("--device", default=None,
                    help="torch device of the check (default: cuda; raises without CUDA)")
    args = ap.parse_args(argv)

    import torch

    from hcrag_tpu_torch.device import resolve_device
    from hcrag_tpu_torch.models.minilm import MiniLMEmbedder

    device = resolve_device(args.device)
    state = load_hf_state_dict(args.model_dir)
    params = convert(state, num_layers_of(state))
    np.savez(args.out_path, **params)
    print(f"wrote {len(params)} tensors -> {args.out_path}")
    cfg = config_of(params)
    emb = MiniLMEmbedder(cfg, device=device)
    emb.load_params(args.out_path)
    ids = torch.arange(min(8, cfg.vocab_size, cfg.max_position), device=device)[None]
    with torch.no_grad():
        probe = emb.model(ids, torch.ones_like(ids)).cpu().numpy()
    if not (np.isfinite(probe).all() and abs(float(np.linalg.norm(probe)) - 1.0) < 1e-4):
        raise RuntimeError(f"the converted encoder gave a bad embedding on {device}")
    print(f"loaded into MiniLMEncoder on {device}: one forward, unit norm")
    print("pair with WordPieceTokenizer(vocab.txt) for HF-compatible embeddings.")
    return params


if __name__ == "__main__":
    main()
