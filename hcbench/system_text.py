"""The system under test of the text kind: `hcrag_tpu_torch`'s engine with
the query encoder attached, set up from the seed's inputs.

The engine is the retrieval kind's (`hcbench/system.py`, the
configuration's bank, graph and `engine` block); the encoder is a
`MiniLMEmbedder` at the configuration's `encoder` widths with the
WordPiece tokenizer over the configuration's vocabulary, its weights handed
over under the published BertModel names (`load_bert_state`) and attached
with `attach_device_encoder`.  The encoder is built first, so that a
program without the text entry fails before the engine's build.  A step is
one call of `query_text_batch_device`; the ids and mask its tokenizer made
are kept beside its outputs, for the check.
"""

from __future__ import annotations

from typing import Dict

import torch

from hcbench import system
from hcbench.spec import ROOT

#: The prefix of the encoder's weights among a cell's inputs.
WEIGHTS = "minilm/"


class _KeepLast:
    """The program's tokenizer, remembering the last (ids, mask) it made."""

    def __init__(self, tokenizer):
        self.tokenizer, self.last = tokenizer, None

    def encode_batch(self, texts, max_len=0):
        self.last = self.tokenizer.encode_batch(texts, max_len=max_len)
        return self.last


class System:
    def __init__(self, config: Dict, inputs: Dict[str, torch.Tensor], device):
        from hcrag_tpu_torch.models.minilm import (MiniLMConfig, MiniLMEmbedder,
                                                   WordPieceTokenizer)

        enc = config["encoder"]
        cfg = MiniLMConfig(
            vocab_size=int(enc["vocab_size"]), hidden_size=int(enc["hidden_size"]),
            num_layers=int(enc["num_hidden_layers"]), num_heads=int(enc["num_attention_heads"]),
            intermediate_size=int(enc["intermediate_size"]),
            max_position=int(enc["max_position_embeddings"]),
            layer_norm_eps=float(enc["layer_norm_eps"]))
        max_len = int(config["max_len"])
        self.tokenizer = _KeepLast(WordPieceTokenizer(
            str(ROOT / config["tokenizer"]["vocab"]), max_len=max_len,
            lowercase=bool(config["tokenizer"]["lowercase"])))
        embedder = MiniLMEmbedder(cfg, tokenizer=self.tokenizer, max_len=max_len, device=device)
        embedder.load_bert_state({k[len(WEIGHTS):]: v for k, v in inputs.items()
                                  if k.startswith(WEIGHTS)})
        corpus = {k: v for k, v in inputs.items() if not k.startswith(WEIGHTS)}
        self.engine = system.System(config, corpus, device).engine
        self.engine.attach_device_encoder(embedder)
        self.config = config

    def native_tokenizer(self) -> bool:
        """Whether the program's tokenizer ran its native (C++) path."""
        return getattr(self.tokenizer.tokenizer, "_native", None) is not None

    def step(self, texts, traffic: Dict):
        """The whole query step on a batch of texts, without waiting for the
        device: (the step's outputs and the embeddings, ids, mask)."""
        out = self.engine.query_text_batch_device(
            texts, max_len=int(traffic["max_len"]), top_k=int(traffic["top_k"]),
            expansion_depth=int(traffic["depth"]), max_expanded=int(traffic["max_expanded"]))
        ids, mask = self.tokenizer.last
        return out, ids, mask
