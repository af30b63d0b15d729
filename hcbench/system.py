"""The system under test: `hcrag_tpu_torch`, set up from the seed's inputs.

The benchmark hands the program the raw arrays (rows, node types, entity
bitsets, the edge list) through its own host structures (`DenseIndex`,
`CsrGraph.from_edges`) and builds a `QueryEngine` with the options the
configuration's `engine` block names.  Everything the engine derives (the
int8 or bf16 banks, the padded neighbor tables, the device copies) is the
program's work and counts as set-up.  The rows carry no metadata or text:
nothing on the timed path reads them.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


class System:
    def __init__(self, config: Dict, corpus: Dict[str, torch.Tensor], device):
        from hcrag_tpu_torch.core.dense_index import DenseIndex
        from hcrag_tpu_torch.core.graph import CsrGraph
        from hcrag_tpu_torch.core.types import edge_type_id
        from hcrag_tpu_torch.core.vocab import EntityVocab
        from hcrag_tpu_torch.query.engine import QueryEngine

        n = int(config["rows"])
        c, gr = config["corpus"], config["graph"]
        host = {k: v.cpu().numpy() for k, v in corpus.items()}
        rows = np.arange(n, dtype=np.int32)
        index = DenseIndex(
            emb=host["emb"],
            type_ids=host["type_ids"].astype(np.int32),
            entity_bits=host["bits"].astype(np.uint32),
            entity_counts=host["counts"].astype(np.int32),
            graph_ids=rows,
            metadata=[{}] * n,
            texts=[""] * n,
            vocab=EntityVocab({f"e{i}": i for i in range(int(c["entity_vocab"]))}),
        )
        type_ids = np.array([edge_type_id(t) for t in gr["edge_types"]], dtype=np.int8)
        graph = CsrGraph.from_edges(
            n, host["src"], host["dst"], type_ids[host["etype"]],
            node_labels=["Product"] * n, node_keys=range(n), node_texts=[""] * n,
            node_to_row=rows,
        )
        self.engine = QueryEngine(index, graph, ell_max_degree=int(gr["ell_max_degree"]),
                                  device=device, **config["engine"])

    def step(self, q: torch.Tensor, traffic: Dict):
        """The whole query step on a device batch, without waiting for it."""
        return self.engine.query_batch_device(
            q, top_k=int(traffic["top_k"]), expansion_depth=int(traffic["depth"]),
            max_expanded=int(traffic["max_expanded"]))
