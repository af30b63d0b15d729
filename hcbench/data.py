"""The cells' inputs, made from `--seed` on the device.

The same draws as the repository's synthetic corpus (`utils/synthetic.py`:
L2-normalized Gaussian rows, uniform node types, a few uniform entities a
row, `degree` random out-edges a node of the two expansion types), drawn by
one `torch.Generator` on the run's device in a few large calls instead of
numpy's chunks on the host.  The same seed and device give the same arrays;
the program and the reference get the same ones.  Draw order: the rows,
their types, their entities, the edges, then the traffic's queries, so the
data never depends on the traffic.
"""

from __future__ import annotations

from typing import Dict

import torch


def generator(seed: int, device: torch.device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def unit_rows(g: torch.Generator, n: int, d: int, device) -> torch.Tensor:
    """[n, d] f32 Gaussian rows scaled to unit L2 norm."""
    x = torch.randn((n, d), generator=g, device=device, dtype=torch.float32)
    return x / torch.linalg.vector_norm(x, dim=1, keepdim=True).clamp_min(1e-12)


def entity_words(ent: torch.Tensor, vocab: int):
    """Entity ids [n, e] in [0, vocab) -> (bitsets [n, vocab / 32] int64
    holding each uint32 word, bit i of word w being entity 32 w + i; the
    distinct entities of each row [n])."""
    n = ent.shape[0]
    onehot = torch.zeros((n, vocab), dtype=torch.bool, device=ent.device)
    onehot.scatter_(1, ent, True)
    shifts = torch.arange(32, device=ent.device, dtype=torch.int64)
    words = [
        (onehot[:, 32 * w:32 * (w + 1)].to(torch.int64) << shifts).sum(dim=1)
        for w in range(vocab // 32)
    ]
    return torch.stack(words, dim=1), onehot.sum(dim=1)


def make_corpus(config: Dict, g: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """The deployment's rows and graph on `device`: emb [N, D] f32 unit
    rows, type_ids [N], bits [N, W] (uint32 words in int64), counts [N],
    and the directed edge list src, dst [N * degree] with etype an index
    into `config["graph"]["edge_types"]`."""
    n, d = int(config["rows"]), int(config["dim"])
    c, gr = config["corpus"], config["graph"]
    emb = unit_rows(g, n, d, device)
    type_ids = torch.randint(0, int(c["node_types"]), (n,), generator=g, device=device)
    ent = torch.randint(0, int(c["entity_vocab"]), (n, int(c["entities_per_row"])),
                        generator=g, device=device)
    bits, counts = entity_words(ent, int(c["entity_vocab"]))
    deg = int(gr["degree"])
    src = torch.arange(n, device=device, dtype=torch.int64).repeat_interleave(deg)
    dst = torch.randint(0, n, (n * deg,), generator=g, device=device)
    etype = torch.randint(0, len(gr["edge_types"]), (n * deg,), generator=g, device=device)
    return dict(emb=emb, type_ids=type_ids, bits=bits, counts=counts,
                src=src, dst=dst, etype=etype)

