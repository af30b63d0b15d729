"""The plain reference of the benchmark's deployments, in PyTorch.

It computes from the seed's raw inputs alone (rows, types, entities, the
edge list, the queries) what a deployment's configuration states:

  * the exact top-k rows of each query by cosine, ties to the lowest row,
    with the rows and queries in the precision the configuration states;
  * the composite relevance of the returned rows and its 0.7 / 0.3 blend
    with the similarity, with no query entities and intent 0;
  * the graph's padded neighbor tables: the edges symmetrized, a repeated
    (source, target, type) kept once at its first appearance, each node's
    edges in that order, the first M of every expansion type for the first
    hop and the first M `ANNOTATION` edges for the later ones;
  * the k-hop expansion of the returned rows in discovery order, each node
    kept at its first appearance, capped at `max_expanded`, and each
    expanded node's relevance.

It imports nothing of the program.  Dots are taken in float64 from the
rows and queries rounded as stated; the top-k candidates are found with a
float32 product (TF32 off) and then ranked by their float64 dots.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import torch

#: The precision one step below each stated one: the control's.
BELOW = {"f32": "bf16", "bf16": "fp8"}


def rounded(x: torch.Tensor, precision: str) -> torch.Tensor:
    """`x` (f32) rounded to `precision`, held as f32."""
    if precision == "f32":
        return x.to(torch.float32)
    if precision == "bf16":
        return x.to(torch.bfloat16).to(torch.float32)
    if precision == "fp8":
        return x.to(torch.float8_e4m3fn).to(torch.float32)
    raise ValueError(f"unknown precision {precision!r}")


def lowered(precision: Dict) -> Dict:
    """A configuration's `precision` block with every stated precision one
    step lower (the control's)."""
    return {stage: {part: BELOW[p] for part, p in parts.items()}
            for stage, parts in precision.items()}


@contextlib.contextmanager
def no_tf32():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def dots64(q: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """q [Q, d], rows [Q, m, d] -> [Q, m] float64 dots."""
    return torch.bmm(rows.to(torch.float64), q.to(torch.float64)[:, :, None])[..., 0]


def exact_top_k(q: torch.Tensor, rows: torch.Tensor, k: int, block: int = 1024,
                extra: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top k of `rows` [N, d] for each query of `q` [Q, d] by float64
    dot, ties to the lowest row: (values [Q, k] f64, rows [Q, k] int64).
    The k + `extra` best by a float32 product are ranked by float64 dots."""
    cand = min(k + extra, rows.shape[0])
    vals, idxs = [], []
    with no_tf32():
        for s in range(0, q.shape[0], block):
            qb = q[s:s + block]
            c = torch.topk(qb @ rows.T, cand, dim=1).indices
            c = torch.sort(c, dim=1).values  # lowest row first among ties
            exact = dots64(qb, rows[c])
            order = torch.sort(-exact, dim=1, stable=True).indices[:, :k]
            vals.append(torch.gather(exact, 1, order))
            idxs.append(torch.gather(c, 1, order))
    return torch.cat(vals), torch.cat(idxs)


def first_per_node(src: torch.Tensor, dst: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """The first m targets of each source node, in the order the edges come:
    [n, m] int64, -1 where a node has fewer."""
    order = torch.sort(src, stable=True).indices
    s, t = src[order], dst[order]
    deg = torch.bincount(s, minlength=n)
    start = torch.cumsum(deg, 0) - deg
    slot = torch.arange(s.shape[0], device=s.device) - start[s]
    keep = slot < m
    table = torch.full((n, m), -1, dtype=torch.int64, device=src.device)
    table[s[keep], slot[keep]] = t[keep]
    return table


def neighbor_tables(src, dst, etype, n: int, m: int, n_types: int,
                    later_type: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(first-hop table, later-hop table) [n, m] from the directed edges:
    symmetrized, each (source, target, type) kept at its first appearance
    in the list of the edges followed by their reversals; the later hops
    take only edges of type `later_type`."""
    s = torch.cat([src, dst])
    t = torch.cat([dst, src])
    e = torch.cat([etype, etype])
    key = (s * n + t) * n_types + e
    sk, perm = torch.sort(key, stable=True)
    first = torch.ones_like(sk, dtype=torch.bool)
    first[1:] = sk[1:] != sk[:-1]
    kept = torch.sort(perm[first]).values  # positions of first appearances, in order
    s, t, e = s[kept], t[kept], e[kept]
    later = e == later_type
    return first_per_node(s, t, n, m), first_per_node(s[later], t[later], n, m)


def expand(t1: torch.Tensor, t2: torch.Tensor, seeds: torch.Tensor, depth: int,
           max_nodes: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expand seeds [Q, k] (-1 = none) by `depth` hops, the first over t1
    and the others over t2, every frontier node expanded (repeats too).
    Returns (nodes [Q, max_nodes] int64 in discovery order, -1 padded;
    counts [Q]); each node is kept at its first appearance."""
    q = seeds.shape[0]
    frontier, hops = seeds, []
    for h in range(depth):
        table = t1 if h == 0 else t2
        nb = table[frontier.clamp(min=0)]
        nb[frontier < 0] = -1
        frontier = nb.reshape(q, -1)
        hops.append(frontier)
    cand = torch.cat(hops, dim=1)
    c = cand.shape[1]
    pos = torch.arange(c, device=cand.device)
    big = int(t1.shape[0])  # sorts after every node
    key = torch.where(cand >= 0, cand, big) * c + pos
    sk = torch.sort(key, dim=1).values
    ids, at = sk // c, sk % c
    first = torch.ones_like(ids, dtype=torch.bool)
    first[:, 1:] = ids[:, 1:] != ids[:, :-1]
    first &= ids < big
    keep = torch.zeros_like(first)
    keep.scatter_(1, at, first)
    rank = torch.cumsum(keep.to(torch.int64), dim=1) - 1
    keep &= rank < max_nodes
    out = torch.full((q, max_nodes + 1), -1, dtype=torch.int64, device=cand.device)
    out.scatter_(1, torch.where(keep, rank, max_nodes), torch.where(keep, cand, -1))
    return out[:, :max_nodes], keep.sum(dim=1)


def relevance(sim: torch.Tensor, types: torch.Tensor, counts: torch.Tensor,
              scoring: Dict) -> torch.Tensor:
    """The composite relevance with no query entities (entity match 0.5
    for a row without entities, else 0.1), no LLM-judge column and intent
    0's node-type priority, from the float64 similarity."""
    w = scoring["weights"]  # [semantic, llm judge, entity, node type]
    prio = torch.tensor(scoring["intent_priority"], dtype=torch.float64, device=sim.device)
    ent = torch.where(counts == 0, 0.5, 0.1).to(torch.float64)
    return w[0] * (sim + 1.0) * 0.5 + w[2] * ent + w[3] * prio[types]


class Reference:
    """The reference over one seed's corpus, on `device`: `retrieve`,
    `expansion` and the relevance above, at the configuration's precision
    or at another `precision` block (the control's)."""

    def __init__(self, config: Dict, corpus: Dict[str, torch.Tensor], device,
                 precision: Optional[Dict] = None):
        self.config = config
        self.precision = precision or config["precision"]
        self.device = device
        self.corpus = {k: v.to(device) for k, v in corpus.items()}
        self._tables = None
        self._rows: Dict[str, torch.Tensor] = {}

    def rows(self, stage: str) -> torch.Tensor:
        p = self.precision[stage]["rows"]
        if p not in self._rows:
            self._rows[p] = rounded(self.corpus["emb"], p)
        return self._rows[p]

    def queries(self, stage: str, q: torch.Tensor) -> torch.Tensor:
        return rounded(q.to(self.device), self.precision[stage]["queries"])

    def retrieve(self, q: torch.Tensor, k: int):
        """The exact top k of each query."""
        return exact_top_k(self.queries("scores", q), self.rows("scores"), k)

    def score_rows(self, q: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """Float64 similarity of each query with its rows idx [Q, m]."""
        n = self.corpus["emb"].shape[0]
        return dots64(self.queries("scores", q), self.rows("scores")[idx.clamp(0, n - 1)])

    def tables(self):
        if self._tables is None:
            gr = self.config["graph"]
            c = self.corpus
            self._tables = neighbor_tables(
                c["src"], c["dst"], c["etype"], c["emb"].shape[0],
                int(gr["ell_max_degree"]), len(gr["edge_types"]),
                gr["edge_types"].index(gr["later_hop_type"]))
        return self._tables

    def expansion(self, seeds: torch.Tensor, depth: int, max_nodes: int):
        t1, t2 = self.tables()
        return expand(t1, t2, seeds.to(self.device), depth, max_nodes)

    def expanded_relevance(self, q: torch.Tensor, nodes: torch.Tensor) -> torch.Tensor:
        """Relevance of expanded nodes [Q, E] (graph node i is row i; -1 =
        none, relevance 0) for the queries q [Q, d], in blocks of about
        2^20 nodes."""
        block = max(1, (1 << 20) // max(1, nodes.shape[1]))
        rows = self.rows("expanded")
        qx = self.queries("expanded", q)
        sc = self.config["scoring"]
        prio = torch.full_like(nodes, int(sc["graph_node_type"]))
        out = []
        for s in range(0, nodes.shape[0], block):
            nb = nodes[s:s + block].to(self.device)
            safe = nb.clamp(min=0)
            sim = dots64(qx[s:s + block], rows[safe])
            rel = relevance(sim, prio[s:s + block].to(self.device),
                            self.corpus["counts"][safe], sc)
            out.append(torch.where(nb >= 0, rel, 0.0))
        return torch.cat(out)
