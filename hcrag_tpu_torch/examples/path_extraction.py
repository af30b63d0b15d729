"""Generic-ingestion property-graph extraction, end to end.

Counterpart of `examples/path_extraction.py`.  The reference's LlamaIndex
stack builds a property graph from any directory via LLM path extractors
(`python graph_builder.py`, graph_builder.py:419-513).  This demo runs the
port's equivalent offline: deterministic extraction, the CSR lowering, and
retrieval + expansion over the extracted graph on the card unless
`--device` names another device.

Run: python -m hcrag_tpu_torch.examples.path_extraction [data_dir] [--device cpu]
"""

import argparse

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("data_dir", nargs="?", default="data",
                    help="any corpus directory (default: ./data)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; without CUDA it raises)")
    args = ap.parse_args(argv)

    from hcrag_tpu_torch.ingest.path_extract import (
        PropertyGraphBuilder,
        build_graph_index,
    )
    from hcrag_tpu_torch.models.embedder import HashingEmbedder
    from hcrag_tpu_torch.query.engine import QueryEngine
    from hcrag_tpu_torch.query.graph_query import GraphQuery, execute_graph_query

    for mode in ("auto", "implicit"):
        builder = PropertyGraphBuilder(mode)
        store = builder.build(args.data_dir)
        stats = store.statistics()
        print(f"[{mode}] {stats['total_nodes']} nodes, "
              f"{stats['total_relationships']} relationships, "
              f"types: {list(stats['relationships_by_type'])[:8]}")

    # Retrieval + expansion over the extracted graph (the same kernels as
    # the hand-built AdventureWorks schema).
    store = PropertyGraphBuilder("auto").build(args.data_dir)
    index, csr, type_names = build_graph_index(store)
    texts = [store.node_text(n) for n in store.nodes()]
    embedder = HashingEmbedder().fit(texts)
    engine = QueryEngine(index, csr, embedder=embedder, device=args.device)

    out = engine.process_query("Mountain-100 Silver mountain bike",
                               top_k=5, similarity_threshold=0.0)
    print("\ntop entities for 'Mountain-100 Silver mountain bike':")
    for r in out["results"]:
        print(f"  [{r['similarity_score']:.3f}] {r['content'][:70]}")

    q = embedder.encode(["Mountain-100 Silver mountain bike"]).astype(np.float32)
    res = engine.query_batch(q, top_k=5, expansion_depth=1)
    print(f"expanded graph nodes: {int(np.asarray(res.expanded_counts)[0])}")

    # Graph-pattern query over the discovered relation vocabulary.
    hits = execute_graph_query(
        csr, GraphQuery(text_contains="mountain-100", edge_type="COLOR", limit=2)
    )
    for h in hits:
        rels = {n["relationship"] for n in h["neighbors"]}
        print(f"pattern hit: {h['text'][:50]} -> {len(h['neighbors'])} "
              f"neighbors via {sorted(rels)[:4]}")


if __name__ == "__main__":
    main()
