"""End-to-end walkthrough: build -> query -> expand -> score -> agent.

Counterpart of `examples/end_to_end.py`: the reference's notebook flow
(notebooks/main.ipynb) as a script, on the card unless `--device` names
another device.

Run: python -m hcrag_tpu_torch.examples.end_to_end [data_dir] [--device cpu]
"""

import argparse

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("data_dir", nargs="?", default="data",
                    help="a corpus in the reference layout (default: ./data)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; without CUDA it raises)")
    args = ap.parse_args(argv)

    from hcrag_tpu_torch.ingest.adventureworks import build_adventureworks
    from hcrag_tpu_torch.pipeline.agent import RetrievalAgent
    from hcrag_tpu_torch.pipeline.enhanced import EnhancedRAG
    from hcrag_tpu_torch.pipeline.integration import GraphRelevanceScorer
    from hcrag_tpu_torch.query.engine import QueryEngine
    from hcrag_tpu_torch.query.executor import BatchedExecutor

    # 1. Offline build (graph + embeddings + cross-links)
    bundle = build_adventureworks(args.data_dir)
    print("graph:", bundle.graph.statistics()["nodes"])
    print("index:", bundle.index.n, "rows")

    # 2. Dense retrieval
    engine = QueryEngine(bundle.index, bundle.graph, device=args.device)
    out = engine.process_query("mountain bike", top_k=5,
                               similarity_threshold=0.1)
    print("\n[query]", out["summary"])
    for r in out["results"][:3]:
        print(f"  {r['similarity_score']:.3f} {r['content'][:70]}")

    # 3. Hybrid search with graph enrichment
    print("\n[hybrid search]")
    for item in engine.hybrid_search("mountain bike", limit=3):
        print(f"  {item['similarity_score']:.3f} product {item['name']} "
              f"related={item['related_products'][:2]}")

    # 4. Retrieval + expansion + multi-scorer analytics
    grs = GraphRelevanceScorer(engine)
    cmp = grs.compare_scorer_performance("mountain bike", top_k=5)
    print("\n[scorer comparison]")
    for name, stats in list(cmp["scorers"].items())[:4]:
        print(f"  {name:24s} top={stats['top_score']:.3f} "
              f"mean={stats['mean_score']:.3f}")

    # 5. Full RAG pipeline (offline LLM fallbacks)
    rag = EnhancedRAG(engine)
    resp = rag.query("mountain bike", top_k=5, similarity_threshold=0.05)
    print(f"\n[enhanced rag] intent={resp.metadata.get('query_intent')} "
          f"nodes={resp.metadata.get('nodes_used', 0)} "
          f"time={resp.processing_time:.2f}s")

    # 6. Agentic loop
    agent = RetrievalAgent(engine)
    result = agent.run("What mountain bikes do you have?")
    print(f"\n[agent] decision={result.decision} "
          f"final_nodes={len(result.final_relevant_nodes)}")

    # 7. Batched serving
    ex = BatchedExecutor(engine, batch_size=8, top_k=3)
    try:
        futs = [
            ex.submit(np.asarray(bundle.index.emb[i], np.float32))
            for i in range(16)
        ]
        done = [f.result(timeout=300) for f in futs]
        print(f"\n[executor] served {len(done)} requests in "
              f"{ex.batches_dispatched} device batches")
    finally:
        ex.shutdown()


if __name__ == "__main__":
    main()
