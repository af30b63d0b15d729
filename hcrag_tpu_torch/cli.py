"""Command-line interface: build, query, repl, agent, viz, stats.

Counterpart of `hcrag_tpu/cli.py`, with the same commands and output; the
engine runs on the card unless `--device cpu` is given (every command takes
`--device`, and without CUDA one that is not given raises).

It replaces the reference's script entry points:
  * `python experiments/knowledge_graph.py`  -> `build`
  * `python experiments/main.py --rag-only`  -> `query`
  * `query_interface.py` interactive REPL    -> `repl`
  * `demo_visualization.py`                  -> `viz`
  * LangGraph agent main                     -> `agent`

Usage:
  python -m hcrag_tpu_torch.cli build --data DIR [--out DIR] [--pickle PKL]
  python -m hcrag_tpu_torch.cli query "mountain bike" [--artifacts DIR] [--top-k 5]
  python -m hcrag_tpu_torch.cli repl [--artifacts DIR]
  python -m hcrag_tpu_torch.cli agent "What mountain bikes do you have?"
  python -m hcrag_tpu_torch.cli viz "mountain bike" --out viz.html
  python -m hcrag_tpu_torch.cli stats [--artifacts DIR]
  python -m hcrag_tpu_torch.cli extract-graph --data DIR --out DIR
  python -m hcrag_tpu_torch.cli graph-html [--artifacts DIR | --store JSON]

`--data` defaults to `data` and `--pickle` to
`experiments/knowledge_graph_embeddings.pkl` (where it exists), the
reference checkout's layout, relative to the working directory.
"""

from __future__ import annotations

import argparse
from pathlib import Path

DEFAULT_DATA = "data"
DEFAULT_PICKLE = "experiments/knowledge_graph_embeddings.pkl"


def _load_engine(args):
    from hcrag_tpu_torch.core.dense_index import DenseIndex
    from hcrag_tpu_torch.core.graph import CsrGraph
    from hcrag_tpu_torch.ingest.adventureworks import build_adventureworks
    from hcrag_tpu_torch.query.engine import QueryEngine

    artifacts = getattr(args, "artifacts", None)
    if artifacts and (Path(artifacts) / "dense_index.npz").exists():
        index = DenseIndex.load(artifacts)
        graph = (
            CsrGraph.load(artifacts)
            if (Path(artifacts) / "graph.npz").exists()
            else None
        )
    else:
        pickle_path = getattr(args, "pickle", None) or (
            DEFAULT_PICKLE if Path(DEFAULT_PICKLE).exists() else None
        )
        bundle = build_adventureworks(
            getattr(args, "data", DEFAULT_DATA), reference_pickle=pickle_path
        )
        index, graph = bundle.index, bundle.graph
    return QueryEngine(index, graph, device=args.device)


def cmd_build(args):
    from hcrag_tpu_torch.ingest.adventureworks import build_adventureworks

    bundle = build_adventureworks(args.data, reference_pickle=args.pickle)
    out = Path(args.out)
    bundle.index.save(out)
    bundle.graph.save(out)
    stats = bundle.graph.statistics()
    print(f"Index: {bundle.index.n} rows x {bundle.index.dim} dims -> {out}")
    print(f"Graph nodes: {stats['nodes']}")
    print(f"Graph relationships: {stats['relationships']}")


def cmd_query(args):
    engine = _load_engine(args)
    out = engine.process_query(
        args.query, top_k=args.top_k, similarity_threshold=args.threshold
    )
    print(out["summary"])
    for i, r in enumerate(out["results"], 1):
        print(f"{i}. [{r['similarity_score']:.3f}] {r['content'][:100]}")


def cmd_repl(args):
    from hcrag_tpu_torch.query.interface import QueryInterface

    engine = _load_engine(args)
    iface = QueryInterface(engine, top_k=args.top_k)
    print("hcrag interactive query REPL. Commands: ':quit', ':stats', ':suggest',")
    print("':filter <type>' (database_table/json_table/pdf_document), ':nofilter'")
    print("Prefix with 'mode:vector|keyword|context|default ' to pick a query")
    print("engine (otherwise keyword rules auto-select, like the reference).")
    category = None
    while True:
        try:
            line = input("query> ").strip()
        except (EOFError, KeyboardInterrupt):
            break
        if not line:
            continue
        if line in (":quit", ":q", "exit"):
            break
        if line == ":stats":
            print(engine.get_content_statistics())
            continue
        if line == ":suggest":
            for s in iface.suggest_queries():
                print(f"  - {s}")
            continue
        if line.startswith(":filter "):
            category = line.split(None, 1)[1]
            print(f"filtering to {category}")
            continue
        if line == ":nofilter":
            category = None
            continue
        # 'mode:<name> question' prefix (query_interface.py:431-436)
        mode = "auto"
        if line.startswith("mode:"):
            head, _, rest = line.partition(" ")
            mode = head[5:] or "auto"
            line = rest.strip()
            if not line:
                continue
        if category:
            out = engine.search_by_category(line, category, top_k=args.top_k)
            results = out["results"]
        else:
            res = iface.query(line, mode=mode)
            print(f"[{res['mode']} mode] {res['answer'][:300]}")
            results = res["metadata"].get("results", [])
        for i, r in enumerate(results, 1):
            print(f"{i}. [{r['similarity_score']:.3f}] {r['content'][:100]}")


def cmd_agent(args):
    from hcrag_tpu_torch.pipeline.agent import RetrievalAgent

    engine = _load_engine(args)
    agent = RetrievalAgent(engine)
    result = agent.run(args.query)
    print(f"Decision: {result.decision}")
    print(f"Nodes used: {len(result.final_relevant_nodes)}")
    print(f"Revisions: {result.revision_history}")
    print("-" * 40)
    print(result.final_answer)


#: The reference's canned demo queries (demo_visualization.py:68-93).
DEMO_QUERIES = [
    ("mountain bike components",
     "Find mountain bike parts and see how they're related", 8, 0.25),
    ("road bike frames",
     "Explore road bike frame products and their relationships", 6, 0.3),
    ("HL Road Frame Black",
     "Find a specific product and its similar items", 5, 0.2),
    ("bicycle handlebars",
     "Discover handlebar products and their connections", 7, 0.25),
]


def _viz_one(engine, query, top_k, threshold, out, open_browser):
    from hcrag_tpu_torch.viz.cytoscape import visualize_query_results

    results, path = visualize_query_results(
        engine, query, top_k=top_k, similarity_threshold=threshold,
        output_path=out,
    )
    print(results["summary"])
    if path is None:
        print("no results to visualize")
        return
    print(f"visualization: {path}")
    if open_browser:
        import webbrowser

        webbrowser.open(f"file://{Path(path).resolve()}")


def cmd_viz(args):
    engine = _load_engine(args)
    if args.query:
        _viz_one(engine, args.query, args.top_k, 0.0, args.out, args.open)
        return
    # Interactive demo loop with the reference's canned queries
    # (demo_visualization.py:68-93): numbered menu, custom entry, exit.
    while True:
        print("\nChoose a demo query:")
        for i, (q, desc, _, _) in enumerate(DEMO_QUERIES, 1):
            print(f'  {i}. "{q}" - {desc}')
        print(f"  {len(DEMO_QUERIES) + 1}. Enter your own query")
        print("  0. Exit")
        try:
            choice = input("> ").strip()
        except EOFError:
            return
        if choice == "0" or choice.lower() in ("q", "quit", "exit"):
            return
        if choice == str(len(DEMO_QUERIES) + 1):
            try:
                query = input("query> ").strip()
            except EOFError:
                return
            top_k, thr = args.top_k, 0.0
        elif choice.isdigit() and 1 <= int(choice) <= len(DEMO_QUERIES):
            query, _, top_k, thr = DEMO_QUERIES[int(choice) - 1]
        else:
            print("invalid choice")
            continue
        if query:
            _viz_one(engine, query, top_k, thr, args.out, args.open)


def cmd_graph_html(args):
    """Whole-graph HTML overview — `save_networkx_graph` analogue
    (graph_builder.py:545)."""
    from hcrag_tpu_torch.viz.cytoscape import save_graph_html

    if args.store:
        from hcrag_tpu_torch.core.property_graph import PropertyGraphStore

        graph = PropertyGraphStore.load(args.store)
        title = f"Property Graph ({args.store})"
    else:
        engine = _load_engine(args)
        if engine.graph is None:
            print("engine has no graph")
            return
        graph = engine.graph
        title = "Knowledge Graph"
    path = save_graph_html(
        graph, output_path=args.out or "kg.html", title=title,
        max_nodes=args.max_nodes,
    )
    print(f"graph overview: {path}")
    if args.open:
        import webbrowser

        webbrowser.open(f"file://{Path(path).resolve()}")


def cmd_extract_graph(args):
    """Generic LLM/heuristic path-extraction graph build over any directory
    (reference `python graph_builder.py` main, graph_builder.py:516-565)."""
    from hcrag_tpu_torch.ingest.path_extract import PropertyGraphBuilder

    builder = PropertyGraphBuilder(args.mode, link_sources=args.link_sources)
    store = builder.build(args.data)
    out = Path(args.out)
    store.save(out / "property_graph.json")
    stats = store.statistics()
    print(f"Extraction mode: {builder.extraction_mode} "
          f"({[type(e).__name__ for e in builder.extractors]})")
    print(f"Nodes: {stats['total_nodes']}  Relationships: {stats['total_relationships']}")
    print(f"Relationship types: {list(stats['relationships_by_type'])[:12]}")
    print(f"Graph saved to {out / 'property_graph.json'}")


def cmd_stats(args):
    engine = _load_engine(args)
    stats = engine.get_content_statistics()
    print(f"Total entries: {stats['total_entries']}")
    print(f"Dimensions: {stats['embedding_dimensions']}")
    print(f"Content types: {stats['content_types']}")
    print(f"Tables: {stats['database_tables']}")
    if engine.graph is not None:
        print(f"Graph: {engine.graph.statistics()}")


def main(argv=None):
    p = argparse.ArgumentParser(prog="hcrag-torch", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser("build", help="build index + graph artifacts")
    b.add_argument("--data", default=DEFAULT_DATA)
    b.add_argument("--out", default="artifacts")
    b.add_argument("--pickle", default=None,
                   help="reference embeddings pickle for bit-parity")
    b.add_argument("--device", default=None, help="cuda (default) or cpu")
    b.set_defaults(fn=cmd_build)

    eg = sub.add_parser(
        "extract-graph",
        help="LLM/heuristic path-extraction property graph over any directory",
    )
    eg.add_argument("--data", default=DEFAULT_DATA)
    eg.add_argument("--out", default="artifacts")
    eg.add_argument("--mode", default="auto",
                    choices=["auto", "simple", "dynamic", "implicit"])
    eg.add_argument("--link-sources", action="store_true")
    eg.add_argument("--device", default=None, help="cuda (default) or cpu")
    eg.set_defaults(fn=cmd_extract_graph)

    for name, fn in (
        ("query", cmd_query), ("repl", cmd_repl),
        ("agent", cmd_agent), ("viz", cmd_viz), ("stats", cmd_stats),
        ("graph-html", cmd_graph_html),
    ):
        s = sub.add_parser(name)
        if name in ("query", "agent"):
            s.add_argument("query")
        elif name == "viz":
            # no query -> the reference's interactive canned-query menu
            s.add_argument("query", nargs="?", default=None)
        s.add_argument("--artifacts", default=None)
        s.add_argument("--data", default=DEFAULT_DATA)
        s.add_argument("--pickle", default=None)
        s.add_argument("--top-k", type=int, default=5)
        s.add_argument("--threshold", type=float, default=0.3)
        s.add_argument("--device", default=None, help="cuda (default) or cpu")
        if name in ("viz", "graph-html"):
            s.add_argument("--out", default=None)
            s.add_argument("--open", action="store_true",
                           help="open the HTML in a browser (main.py:347-352)")
        if name == "graph-html":
            s.add_argument("--store", default=None,
                           help="path-extraction property_graph.json instead "
                                "of the engine graph")
            s.add_argument("--max-nodes", type=int, default=400)
        s.set_defaults(fn=fn)

    args = p.parse_args(argv)
    from hcrag_tpu_torch.device import resolve_device

    args.device = resolve_device(args.device)
    args.fn(args)


if __name__ == "__main__":
    main()
