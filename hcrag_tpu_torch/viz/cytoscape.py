"""Interactive subgraph visualization — Cytoscape.js HTML generation.

Counterpart of `hcrag_tpu/viz/cytoscape.py`: for the same engine result
and graph the page is byte-equal to the JAX package's.

Rebuild of `SubgraphVisualizer` (main.py:35-735): maps dense-search hits back
to property-graph nodes, collects their relationships (+ optional whitelisted
expansion), and renders a self-contained HTML page with similarity-driven
styling, click info panels, and a cose layout.  No server required — the
graph data is inlined as JSON; cytoscape.js loads from CDN exactly like the
reference's template (main.py:356+).
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

import numpy as np

from hcrag_tpu_torch.core.types import EDGE_TYPES
from hcrag_tpu_torch.ops.expand import expansion_edges_host


def extract_subgraph_from_results(
    engine,
    query_results: Dict,
    max_nodes: int = 10,
    expand_subgraph: bool = True,
    max_connected: int = 15,
) -> Dict[str, List]:
    """Search results -> viz-format {nodes, edges}.

    Mirrors `extract_subgraph_from_results` (main.py:64-169): each hit whose
    metadata maps to a graph node becomes a styled node with its similarity
    score; inter-node relationships are collected from the graph; expansion
    adds whitelisted connected nodes with similarity 0.0 and
    is_connected=True (depth 1, cap 15 — main.py:147-154).
    """
    graph = engine.graph
    index = engine.index
    nodes: List[Dict] = []
    edges: List[Dict] = []
    seen_nodes: Dict[int, str] = {}

    results = query_results.get("results", [])[:max_nodes]
    matched_graph_ids: List[int] = []
    for i, result in enumerate(results):
        meta = result["metadata"]
        row = index.row_of_metadata(meta)
        if row < 0:
            continue
        gid = int(index.graph_ids[row]) if graph is not None else -1
        node_id = f"result_{i}"
        label = (
            meta.get("id")
            or meta.get("document_name")
            or meta.get("filename")
            or f"row {row}"
        )
        node_type = (
            graph.node_labels[gid] if (graph is not None and gid >= 0) else "Unknown"
        )
        nodes.append(
            {
                "data": {
                    "id": node_id,
                    "label": str(label)[:50],
                    "type": node_type,
                    "similarity_score": float(result["similarity_score"]),
                    "is_connected": False,
                    "content": result["content"][:300],
                    "has_neo4j": gid >= 0,
                    "graph_id": gid,
                }
            }
        )
        if gid >= 0:
            seen_nodes[gid] = node_id
            matched_graph_ids.append(gid)

    if graph is not None:
        # Inter-result relationships (main.py:281-327, LIMIT 100).
        added = 0
        for gid, node_id in list(seen_nodes.items()):
            nbrs, types = graph.neighbors_of(gid)
            for nb, t in zip(nbrs, types):
                other = seen_nodes.get(int(nb))
                if other is None or added >= 100:
                    continue
                edge_id = f"{node_id}-{other}-{EDGE_TYPES[int(t)]}"
                if any(e["data"]["id"] == edge_id for e in edges):
                    continue
                edges.append(
                    {
                        "data": {
                            "id": edge_id,
                            "source": node_id,
                            "target": other,
                            "relationship": EDGE_TYPES[int(t)],
                            "is_expansion": False,
                        }
                    }
                )
                added += 1

        if expand_subgraph and matched_graph_ids:
            exp_edges = expansion_edges_host(
                graph, matched_graph_ids, max_nodes=max_connected
            )
            for src, dst, t in exp_edges:
                if dst not in seen_nodes:
                    conn_id = f"connected_{dst}"
                    seen_nodes[dst] = conn_id
                    nodes.append(
                        {
                            "data": {
                                "id": conn_id,
                                "label": str(graph.node_texts[dst])[:50],
                                "type": graph.node_labels[dst],
                                "similarity_score": 0.0,
                                "is_connected": True,
                                "content": graph.node_texts[dst][:300],
                                "has_neo4j": True,
                                "graph_id": dst,
                            }
                        }
                    )
                edge_id = (
                    f"{seen_nodes.get(src, src)}-{seen_nodes[dst]}-"
                    f"{EDGE_TYPES[int(t)]}"
                )
                if not any(e["data"]["id"] == edge_id for e in edges):
                    edges.append(
                        {
                            "data": {
                                "id": edge_id,
                                "source": seen_nodes.get(src, f"connected_{src}"),
                                "target": seen_nodes[dst],
                                "relationship": EDGE_TYPES[int(t)],
                                "is_expansion": True,
                            }
                        }
                    )

    return {"nodes": nodes, "edges": edges}


_HTML_TEMPLATE = """<!DOCTYPE html>
<html>
<head>
<meta charset="utf-8">
<title>{title}</title>
<script src="https://unpkg.com/cytoscape@3/dist/cytoscape.min.js"></script>
<style>
  body {{ font-family: sans-serif; margin: 0; display: flex; height: 100vh; }}
  #cy {{ flex: 1; }}
  #info {{ width: 320px; padding: 16px; border-left: 1px solid #ccc;
          overflow-y: auto; background: #fafafa; }}
  h2 {{ font-size: 16px; }}
  .score {{ color: #0a7; font-weight: bold; }}
</style>
</head>
<body>
<div id="cy"></div>
<div id="info"><h2>{title}</h2><p>Click a node for details.</p>
<div id="detail"></div></div>
<script>
const elements = {elements_json};
const cy = cytoscape({{
  container: document.getElementById('cy'),
  elements: elements,
  style: [
    {{ selector: 'node', style: {{
        'label': 'data(label)', 'font-size': '9px',
        'width': e => 20 + 40 * (e.data('similarity_score') || 0),
        'height': e => 20 + 40 * (e.data('similarity_score') || 0),
        'background-color': e => e.data('is_connected') ? '#bbb'
          : 'hsl(' + Math.round(120 * (e.data('similarity_score') || 0)) + ',70%,50%)',
        'border-width': 1, 'border-color': '#555'
    }} }},
    {{ selector: 'edge', style: {{
        'label': 'data(relationship)', 'font-size': '7px',
        'curve-style': 'bezier', 'target-arrow-shape': 'triangle',
        'line-color': e => e.data('is_expansion') ? '#e90' : '#99c',
        'width': 1.5
    }} }}
  ],
  layout: {{ name: 'cose', animate: false }}
}});
cy.on('tap', 'node', evt => {{
  const d = evt.target.data();
  document.getElementById('detail').innerHTML =
    '<h3>' + d.label + '</h3>' +
    '<p>Type: ' + d.type + '</p>' +
    '<p>Similarity: <span class="score">' +
      (d.similarity_score || 0).toFixed(3) + '</span></p>' +
    '<p>' + (d.content || '') + '</p>';
}});
</script>
</body>
</html>
"""


def generate_cytoscape_html(subgraph_data: Dict, title: str) -> str:
    elements = subgraph_data["nodes"] + subgraph_data["edges"]
    return _HTML_TEMPLATE.format(
        title=title, elements_json=json.dumps(elements)
    )


def save_graph_html(
    graph,
    output_path: str = "kg.html",
    title: str = "Knowledge Graph",
    max_nodes: int = 400,
) -> str:
    """Render the WHOLE graph store as an interactive HTML overview page —
    the `save_networkx_graph(name="./kg.html")` analogue
    (graph_builder.py:545): the reference renders the extracted property
    graph itself, not just query-result subgraphs.

    Accepts either a `CsrGraph` (the retrieval adjacency) or a
    `PropertyGraphStore` (path-extraction output; lowered through
    `to_csr()`).  Graphs larger than `max_nodes` show the highest-degree
    nodes with their induced edges (degree is the structural signal the
    layout needs; the cap keeps the cose layout interactive)."""
    if hasattr(graph, "to_csr"):  # PropertyGraphStore -> (CsrGraph, types)
        graph, _ = graph.to_csr()
    n = graph.num_nodes
    degree = np.diff(np.asarray(graph.row_ptr))
    keep = np.argsort(-degree, kind="stable")[:max_nodes]
    keep_set = set(keep.tolist())
    max_deg = max(1, int(degree[keep].max()) if len(keep) else 1)
    type_names = graph.type_names
    nodes = [
        {
            "data": {
                "id": f"n{i}",
                "label": str(graph.node_texts[i])[:50] or graph.node_labels[i],
                "type": graph.node_labels[i],
                # degree drives size/color through the shared template's
                # similarity channel (documented in the detail panel)
                "similarity_score": float(degree[i]) / max_deg,
                "content": (
                    f"degree: {int(degree[i])} | key: {graph.node_keys[i]} | "
                    + str(graph.node_texts[i])[:240]
                ),
            }
        }
        for i in keep
    ]
    edges = []
    seen_pairs = set()
    col = np.asarray(graph.col_idx)
    etype = np.asarray(graph.edge_type)
    rp = np.asarray(graph.row_ptr)
    for i in keep:
        for e in range(int(rp[i]), int(rp[i + 1])):
            j = int(col[e])
            if j not in keep_set:
                continue
            t = int(etype[e])
            key = (min(int(i), j), max(int(i), j), t)
            if key in seen_pairs:
                continue
            seen_pairs.add(key)
            edges.append(
                {
                    "data": {
                        "id": f"e{len(edges)}",
                        "source": f"n{int(i)}",
                        "target": f"n{j}",
                        "relationship": type_names[t],
                        "is_expansion": False,
                    }
                }
            )
    shown = len(nodes)
    page_title = title if shown == n else (
        f"{title} (top {shown} of {n} nodes by degree)"
    )
    html = generate_cytoscape_html({"nodes": nodes, "edges": edges}, page_title)
    with open(output_path, "w") as f:
        f.write(html)
    return output_path


def visualize_query_results(
    engine,
    query: str,
    top_k: int = 10,
    similarity_threshold: float = 0.3,
    title_suffix: str = "",
    output_path: Optional[str] = None,
    expand_subgraph: bool = True,
) -> Tuple[Dict, Optional[str]]:
    """End-to-end query -> subgraph HTML (main.py:928-978)."""
    query_results = engine.process_query(
        query, top_k=top_k, similarity_threshold=similarity_threshold
    )
    if not query_results["results"]:
        return query_results, None
    subgraph = extract_subgraph_from_results(
        engine, query_results, max_nodes=top_k, expand_subgraph=expand_subgraph
    )
    if not subgraph["nodes"]:
        return query_results, None
    title = f"Search Results: {query}"
    if title_suffix:
        title += f" - {title_suffix}"
    html = generate_cytoscape_html(subgraph, title)
    if output_path is None:
        output_path = f"subgraph_viz_{abs(hash(query)) % 10000}.html"
    with open(output_path, "w") as f:
        f.write(html)
    return query_results, output_path
