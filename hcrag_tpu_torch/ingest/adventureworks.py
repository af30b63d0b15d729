"""AdventureWorks corpus loaders + property-graph construction.

Counterpart of `hcrag_tpu/ingest/adventureworks.py`, on the standard
library's `csv` and numpy (`ingest/csv_ingest.read_table` types the tables
as pandas does): for the same corpus directory the texts, metadata, graph
arrays (`row_ptr`, `col_idx`, `edge_type`, in the same edge order), links
and embeddings are equal to the JAX package's.  The pair rules below are
vectorized over the p x p product grid in host memory (p products).

The JAX module is the rebuild of the reference's offline build stack
(SURVEY §3.1):

  * `load_csv_data` / `analyze_ingested_documents`
    (knowledge_graph.py:514-559) — file loading and PDF/annotation grouping.
  * `KnowledgeGraphBuilder.create_*` (knowledge_graph.py:73-421) — node and
    relationship construction.  The per-row Cypher CREATE loops become
    vectorized NumPy rules emitting an edge list; the resulting `CsrGraph` is
    behaviorally equivalent to the Neo4j graph for all query paths.
  * `DynamicEmbeddingGenerator.process_all_data` (embedding_generator.py:366)
    — corpus -> (texts, metadata); embedding happens in ONE batched call.
  * `update_nodes_with_embedding_info` (knowledge_graph.py:264-327) — the
    embedding-row <-> graph-node cross-links, here as int32 arrays in both
    directions instead of per-row Cypher SETs.

Edge rules (value-identical, knowledge_graph.py:347-421):
  SAME_CATEGORY          equal non-null category_id, p1 != p2
  SAME_MODEL             equal non-null model_id, p1 != p2
  SIMILAR_PRICE          both prices > 0 and |p1-p2| / p1 <= 0.20  (asymmetric!)
  COMPATIBLE_PRODUCT     both names contain 'Road Frame'; both contain 'Mountain'
  COMPLEMENTARY_PRODUCT  Helmet->Jersey; Frame->Handlebars
  DESCRIBED_BY           product<->document name containment, plus the
                         Mountain/Handlebars/Jersey keyword bridges
  ANNOTATION             annotation -> document (side-file grouping)
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from hcrag_tpu_torch.core.dense_index import DenseIndex
from hcrag_tpu_torch.core.graph import CsrGraph
from hcrag_tpu_torch.core.types import edge_type_id
from hcrag_tpu_torch.ingest.csv_ingest import Table, is_na, process_csv_table, read_table
from hcrag_tpu_torch.ingest.json_ingest import process_json_table
from hcrag_tpu_torch.ingest.pdf_ingest import process_pdf_document


def load_csv_data(data_dir) -> Dict[str, Table]:
    """The four graph-relevant CSVs (knowledge_graph.py:514-526)."""
    data_path = Path(data_dir)
    return {
        "products": read_table(data_path / "Product.csv", sep=";"),
        "categories": read_table(data_path / "ProductCategory.csv", sep=";"),
        "descriptions": read_table(data_path / "ProductDescription.csv", sep=";"),
        "models": read_table(data_path / "ProductModel.csv", sep=";"),
    }


def analyze_ingested_documents(data_dir) -> Dict[str, Dict]:
    """Group PDFs with their ' Fig N'/' Table N' side files
    (knowledge_graph.py:528-559)."""
    docs_path = Path(data_dir) / "IngestedDocuments"
    documents: Dict[str, Dict] = {}
    if not docs_path.exists():
        return documents
    for file in sorted(docs_path.glob("*")):
        name = file.name
        if name.endswith(".pdf"):
            base = name[: -len(".pdf")]
            documents.setdefault(base, {"pdf": None, "annotations": []})
            documents[base]["pdf"] = file
        elif name.endswith(".jpg"):
            base = name[: -len(".jpg")]
            if " Fig " in base:
                base = base.split(" Fig ")[0]
            documents.setdefault(base, {"pdf": None, "annotations": []})
            documents[base]["annotations"].append(file)
        elif name.endswith(".json"):
            base = name[: -len(".json")]
            if " Table " in base:
                base = base.split(" Table ")[0]
            documents.setdefault(base, {"pdf": None, "annotations": []})
            documents[base]["annotations"].append(file)
    return documents


def _parse_price(value) -> float:
    """European decimal-comma price parsing (knowledge_graph.py:126-134)."""
    if is_na(value):
        return 0.0
    try:
        return float(str(value).replace(",", "."))
    except ValueError:
        return 0.0


@dataclasses.dataclass
class GraphNodes:
    """Intermediate host-side node table before CSR assembly."""

    labels: List[str] = dataclasses.field(default_factory=list)
    keys: List = dataclasses.field(default_factory=list)
    texts: List[str] = dataclasses.field(default_factory=list)

    def add(self, label: str, key, text: str) -> int:
        self.labels.append(label)
        self.keys.append(key)
        self.texts.append(text)
        return len(self.labels) - 1


def _product_text(row: Dict[str, object], category_name: str) -> str:
    """Node text assembled the way the agent pipeline renders Neo4j product
    nodes (neo4j_rag_langgraph.py:352-373): name | Category | Price | Color."""
    parts = [str(row["Name"])]
    if category_name and category_name != "Unknown":
        parts.append(f"Category: {category_name}")
    price = _parse_price(row.get("ListPrice"))
    if price:
        parts.append(f"Price: ${price}")
    color = row.get("Color")
    if not is_na(color) and str(color):
        parts.append(f"Color: {color}")
    return " | ".join(parts)


def build_graph(
    csv_data: Dict[str, Table],
    document_structure: Dict[str, Dict],
) -> CsrGraph:
    """Construct the property graph (nodes + all 7 edge rules)."""
    products = csv_data["products"]
    categories = csv_data["categories"]
    models = csv_data["models"]

    cat_names = dict(
        zip(
            (int(v) for v in categories["ProductCategoryID"]),
            (v if is_na(v) else str(v) for v in categories["Name"]),
        )
    )

    nodes = GraphNodes()
    product_node: Dict[int, int] = {}
    category_node: Dict[int, int] = {}
    document_node: Dict[str, int] = {}  # by document_name (pdf stem)
    annotation_node: Dict[str, int] = {}  # by filename (with extension)

    # --- Product nodes (knowledge_graph.py:73-165) --------------------------
    prod_ids: List[int] = []
    prod_cat: List[int] = []  # -1 for null
    prod_model: List[int] = []
    prod_price: List[float] = []
    prod_name: List[str] = []
    for _, row in products.rows():
        pid = int(row["ProductID"])
        cat_id = (
            int(row["ProductCategoryID"])
            if not is_na(row.get("ProductCategoryID"))
            else -1
        )
        model_id = (
            int(row["ProductModelID"]) if not is_na(row.get("ProductModelID")) else -1
        )
        category_name = cat_names.get(cat_id, "Unknown")
        nid = nodes.add("Product", pid, _product_text(row, category_name))
        product_node[pid] = nid
        prod_ids.append(pid)
        prod_cat.append(cat_id)
        prod_model.append(model_id)
        prod_price.append(_parse_price(row.get("ListPrice")))
        prod_name.append(str(row["Name"]))

    # --- Category nodes (MERGEd during the embedding-link pass in the
    # reference, knowledge_graph.py:293-307) --------------------------------
    for _, row in categories.rows():
        cid = int(row["ProductCategoryID"])
        category_node[cid] = nodes.add("Category", cid, str(row["Name"]))

    # --- Document + Annotation nodes (knowledge_graph.py:167-245) ----------
    doc_names: List[str] = []
    for doc_name, doc_data in document_structure.items():
        if not doc_data["pdf"]:
            continue
        pdf_file = doc_data["pdf"]
        document_node[doc_name] = nodes.add("Document", pdf_file.name, doc_name)
        doc_names.append(doc_name)
        for annotation_file in doc_data["annotations"]:
            annotation_node[annotation_file.name] = nodes.add(
                "Annotation", annotation_file.name, annotation_file.stem
            )

    num_nodes = len(nodes.labels)
    src: List[int] = []
    dst: List[int] = []
    ety: List[int] = []

    def add_edges(s_arr, d_arr, type_name: str) -> None:
        et = edge_type_id(type_name)
        for s, d in zip(s_arr, d_arr):
            src.append(int(s))
            dst.append(int(d))
            ety.append(et)

    p = len(prod_ids)
    pids = np.arange(p)
    cat_arr = np.asarray(prod_cat)
    model_arr = np.asarray(prod_model)
    price_arr = np.asarray(prod_price)
    name_arr = np.asarray(prod_name, dtype=object)
    node_of = np.array([product_node[i] for i in prod_ids])

    # SAME_CATEGORY / SAME_MODEL: ordered pairs with equal non-null ids
    # (knowledge_graph.py:349-365).  Vectorized over the p x p pair grid.
    ii, jj = np.meshgrid(pids, pids, indexing="ij")
    off_diag = ii != jj
    same_cat = off_diag & (cat_arr[ii] == cat_arr[jj]) & (cat_arr[ii] >= 0)
    add_edges(node_of[ii[same_cat]], node_of[jj[same_cat]], "SAME_CATEGORY")
    same_model = off_diag & (model_arr[ii] == model_arr[jj]) & (model_arr[ii] >= 0)
    add_edges(node_of[ii[same_model]], node_of[jj[same_model]], "SAME_MODEL")

    # SIMILAR_PRICE: |p1 - p2| / p1.list_price <= 0.20, both > 0 — note the
    # asymmetric p1 denominator (knowledge_graph.py:367-374).
    with np.errstate(divide="ignore", invalid="ignore"):
        rel = np.abs(price_arr[ii] - price_arr[jj]) / price_arr[ii]
    similar_price = (
        off_diag & (price_arr[ii] > 0) & (price_arr[jj] > 0) & (rel <= 0.20)
    )
    add_edges(node_of[ii[similar_price]], node_of[jj[similar_price]], "SIMILAR_PRICE")

    # Manual COMPATIBLE / COMPLEMENTARY rules (knowledge_graph.py:376-407).
    def name_contains(sub: str) -> np.ndarray:
        return np.array([sub in n for n in name_arr])

    manual_rules = [
        ("Road Frame", "Road Frame", "COMPATIBLE_PRODUCT"),
        ("Mountain", "Mountain", "COMPATIBLE_PRODUCT"),
        ("Helmet", "Jersey", "COMPLEMENTARY_PRODUCT"),
        ("Frame", "Handlebars", "COMPLEMENTARY_PRODUCT"),
    ]
    for sub1, sub2, rel_name in manual_rules:
        m1 = name_contains(sub1)
        m2 = name_contains(sub2)
        sel = m1[ii] & m2[jj] & off_diag
        add_edges(node_of[ii[sel]], node_of[jj[sel]], rel_name)

    # DESCRIBED_BY: product -> document name containment + keyword bridges
    # (knowledge_graph.py:409-421).
    for doc_name in doc_names:
        d_node = document_node[doc_name]
        for k in range(p):
            pn = prod_name[k]
            if (
                pn in doc_name
                or doc_name in pn
                or ("Mountain" in doc_name and "Mountain" in pn)
                or ("Handlebars" in doc_name and "Handlebars" in pn)
                or ("Jersey" in doc_name and "Jersey" in pn)
            ):
                src.append(node_of[k])
                dst.append(d_node)
                ety.append(edge_type_id("DESCRIBED_BY"))

    # ANNOTATION: annotation -> document (knowledge_graph.py:235-245).
    for doc_name, doc_data in document_structure.items():
        if not doc_data["pdf"]:
            continue
        d_node = document_node[doc_name]
        for annotation_file in doc_data["annotations"]:
            src.append(annotation_node[annotation_file.name])
            dst.append(d_node)
            ety.append(edge_type_id("ANNOTATION"))

    return CsrGraph.from_edges(
        num_nodes,
        np.asarray(src),
        np.asarray(dst),
        np.asarray(ety),
        node_labels=nodes.labels,
        node_keys=nodes.keys,
        node_texts=nodes.texts,
        symmetrize=True,
    )


# --- corpus -> (texts, metadata) -------------------------------------------

#: CSV order observed in the reference's shipped pickle artifact (the
#: reference uses non-deterministic `Path.glob` order,
#: embedding_generator.py:373; we pin the artifact's actual order so row ids
#: line up in parity tests).
REFERENCE_CSV_ORDER = [
    "Product",
    "SalesOrderHeader",
    "ProductDescription",
    "ProductCategory",
    "SalesOrderDetail",
    "ProductModelProductDescription",
    "ProductModel",
]


def process_corpus(
    data_dir, csv_order: Optional[Sequence[str]] = None
) -> Tuple[List[str], List[dict]]:
    """All CSVs + JSON tables + PDFs -> (texts, metadata)
    (embedding_generator.py:366-398)."""
    data_path = Path(data_dir)
    texts: List[str] = []
    metadata: List[dict] = []

    csv_files = {f.stem: f for f in data_path.glob("*.csv")}
    if csv_order is None:
        order = [s for s in REFERENCE_CSV_ORDER if s in csv_files]
        order += sorted(s for s in csv_files if s not in order)
    else:
        order = [s for s in csv_order if s in csv_files]
    for stem in order:
        t, m = process_csv_table(csv_files[stem])
        texts.extend(t)
        metadata.extend(m)

    json_dir = data_path / "IngestedDocuments"
    if json_dir.exists():
        for json_file in sorted(json_dir.glob("*.json")):
            parent = None
            if " Table " in json_file.stem:
                parent = json_file.stem.split(" Table ")[0]
            t, m = process_json_table(json_file, parent)
            texts.append(t)
            metadata.append(m)
        for pdf_file in sorted(json_dir.glob("*.pdf")):
            t, m = process_pdf_document(pdf_file, pdf_file.stem)
            texts.extend(t)
            metadata.extend(m)

    # Plain-text documents (.txt/.md), chunked like PDFs — generalizes the
    # corpus beyond the reference's three formats (its LlamaIndex stack
    # ingested arbitrary text via SimpleDirectoryReader,
    # graph_builder.py:163-201).
    from hcrag_tpu_torch.ingest.pdf_ingest import chunk_text

    for pattern in ("*.txt", "*.md"):
        candidates = sorted(data_path.glob(pattern))
        if json_dir.exists():
            candidates += sorted(json_dir.glob(pattern))
        for text_file in candidates:
            try:
                raw = text_file.read_text(encoding="utf-8", errors="replace")
            except OSError:
                continue
            if not raw.strip():
                continue
            doc_name = text_file.stem
            chunks = chunk_text(raw, max_chunk_size=800, overlap=100)
            for chunk_idx, chunk in enumerate(chunks):
                texts.append(f"Document: {doc_name}. {chunk}")
                metadata.append(
                    {
                        "id": f"text_{doc_name}_chunk_{chunk_idx}",
                        "type": "text_document",
                        "document_name": doc_name,
                        "source_file": str(text_file),
                        "chunk_index": chunk_idx,
                        "total_chunks": len(chunks),
                    }
                )
    return texts, metadata


# --- cross-linking (knowledge_graph.py:264-327) -----------------------------


def link_index_and_graph(
    metadata: Sequence[dict], graph: CsrGraph
) -> Tuple[np.ndarray, np.ndarray]:
    """Compute row->node and node->row links.

    Returns (graph_ids [N] int32, node_to_row [G] int32), the array analogue
    of the reference's ``embedding_index`` / ``embedding_id`` property writes.
    Like the reference, later writes win for many-to-one matches.
    """
    label_key_to_node: Dict[Tuple[str, str], int] = {
        (label, str(key)): i
        for i, (label, key) in enumerate(zip(graph.node_labels, graph.node_keys))
    }
    doc_by_name: Dict[str, int] = {
        graph.node_texts[i]: i
        for i, label in enumerate(graph.node_labels)
        if label == "Document"
    }
    ann_nodes = [
        (i, str(graph.node_keys[i]))
        for i, label in enumerate(graph.node_labels)
        if label == "Annotation"
    ]

    n = len(metadata)
    graph_ids = np.full(n, -1, dtype=np.int32)
    node_to_row = np.full(graph.num_nodes, -1, dtype=np.int32)

    for row, meta in enumerate(metadata):
        t = meta.get("type")
        if t == "database_table":
            table = meta.get("table_name")
            entity_id = meta.get("entity_id")
            if entity_id is None:
                continue
            if table == "Product":
                nid = label_key_to_node.get(("Product", str(entity_id)))
            elif table == "ProductCategory":
                nid = label_key_to_node.get(("Category", str(entity_id)))
            else:
                nid = None
            if nid is not None:
                graph_ids[row] = nid
                node_to_row[nid] = row
        elif t == "json_table":
            # Reference: a.filename CONTAINS base-name, so every annotation of
            # that document receives the link (knowledge_graph.py:309-323).
            filename = meta.get("filename", "")
            base = (
                filename.split(" Table ")[0] if " Table " in filename else filename
            )
            matched_primary = None
            for nid, key in ann_nodes:
                if base in key:
                    node_to_row[nid] = row
                    if key == f"{filename}.json":
                        matched_primary = nid
            if matched_primary is None:
                for nid, key in ann_nodes:
                    if key == f"{filename}.json":
                        matched_primary = nid
                        break
            if matched_primary is not None:
                graph_ids[row] = matched_primary
        elif t == "pdf_document":
            # Extension over the reference (which leaves Documents unlinked):
            # first chunk row becomes the document's embedding.
            doc = meta.get("document_name", "")
            nid = doc_by_name.get(doc)
            if nid is not None:
                graph_ids[row] = nid
                if node_to_row[nid] < 0:
                    node_to_row[nid] = row
    return graph_ids, node_to_row


# --- full build -------------------------------------------------------------


@dataclasses.dataclass
class AdventureWorksBundle:
    index: DenseIndex
    graph: CsrGraph


def build_adventureworks(
    data_dir,
    *,
    embed_fn: Optional[Callable[[List[str]], np.ndarray]] = None,
    reference_pickle: Optional[str] = None,
    dtype=np.float32,
) -> AdventureWorksBundle:
    """Offline index build (SURVEY §3.1) in one call.

    Embeddings come either from `reference_pickle` (bit-identical parity with
    the reference artifact) or from `embed_fn(texts) -> [N, D]` in a single
    batched call.
    """
    csv_data = load_csv_data(data_dir)
    doc_structure = analyze_ingested_documents(data_dir)
    graph = build_graph(csv_data, doc_structure)

    if reference_pickle is not None:
        import pickle

        with open(reference_pickle, "rb") as f:
            data = pickle.load(f)
        texts = data["texts"]
        metadata = data["metadata"]
        embeddings = np.asarray(data["embeddings"], dtype=np.float32)
        generation_info = data.get("generation_info", {})
    else:
        texts, metadata = process_corpus(data_dir)
        generation_info: Dict = {}
        if embed_fn is None:
            from hcrag_tpu_torch.models.embedder import HashingEmbedder, default_embedder

            embedder = default_embedder()
            if isinstance(embedder, HashingEmbedder):
                embedder.fit(texts)  # corpus IDF weighting
                generation_info["embedder_state"] = embedder.state_dict()
            embed_fn = embedder.encode
        embeddings = np.asarray(embed_fn(texts), dtype=np.float32)
        generation_info.update(
            {
                "model_name": getattr(embed_fn, "__qualname__", "custom"),
                "total_entries": len(texts),
                "embedding_dimension": int(embeddings.shape[1]),
            }
        )

    graph_ids, node_to_row = link_index_and_graph(metadata, graph)
    graph.node_to_row = node_to_row
    index = DenseIndex.build(
        embeddings,
        metadata,
        texts,
        graph_ids=graph_ids,
        dtype=dtype,
        generation_info=generation_info,
    )
    return AdventureWorksBundle(index=index, graph=graph)
