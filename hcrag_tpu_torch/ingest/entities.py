"""Keyword entity extraction and node-type mapping (host side).

Counterpart of the part of `hcrag_tpu/ingest/entities.py` that
`core/dense_index.py` and `QueryEngine.create_query_input` use.
"""

from __future__ import annotations

from typing import List

from hcrag_tpu_torch.core.types import QueryIntent

#: Fixed product vocabulary.
KEYWORD_VOCAB: List[str] = [
    "mountain bike", "road bike", "bike", "bicycle",
    "frame", "handlebar", "wheel", "tire", "brake",
    "gear", "pedal", "chain", "saddle", "helmet",
    "red", "black", "blue", "white", "green",
    "small", "medium", "large", "xl", "xs",
]

MAX_ENTITIES = 5


def extract_entities_from_content(content: str) -> List[str]:
    """Substring scan over the fixed vocabulary in declaration order; if
    nothing matches, the first 3 words longer than 2 characters."""
    content_lower = content.lower()
    found = [kw for kw in KEYWORD_VOCAB if kw in content_lower]
    if not found:
        words = content.split()[:3]
        found = [w.lower().strip(".,!?") for w in words if len(w) > 2]
    return found[:MAX_ENTITIES]


def metadata_node_type(metadata: dict) -> str:
    """Map an index row's metadata to a canonical node type: database rows
    split by table name, pdf/text documents are documents, json tables are
    specifications, anything else is unknown."""
    t = metadata.get("type")
    if t == "database_table":
        table = str(metadata.get("table_name", "unknown")).lower()
        if table == "product":
            return "product"
        if table in ("productcategory", "category"):
            return "category"
        return "specification"
    if t in ("pdf_document", "text_document"):
        return "document"
    if t == "json_table":
        return "specification"
    return "unknown"


def infer_query_intent(query: str) -> QueryIntent:
    """Keyword intent routing; product-search verbs take precedence, and
    product search is the default."""
    q = query.lower()
    if any(w in q for w in ("find", "search", "show", "get", "buy")):
        return QueryIntent.PRODUCT_SEARCH
    if any(w in q for w in ("manual", "document", "guide", "instructions")):
        return QueryIntent.DOCUMENT_REQUEST
    if any(w in q for w in ("help", "support", "problem", "issue", "fix")):
        return QueryIntent.TECHNICAL_SUPPORT
    if any(w in q for w in ("compare", "vs", "versus", "difference")):
        return QueryIntent.COMPARISON_REQUEST
    if any(w in q for w in ("spec", "specification", "details", "features")):
        return QueryIntent.SPECIFICATION_INQUIRY
    return QueryIntent.PRODUCT_SEARCH
