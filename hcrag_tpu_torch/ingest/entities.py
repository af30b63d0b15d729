"""Keyword entity extraction and node-type mapping (host side).

Counterpart of the part of `hcrag_tpu/ingest/entities.py` that
`core/dense_index.py` uses.
"""

from __future__ import annotations

from typing import List

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
