"""JSON annotation-table ingestion (embedding_generator.py:152-216).

Counterpart of `hcrag_tpu/ingest/json_ingest.py`: the same text and
metadata for the same file.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import List, Optional, Tuple


def flatten_json_to_text(json_obj, prefix: str = "") -> List[str]:
    """Recursive dotted-path flattening (embedding_generator.py:152-175)."""
    parts: List[str] = []
    if isinstance(json_obj, dict):
        for key, value in json_obj.items():
            p = f"{prefix}.{key}" if prefix else key
            if isinstance(value, (dict, list)):
                parts.extend(flatten_json_to_text(value, p))
            else:
                parts.append(f"{p}: {value}")
    elif isinstance(json_obj, list):
        for i, item in enumerate(json_obj):
            p = f"{prefix}[{i}]" if prefix else f"item_{i}"
            if isinstance(item, (dict, list)):
                parts.extend(flatten_json_to_text(item, p))
            else:
                parts.append(f"{p}: {item}")
    else:
        parts.append(f"{prefix}: {json_obj}" if prefix else str(json_obj))
    return parts


def process_json_table(
    json_path, parent_document: Optional[str] = None
) -> Tuple[str, dict]:
    """JSON file -> (text, metadata) (embedding_generator.py:177-213).

    Text format: "Document: {ctx}. Contains structured information. " + first
    20 flattened parts joined with ". ".
    """
    json_path = Path(json_path)
    with open(json_path, "r", encoding="utf-8") as f:
        json_data = json.load(f)
    parts = flatten_json_to_text(json_data)
    filename = json_path.stem
    document_context = parent_document or filename
    full_text = (
        f"Document: {document_context}. Contains structured information. "
        + ". ".join(parts[:20])
    )
    metadata = {
        "id": f"json_{filename}",
        "type": "json_table",
        "filename": filename,
        "parent_document": parent_document,
        "source_file": str(json_path),
        "json_keys": list(json_data.keys()) if isinstance(json_data, dict) else [],
    }
    return full_text, metadata
