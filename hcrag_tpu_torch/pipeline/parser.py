"""QueryParser — LLM structured entity extraction.

Counterpart of `hcrag_tpu/pipeline/parser.py`: extracts {product, document,
relationship} entities from a natural-language query through one structured
LLM call, and returns the reference's empty structure on any failure.
Offline it returns that structure at once.  Either way the result carries a
`search_text` passthrough, so retrieval downstream still works.  The
response models are the port's standard-library `_Model`s, with the JSON
schema pydantic gives the JAX package's.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, List, Optional

from hcrag_tpu_torch.pipeline.llm import (
    LLMClient,
    _list_of,
    _Model,
    _nullable,
    _optional_string,
    _string,
)


@dataclasses.dataclass
class ProductEntity(_Model):
    name: Optional[str] = None
    features: List[str] = dataclasses.field(default_factory=list)
    category: Optional[str] = None

    SCHEMA = {
        "properties": {
            "name": _nullable("Name"),
            "features": {"items": {"type": "string"}, "title": "Features", "type": "array"},
            "category": _nullable("Category"),
        },
        "title": "ProductEntity",
        "type": "object",
    }
    FIELDS = {"name": _optional_string, "features": _list_of(_string),
              "category": _optional_string}


@dataclasses.dataclass
class DocumentEntity(_Model):
    type: Optional[str] = None
    name: Optional[str] = None

    SCHEMA = {
        "properties": {"type": _nullable("Type"), "name": _nullable("Name")},
        "title": "DocumentEntity",
        "type": "object",
    }
    FIELDS = {"type": _optional_string, "name": _optional_string}


@dataclasses.dataclass
class RelationshipEntity(_Model):
    type: Optional[str] = None
    direction: Optional[str] = None

    SCHEMA = {
        "properties": {"type": _nullable("Type"),
                       "direction": _nullable("Direction")},
        "title": "RelationshipEntity",
        "type": "object",
    }
    FIELDS = {"type": _optional_string, "direction": _optional_string}


@dataclasses.dataclass
class QueryEntities(_Model):
    product: ProductEntity = dataclasses.field(default_factory=ProductEntity)
    document: DocumentEntity = dataclasses.field(default_factory=DocumentEntity)
    relationship: RelationshipEntity = dataclasses.field(default_factory=RelationshipEntity)

    SCHEMA = {
        "$defs": {
            "DocumentEntity": DocumentEntity.SCHEMA,
            "ProductEntity": ProductEntity.SCHEMA,
            "RelationshipEntity": RelationshipEntity.SCHEMA,
        },
        "properties": {
            "product": {"$ref": "#/$defs/ProductEntity"},
            "document": {"$ref": "#/$defs/DocumentEntity"},
            "relationship": {"$ref": "#/$defs/RelationshipEntity"},
        },
        "title": "QueryEntities",
        "type": "object",
    }
    FIELDS = {"product": ProductEntity.model_validate,
              "document": DocumentEntity.model_validate,
              "relationship": RelationshipEntity.model_validate}


_SYSTEM_PROMPT = """You are a query parser for a product knowledge graph system.
Your task is to extract relevant entities from user queries about products, documents, and relationships.

Extract the following entities:

1. Product: name (the main product name), features (color, size, material, ...), category
2. Document: type (manual, specification, guide, ...), name
3. Relationship: type (similar, compatible, related, ...), direction (incoming, outgoing, bidirectional)

Guidelines:
- If an entity is not present in the query, use null as the value
- Use English for all extracted values
- Be specific and accurate in entity extraction
- Consider synonyms and variations in product names
- Extract all relevant features mentioned in the query"""

EMPTY_RESULT: Dict[str, Any] = {
    "product": {"name": None, "features": [], "category": None},
    "document": {"type": None, "name": None},
    "relationship": {"type": None, "direction": None},
}


class QueryParser:
    def __init__(self, client: Optional[LLMClient] = None):
        self.client = client or LLMClient()

    def parse_query(self, query: str) -> Dict[str, Any]:
        """The structured parse plus `search_text`; the empty structure on
        any failure."""
        result = self.client.call(
            _SYSTEM_PROMPT, query, QueryEntities, fallback=False
        )
        if isinstance(result, QueryEntities):
            out = result.model_dump()
        else:
            out = copy.deepcopy(EMPTY_RESULT)
        out["search_text"] = query
        return out

    def parse_queries_batch(self, queries: List[str]) -> List[Dict[str, Any]]:
        return [self.parse_query(q) for q in queries]
