"""LLM path-extraction graph construction — the generic-ingestion stack.

Counterpart of `hcrag_tpu/ingest/path_extract.py`: the same extractors,
modes, store and `build_graph_index`.  Its structured LLM responses are
`pipeline/llm._Model` dataclasses instead of pydantic models (the port's
machines have no pydantic), with the same JSON schemas.

Rebuilds the reference's LlamaIndex extraction modes (graph_builder.py:419-451:
``SimpleLLMPathExtractor`` / ``DynamicLLMPathExtractor`` /
``ImplicitPathExtractor``, selected by ``EXTRACTION_MODE`` in
config.py:32,116) without LlamaIndex: each extractor is a small host-side
object with an LLM-structured path and a deterministic offline fallback
(the framework's standard degradation contract, SURVEY §5.3), feeding a
`PropertyGraphStore` whose device form is the same CSR/ELL layout as the
hand-built AdventureWorks graph.

Mode semantics (graph_builder.py:424-451):
  * ``auto``     -> Simple + Dynamic
  * ``simple``   -> Simple only
  * ``dynamic``  -> Dynamic only
  * ``implicit`` -> Implicit only
  * anything else defaults to Simple (the reference's final fallback)

Offline fallbacks are real extraction, not stubs: the corpus's smart-text
rows ("Table: X. Key: value. Key: value") parse into (subject, KEY, value)
paths; prose chunks go through a subject-verb-object heuristic over a fixed
relation verb table.  This keeps graph construction deterministic and
testable with zero egress, the same way `batch_llm_judge`'s word-overlap
fallback keeps scoring alive (isRelevant.py:278-297).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Sequence, Tuple

from hcrag_tpu_torch.core.property_graph import (
    PropertyGraphStore,
    Triple,
    _norm_predicate,
)
from hcrag_tpu_torch.pipeline.llm import (
    _list_of,
    _Model,
    _model,
    _prop,
    _string,
)

#: graph_builder.py caps paths per chunk via config.MAX_PATHS_PER_CHUNK = 10
#: (config.py:65).
MAX_PATHS_PER_CHUNK = 10

#: Relation verbs for the prose SVO heuristic, most-specific first.
_RELATION_VERBS = [
    ("is made of", "MADE_OF"),
    ("is part of", "PART_OF"),
    ("is designed for", "DESIGNED_FOR"),
    ("is used for", "USED_FOR"),
    ("consists of", "CONSISTS_OF"),
    ("is compatible with", "COMPATIBLE_WITH"),
    ("comes with", "COMES_WITH"),
    ("includes", "INCLUDES"),
    ("contains", "CONTAINS"),
    ("provides", "PROVIDES"),
    ("supports", "SUPPORTS"),
    ("requires", "REQUIRES"),
    ("features", "FEATURES"),
    ("uses", "USES"),
    ("has", "HAS"),
    ("have", "HAS"),
    ("is", "IS_A"),
    ("are", "IS_A"),
]

_SENT_SPLIT = re.compile(r"(?<=[.!?])\s+")
_KV_SEGMENT = re.compile(r"^\s*([A-Za-z_][\w ]{0,40}?)\s*:\s*(.+?)\s*$")


@dataclasses.dataclass
class ExtractedTriple(_Model):
    subject: str
    predicate: str
    object: str
    subject_type: str = "entity"
    object_type: str = "entity"

    SCHEMA = {
        "properties": {
            "subject": {"title": "Subject", "type": "string"},
            "predicate": {"title": "Predicate", "type": "string"},
            "object": {"title": "Object", "type": "string"},
            "subject_type": {"default": "entity", "title": "Subject Type",
                             "type": "string"},
            "object_type": {"default": "entity", "title": "Object Type",
                            "type": "string"},
        },
        "required": ["subject", "predicate", "object"],
        "title": "ExtractedTriple",
        "type": "object",
    }
    FIELDS = {"subject": _string, "predicate": _string, "object": _string,
              "subject_type": _string, "object_type": _string}


@dataclasses.dataclass
class TriplesResponse(_Model):
    """Structured output for LLM path extraction (the shape LlamaIndex's
    SimpleLLMPathExtractor parses out of its triplet prompt)."""

    triples: List[ExtractedTriple]

    SCHEMA = {
        "$defs": {"ExtractedTriple": ExtractedTriple.SCHEMA},
        **_model("TriplesResponse", (
            "Structured output for LLM path extraction (the shape LlamaIndex's\n"
            "SimpleLLMPathExtractor parses out of its triplet prompt)."), {
            "triples": _prop("Triples", "array",
                             "Knowledge-graph triples found in the text",
                             items={"$ref": "#/$defs/ExtractedTriple"}),
        }),
    }
    FIELDS = {"triples": _list_of(ExtractedTriple.model_validate)}


@dataclasses.dataclass
class SchemaResponse(_Model):
    """Structured output for schema discovery (DynamicLLMPathExtractor's
    auto-discovered allowed entity/relation types)."""

    entity_types: List[str]
    relation_types: List[str]

    SCHEMA = _model("SchemaResponse", (
        "Structured output for schema discovery (DynamicLLMPathExtractor's\n"
        "auto-discovered allowed entity/relation types)."), {
        "entity_types": _prop("Entity Types", "array", "Allowed entity type labels",
                              items={"type": "string"}),
        "relation_types": _prop("Relation Types", "array",
                                "Allowed relation type names", items={"type": "string"}),
    })
    FIELDS = {"entity_types": _list_of(_string), "relation_types": _list_of(_string)}


def _clip(items: List[Triple], cap: int) -> List[Triple]:
    return items[:cap] if cap and cap > 0 else items


def _kv_segments(text: str) -> List[Tuple[str, str]]:
    """Parse smart-text rows into (key, value) pairs.

    The corpus row format is "Table: X. Key: value. Key: value"
    (embedding_generator.py:63-104 / ingest/csv_ingest.py) — segments split
    on ". " with each holding one "Key: value".
    """
    pairs: List[Tuple[str, str]] = []
    for segment in re.split(r"\.\s+", text):
        m = _KV_SEGMENT.match(segment.rstrip("."))
        if m:
            value = m.group(2).strip()
            if value:
                pairs.append((m.group(1).strip(), value))
    return pairs


def _svo_candidates(text: str) -> List[Triple]:
    """Prose heuristic: split sentences, match relation verbs, take the
    clause before the verb as subject and after as object."""
    out: List[Triple] = []
    for sentence in _SENT_SPLIT.split(text):
        sentence = sentence.strip().rstrip(".")
        if len(sentence) < 8:
            continue
        low = sentence.lower()
        for verb, rel in _RELATION_VERBS:
            idx = low.find(f" {verb} ")
            if idx <= 0:
                continue
            subj = sentence[:idx].strip(" ,;")
            obj = sentence[idx + len(verb) + 2 :].strip(" ,;")
            # Keep noun-phrase-sized endpoints only; a 100-char clause is a
            # sentence, not an entity.
            subj = subj.split(",")[-1].strip()
            obj = obj.split(",")[0].strip()
            if 2 <= len(subj) <= 60 and 2 <= len(obj) <= 60:
                out.append(Triple(subject=subj, predicate=rel, object=obj))
            break
    return out


class SimplePathExtractor:
    """SimpleLLMPathExtractor analogue (graph_builder.py:428-434).

    LLM-first triplet extraction over any chunk, with a deterministic
    offline path: structured rows -> (subject, KEY, value); prose -> SVO
    heuristic.
    """

    name = "simple"

    def __init__(self, llm=None, max_paths_per_chunk: int = MAX_PATHS_PER_CHUNK):
        self.llm = llm
        self.max_paths_per_chunk = max_paths_per_chunk

    def extract(self, text: str, metadata: Optional[dict] = None) -> List[Triple]:
        source_id = (metadata or {}).get("id")
        if self.llm is not None and not self.llm.offline:
            resp = self.llm.call(
                "Extract knowledge-graph triples from the text. Return up to "
                f"{self.max_paths_per_chunk} (subject, predicate, object) triples "
                "naming concrete entities.",
                text[:4000],
                response_format=TriplesResponse,
                fallback=lambda: None,
            )
            if isinstance(resp, TriplesResponse):
                return _clip(
                    [
                        Triple(
                            subject=t.subject,
                            predicate=t.predicate,
                            object=t.object,
                            subject_type=t.subject_type or "entity",
                            object_type=t.object_type or "entity",
                            source_id=source_id,
                        )
                        for t in resp.triples
                    ],
                    self.max_paths_per_chunk,
                )
        return _clip(self._offline(text, metadata), self.max_paths_per_chunk)

    def _offline(self, text: str, metadata: Optional[dict]) -> List[Triple]:
        meta = metadata or {}
        source_id = meta.get("id")
        pairs = _kv_segments(text)
        if len(pairs) >= 2:
            # Structured row: subject = the name-like field, else the row id.
            subject = None
            subject_type = "entity"
            for key, value in pairs:
                if key.lower() in ("name", "title", "product", "document"):
                    subject = value
                    subject_type = key.lower()
                    break
            if subject is None:
                subject = str(meta.get("entity_id") or meta.get("id") or pairs[0][1])
            triples = []
            for key, value in pairs:
                if value == subject:
                    continue
                if len(value) > 80:  # long descriptions are chunk text, not entities
                    continue
                triples.append(
                    Triple(
                        subject=subject,
                        predicate=key,
                        object=value,
                        subject_type=subject_type,
                        source_id=source_id,
                    )
                )
            return triples
        out = _svo_candidates(text)
        return [
            Triple(
                subject=t.subject,
                predicate=t.predicate,
                object=t.object,
                source_id=source_id,
            )
            for t in out
        ]


class DynamicPathExtractor:
    """DynamicLLMPathExtractor analogue (graph_builder.py:436-443).

    Two-phase: discover an allowed schema (entity + relation types) from a
    corpus sample, then extract constrained to it.  Offline, the schema is
    frequency-derived from the sample's own key/verb usage; extraction drops
    any path whose relation falls outside the discovered schema — the
    defining behavior separating "dynamic" from "simple" mode.
    """

    name = "dynamic"

    def __init__(
        self,
        llm=None,
        max_paths_per_chunk: int = MAX_PATHS_PER_CHUNK,
        max_relation_types: int = 16,
        sample_size: int = 50,
    ):
        self.llm = llm
        self.max_paths_per_chunk = max_paths_per_chunk
        self.max_relation_types = max_relation_types
        self.sample_size = sample_size
        self.schema: Optional[List[str]] = None  # allowed relation types
        self._inner = SimplePathExtractor(llm, max_paths_per_chunk)

    def discover_schema(
        self, texts: Sequence[str], metadata: Optional[Sequence[dict]] = None
    ) -> List[str]:
        sample = list(texts[: self.sample_size])
        if self.llm is not None and not self.llm.offline:
            resp = self.llm.call(
                "From these document samples, propose a compact knowledge-graph "
                f"schema: at most {self.max_relation_types} relation types and "
                "the entity types they connect.",
                "\n---\n".join(s[:500] for s in sample[:20]),
                response_format=SchemaResponse,
                fallback=lambda: None,
            )
            if isinstance(resp, SchemaResponse) and resp.relation_types:
                self.schema = [
                    _norm_predicate(r)
                    for r in resp.relation_types[: self.max_relation_types]
                ]
                return self.schema
        # Offline discovery: run the simple extractor over the sample and
        # keep the most frequent relation types.
        freq: Dict[str, int] = {}
        for i, text in enumerate(sample):
            meta = metadata[i] if metadata is not None and i < len(metadata) else None
            for t in self._inner._offline(text, meta):
                p = _norm_predicate(t.predicate)
                freq[p] = freq.get(p, 0) + 1
        ranked = sorted(freq, key=lambda p: (-freq[p], p))
        self.schema = ranked[: self.max_relation_types]
        return self.schema

    def extract(self, text: str, metadata: Optional[dict] = None) -> List[Triple]:
        if self.schema is None:
            self.discover_schema([text], [metadata] if metadata else None)
        raw = self._inner.extract(text, metadata)
        allowed = set(self.schema or [])
        return _clip(
            [t for t in raw if _norm_predicate(t.predicate) in allowed],
            self.max_paths_per_chunk,
        )


class ImplicitPathExtractor:
    """ImplicitPathExtractor analogue (graph_builder.py:445-447).

    No LLM at all: relations implied by document structure, the way
    LlamaIndex derives SOURCE/PREV/NEXT from node relationships.  Emitted
    paths per corpus item (metadata schema from embedding_generator.py
    :131-146,:204-211,:344-353):

      * database_table row  -> (row entity, ROW_OF, table)
      * json_table          -> (file, ANNOTATES, parent document)
      * pdf/text chunk      -> (chunk, PART_OF, document) and
                               (prev chunk, NEXT, chunk)
    """

    name = "implicit"

    def __init__(self):
        self._prev_chunk: Dict[str, str] = {}  # document -> last chunk id seen

    def extract(self, text: str, metadata: Optional[dict] = None) -> List[Triple]:
        meta = metadata or {}
        source_id = meta.get("id")
        kind = meta.get("type")
        out: List[Triple] = []
        if kind == "database_table":
            entity = str(meta.get("entity_id") or meta.get("id"))
            out.append(
                Triple(
                    subject=entity,
                    predicate="ROW_OF",
                    object=str(meta.get("table_name")),
                    subject_type="row",
                    object_type="table",
                    source_id=source_id,
                )
            )
        elif kind == "json_table":
            parent = meta.get("parent_document")
            if parent:
                out.append(
                    Triple(
                        subject=str(meta.get("filename") or meta.get("id")),
                        predicate="ANNOTATES",
                        object=str(parent),
                        subject_type="annotation",
                        object_type="document",
                        source_id=source_id,
                    )
                )
        elif kind in ("pdf_document", "text_document"):
            doc = str(meta.get("document_name"))
            chunk = f"{doc} chunk {meta.get('chunk_index')}"
            out.append(
                Triple(
                    subject=chunk,
                    predicate="PART_OF",
                    object=doc,
                    subject_type="chunk",
                    object_type="document",
                    source_id=source_id,
                )
            )
            prev = self._prev_chunk.get(doc)
            if prev is not None:
                out.append(
                    Triple(
                        subject=prev,
                        predicate="NEXT",
                        object=chunk,
                        subject_type="chunk",
                        object_type="chunk",
                        source_id=source_id,
                    )
                )
            self._prev_chunk[doc] = chunk
        return out


def create_extractors(
    extraction_mode: str = "auto",
    llm=None,
    max_paths_per_chunk: int = MAX_PATHS_PER_CHUNK,
) -> List:
    """Mode -> extractor list, exactly graph_builder.py:419-451's selection:
    auto adds Simple and Dynamic; implicit is structural-only; an empty
    selection defaults to Simple."""
    extractors: List = []
    if extraction_mode in ("auto", "simple"):
        extractors.append(SimplePathExtractor(llm, max_paths_per_chunk))
    if extraction_mode in ("auto", "dynamic"):
        extractors.append(DynamicPathExtractor(llm, max_paths_per_chunk))
    if extraction_mode == "implicit":
        extractors.append(ImplicitPathExtractor())
    if not extractors:
        extractors.append(SimplePathExtractor(llm))
    return extractors


class PropertyGraphBuilder:
    """GraphBuilder analogue (graph_builder.py:121-513): ingest a directory,
    run the selected extractors over every chunk, return the property graph.

    ``link_sources=True`` additionally records (entity, MENTIONED_IN, chunk)
    paths so extracted entities stay joined to their originating chunks —
    LlamaIndex's entity->source-node MENTIONS links, which its retrievers
    rely on (query_interface.py:166-221 context mode).
    """

    VALID_MODES = ("auto", "simple", "dynamic", "implicit")

    def __init__(
        self,
        extraction_mode: str = "auto",
        llm=None,
        max_paths_per_chunk: int = MAX_PATHS_PER_CHUNK,
        link_sources: bool = False,
    ):
        if extraction_mode not in self.VALID_MODES:
            # config.validate_config flags invalid modes (config.py:116-117);
            # graph_builder itself then falls back to simple.
            extraction_mode = "simple"
        self.extraction_mode = extraction_mode
        self.llm = llm
        self.max_paths_per_chunk = max_paths_per_chunk
        self.link_sources = link_sources
        self.extractors = create_extractors(extraction_mode, llm, max_paths_per_chunk)

    def build_from_corpus(
        self, texts: Sequence[str], metadata: Sequence[dict]
    ) -> PropertyGraphStore:
        store = PropertyGraphStore()
        # Dynamic extractors discover their schema over the corpus sample
        # first (the "discovers schema automatically" contract,
        # graph_builder.py:437-439).
        for ex in self.extractors:
            if isinstance(ex, DynamicPathExtractor) and ex.schema is None:
                ex.discover_schema(texts, metadata)
        for text, meta in zip(texts, metadata):
            chunk_id = meta.get("id")
            for ex in self.extractors:
                for triple in ex.extract(text, meta):
                    inserted = store.upsert_triple(triple)
                    if inserted and self.link_sources and chunk_id:
                        store.upsert_triple(
                            Triple(
                                subject=triple.subject,
                                predicate="MENTIONED_IN",
                                object=str(chunk_id),
                                object_type="chunk",
                                source_id=chunk_id,
                            )
                        )
        return store

    def build(self, data_path, file_extensions=None) -> PropertyGraphStore:
        """Directory (or the whole corpus layout) -> PropertyGraphStore
        (graph_builder.py:453-501 build_graph)."""
        from hcrag_tpu_torch.ingest.adventureworks import process_corpus

        texts, metadata = process_corpus(data_path)
        if file_extensions:
            exts = {e.lower().lstrip(".") for e in file_extensions}
            keep = [
                i
                for i, m in enumerate(metadata)
                if _meta_extension(m) in exts
            ]
            texts = [texts[i] for i in keep]
            metadata = [metadata[i] for i in keep]
        if not texts:
            raise ValueError("No documents were successfully processed")
        return self.build_from_corpus(texts, metadata)


def _meta_extension(meta: dict) -> str:
    kind = meta.get("type")
    return {
        "database_table": "csv",
        "json_table": "json",
        "pdf_document": "pdf",
        "text_document": "txt",
    }.get(kind, "")


def build_graph_index(store: PropertyGraphStore, embedder=None):
    """Lower an extracted property graph to the retrieval-ready pair
    (DenseIndex over entity texts, CsrGraph adjacency) so generic-ingestion
    graphs run the same query/expansion stack as the AdventureWorks build.

    Returns (index, csr_graph, edge_type_names).
    """
    import numpy as np

    from hcrag_tpu_torch.core.dense_index import DenseIndex

    nodes = store.nodes()
    texts = [store.node_text(n) for n in nodes]
    metadata = [
        {"id": f"pg_{i}", "type": "graph_entity", "label": n.label, "name": n.name}
        for i, n in enumerate(nodes)
    ]
    if embedder is None:
        from hcrag_tpu_torch.models.embedder import HashingEmbedder

        embedder = HashingEmbedder().fit(texts)
    embeddings = np.asarray(embedder.encode(texts), dtype=np.float32)
    # Row i embeds entity node i: both directions of the row<->graph-node
    # link are the identity (the reference's embedding_index back-links,
    # knowledge_graph.py:264-327).
    index = DenseIndex.build(
        embeddings,
        metadata,
        texts,
        graph_ids=np.arange(len(nodes), dtype=np.int32),
    )
    csr, type_names = store.to_csr(
        node_to_row=np.arange(len(nodes), dtype=np.int32)
    )
    return index, csr, type_names
