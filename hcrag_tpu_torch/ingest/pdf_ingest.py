"""PDF text extraction + chunking.

Counterpart of `hcrag_tpu/ingest/pdf_ingest.py`, the same chain and
chunks; neither pdfplumber nor pypdf is installed where the port runs, so
the route taken is the built-in `minipdf`, then the literal-string scrape,
then the placeholder.

The reference extracts PDF text with pdfplumber, falling back to PyPDF2 and
then to a placeholder string (embedding_generator.py:218-276).  Neither
library is available in this environment, so the extraction chain here is:

  1. pdfplumber (if importable)
  2. pypdf / PyPDF2 (if importable)
  3. a built-in minimal extractor: walks the PDF's cross-referenced objects,
     zlib-inflates Flate-compressed content streams and pulls the literal
     strings out of Tj/TJ show-text operators — sufficient for the
     generated product PDFs in the AdventureWorks corpus
  4. the reference's placeholder string (embedding_generator.py:272-274)

Chunking replicates `chunk_text` exactly (embedding_generator.py:278-305):
sentence-boundary-seeking windows of `max_chunk_size` with `overlap`.
"""

from __future__ import annotations

import re
import zlib
from pathlib import Path
from typing import List, Tuple

_STREAM_RE = re.compile(rb"stream\r?\n(.*?)endstream", re.DOTALL)
# Literal strings inside show-text operators: (..) Tj  or  [(..) .. (..)] TJ
_TJ_RE = re.compile(rb"\((?:\\.|[^()\\])*\)\s*Tj|\[(?:[^\[\]]*)\]\s*TJ")
_LITERAL_RE = re.compile(rb"\((?:\\.|[^()\\])*\)")

_PDF_ESCAPES = {
    b"n": b"\n", b"r": b"\r", b"t": b"\t", b"b": b"\b", b"f": b"\f",
    b"(": b"(", b")": b")", b"\\": b"\\",
}


def _decode_pdf_string(raw: bytes) -> str:
    """Decode a PDF literal string body (escapes + octal sequences)."""
    out = bytearray()
    i = 0
    while i < len(raw):
        c = raw[i : i + 1]
        if c == b"\\" and i + 1 < len(raw):
            nxt = raw[i + 1 : i + 2]
            if nxt.isdigit():
                octal = raw[i + 1 : i + 4]
                j = 0
                while j < len(octal) and chr(octal[j]).isdigit():
                    j += 1
                out.append(int(octal[:j], 8) & 0xFF)
                i += 1 + j
                continue
            out.extend(_PDF_ESCAPES.get(nxt, nxt))
            i += 2
            continue
        out.extend(c)
        i += 1
    return out.decode("latin-1", errors="replace")


def _extract_builtin(pdf_bytes: bytes) -> str:
    """Minimal content-stream text extraction (Flate streams, Tj/TJ ops)."""
    texts: List[str] = []
    for m in _STREAM_RE.finditer(pdf_bytes):
        data = m.group(1)
        try:
            data = zlib.decompress(data)
        except zlib.error:
            pass  # uncompressed stream
        if b"Tj" not in data and b"TJ" not in data:
            continue
        line_parts: List[str] = []
        for op in _TJ_RE.finditer(data):
            for lit in _LITERAL_RE.finditer(op.group(0)):
                s = _decode_pdf_string(lit.group(0)[1:-1])
                if s:
                    line_parts.append(s)
        if line_parts:
            texts.append(" ".join(line_parts))
    return "\n".join(texts)


def extract_text_from_pdf(pdf_path) -> str:
    """Best-effort extraction with the reference's fallback-chain shape."""
    pdf_path = Path(pdf_path)
    # Preferred: pdfplumber (page text, cleaned), as the reference does.
    try:
        import pdfplumber  # type: ignore

        chunks = []
        with pdfplumber.open(pdf_path) as pdf:
            for page_num, page in enumerate(pdf.pages):
                t = page.extract_text()
                if t and t.strip():
                    chunks.append(f"Page {page_num + 1}: {' '.join(t.split())}")
        if chunks:
            return "\n".join(chunks)
    except ImportError:
        pass
    except Exception:
        pass
    # Fallback: pypdf / PyPDF2.
    for mod_name in ("pypdf", "PyPDF2"):
        try:
            mod = __import__(mod_name)
            reader = mod.PdfReader(str(pdf_path))
            chunks = []
            for page_num, page in enumerate(reader.pages):
                t = page.extract_text()
                if t and t.strip():
                    chunks.append(f"Page {page_num + 1}: {t.strip()}")
            if chunks:
                return "\n".join(chunks)
        except ImportError:
            continue
        except Exception:
            continue
    # Built-in minimal extractor (handles Type0/ToUnicode composite fonts).
    try:
        from hcrag_tpu_torch.ingest import minipdf

        text = minipdf.extract_text(pdf_path.read_bytes())
        if text.strip():
            return text
    except Exception:
        pass
    # Last-resort literal-string scrape.
    try:
        text = _extract_builtin(pdf_path.read_bytes())
        if text.strip():
            return text
    except Exception:
        pass
    # Placeholder (embedding_generator.py:272-274).
    return (
        f"PDF Document: {pdf_path.stem}. Text extraction failed - "
        "may be image-based PDF or corrupted."
    )


def chunk_text(text: str, max_chunk_size: int = 1000, overlap: int = 100) -> List[str]:
    """Sentence-boundary-seeking chunker (embedding_generator.py:278-305)."""
    if len(text) <= max_chunk_size:
        return [text]
    chunks: List[str] = []
    start = 0
    while start < len(text):
        end = start + max_chunk_size
        if end < len(text):
            for i in range(end, max(start + max_chunk_size // 2, end - 200), -1):
                if text[i] in ".!?":
                    end = i + 1
                    break
        chunk = text[start:end].strip()
        if chunk:
            chunks.append(chunk)
        start = end - overlap
        if start >= len(text):
            break
    return chunks


def process_pdf_document(
    pdf_path, document_name: str | None = None
) -> Tuple[List[str], List[dict]]:
    """PDF -> per-chunk (texts, metadata) (embedding_generator.py:307-364).

    Chunk size 800 / overlap 100 with a "PDF Document: {name}. " context
    prefix, metadata schema identical to the reference.
    """
    pdf_path = Path(pdf_path)
    full_text = extract_text_from_pdf(pdf_path)
    if not full_text.strip():
        return [], []
    doc_name = document_name or pdf_path.stem
    document_context = f"PDF Document: {doc_name}. "
    text_chunks = chunk_text(full_text, max_chunk_size=800, overlap=100)
    texts: List[str] = []
    metadata: List[dict] = []
    file_size = pdf_path.stat().st_size if pdf_path.exists() else 0
    for chunk_idx, chunk in enumerate(text_chunks):
        texts.append(document_context + chunk)
        metadata.append(
            {
                "id": f"pdf_{doc_name}_chunk_{chunk_idx}",
                "type": "pdf_document",
                "document_name": doc_name,
                "source_file": str(pdf_path),
                "chunk_index": chunk_idx,
                "total_chunks": len(text_chunks),
                "text_length": len(chunk),
                "file_size": file_size,
            }
        )
    return texts, metadata
