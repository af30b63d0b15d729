"""Minimal self-contained PDF text extractor.

Counterpart of `hcrag_tpu/ingest/minipdf.py`: the same text for the same
bytes.

The reference delegates PDF text extraction to pdfplumber / PyPDF2
(embedding_generator.py:218-276); neither ships in this environment, so the
framework carries its own extractor.  Scope: the common structure of
digitally-generated PDFs (Skia / Google Docs / reportlab):

  * classic cross-referenced objects (``N G obj ... endobj``)
  * Flate-compressed content streams
  * simple fonts (literal-string ``Tj``/``TJ``) and composite Type0 fonts
    (2-byte glyph codes + ``/ToUnicode`` CMap with bfchar/bfrange entries)
  * per-page ``/Resources /Font`` tables with ``Tf`` font tracking,
    inheriting resources from the parent ``/Pages`` node

Not supported (returns whatever it can): encrypted documents, object streams
(xref streams holding objects), Type3 fonts, vertical writing.
"""

from __future__ import annotations

import re
import zlib
from typing import Dict, List, Optional, Tuple

_OBJ_RE = re.compile(rb"(\d+)\s+(\d+)\s+obj\b(.*?)endobj", re.DOTALL)
_STREAM_RE = re.compile(rb"stream\r?\n(.*?)\s*endstream", re.DOTALL)
_REF_RE = re.compile(rb"(\d+)\s+\d+\s+R")
_BFCHAR_RE = re.compile(rb"beginbfchar(.*?)endbfchar", re.DOTALL)
_BFRANGE_RE = re.compile(rb"beginbfrange(.*?)endbfrange", re.DOTALL)
_HEX_RE = re.compile(rb"<([0-9A-Fa-f\s]*)>")

#: Standard Latin ligature expansion.  The reference's extraction stack
#: (pdfplumber/pdfminer, embedding_generator.py:239-257) yields the expanded
#: letter pairs where a font's ToUnicode maps a glyph to a U+FBxx ligature
#: codepoint; verified against the shipped pickle, whose six pdf_document
#: texts carry 'fi'/'fl'/'ffi' at every ligature site.  Expanding here keeps
#: byte parity for any consumer of the extractor.
_LIGATURES = {
    "ﬀ": "ff", "ﬁ": "fi", "ﬂ": "fl",
    "ﬃ": "ffi", "ﬄ": "ffl", "ﬅ": "st", "ﬆ": "st",
}
_LIGATURE_TRANS = str.maketrans(_LIGATURES)


def _dict_body(obj: bytes) -> bytes:
    """The top-level << ... >> dictionary of an object body."""
    start = obj.find(b"<<")
    if start < 0:
        return b""
    depth = 0
    i = start
    while i < len(obj) - 1:
        if obj[i : i + 2] == b"<<":
            depth += 1
            i += 2
        elif obj[i : i + 2] == b">>":
            depth -= 1
            i += 2
            if depth == 0:
                return obj[start:i]
        else:
            i += 1
    return obj[start:]


def _get_ref(d: bytes, key: bytes) -> Optional[int]:
    m = re.search(re.escape(key) + rb"\s+(\d+)\s+\d+\s+R", d)
    return int(m.group(1)) if m else None


def _get_refs(d: bytes, key: bytes) -> List[int]:
    m = re.search(re.escape(key) + rb"\s*\[(.*?)\]", d, re.DOTALL)
    if m:
        return [int(x.group(1)) for x in _REF_RE.finditer(m.group(1))]
    one = _get_ref(d, key)
    return [one] if one is not None else []


def _inline_dict(d: bytes, key: bytes) -> Optional[bytes]:
    """Extract a << >>-valued key (balanced), e.g. /Resources << ... >>."""
    m = re.search(re.escape(key) + rb"\s*<<", d)
    if not m:
        return None
    start = m.end() - 2
    depth = 0
    i = start
    while i < len(d) - 1:
        if d[i : i + 2] == b"<<":
            depth += 1
            i += 2
        elif d[i : i + 2] == b">>":
            depth -= 1
            i += 2
            if depth == 0:
                return d[start:i]
        else:
            i += 1
    return None


class _Font:
    """Per-font decode state: ToUnicode map + code byte width."""

    def __init__(self, cmap: Dict[int, str], code_bytes: int):
        self.cmap = cmap
        self.code_bytes = code_bytes

    def decode(self, raw: bytes) -> str:
        if not self.cmap:
            # No ToUnicode: assume text bytes are latin-1-ish.
            return raw.decode("latin-1", errors="replace").translate(
                _LIGATURE_TRANS
            )
        w = self.code_bytes
        out = []
        for i in range(0, len(raw) - w + 1, w):
            code = int.from_bytes(raw[i : i + w], "big")
            out.append(self.cmap.get(code, ""))
        return "".join(out).translate(_LIGATURE_TRANS)


def _parse_cmap(data: bytes) -> Tuple[Dict[int, str], int]:
    """Parse a ToUnicode CMap stream into {code: text} + code byte width."""
    cmap: Dict[int, str] = {}
    code_bytes = 2
    m = re.search(rb"begincodespacerange\s*<([0-9A-Fa-f]+)>", data)
    if m:
        code_bytes = max(1, len(m.group(1)) // 2)

    def hex_to_text(h: bytes) -> str:
        h = re.sub(rb"\s", b"", h)
        if not h:
            return ""
        raw = bytes.fromhex(h.decode("ascii"))
        # UTF-16BE code units (possibly multiple chars)
        try:
            return raw.decode("utf-16-be")
        except UnicodeDecodeError:
            return raw.decode("latin-1", errors="replace")

    for block in _BFCHAR_RE.finditer(data):
        items = _HEX_RE.findall(block.group(1))
        for i in range(0, len(items) - 1, 2):
            src = int(re.sub(rb"\s", b"", items[i]) or b"0", 16)
            cmap[src] = hex_to_text(items[i + 1])
    for block in _BFRANGE_RE.finditer(data):
        body = block.group(1)
        # Two forms: <lo> <hi> <dst>  |  <lo> <hi> [<dst1> <dst2> ...]
        token_re = re.compile(rb"<([0-9A-Fa-f\s]*)>|\[(.*?)\]", re.DOTALL)
        tokens = token_re.findall(body)
        i = 0
        while i + 2 < len(tokens) + 1 and i + 2 <= len(tokens):
            lo_h, lo_arr = tokens[i]
            hi_h, hi_arr = tokens[i + 1] if i + 1 < len(tokens) else (b"", b"")
            if lo_arr or hi_arr or i + 2 > len(tokens):
                break
            dst_h, dst_arr = tokens[i + 2] if i + 2 < len(tokens) else (b"", b"")
            lo = int(re.sub(rb"\s", b"", lo_h) or b"0", 16)
            hi = int(re.sub(rb"\s", b"", hi_h) or b"0", 16)
            if dst_arr:
                dsts = _HEX_RE.findall(dst_arr)
                for off, d in enumerate(dsts):
                    if lo + off <= hi:
                        cmap[lo + off] = hex_to_text(d)
            else:
                base_raw = re.sub(rb"\s", b"", dst_h)
                if base_raw:
                    base = int(base_raw, 16)
                    for code in range(lo, min(hi, lo + 65535) + 1):
                        cmap[code] = chr(base + (code - lo))
            i += 3
    return cmap, code_bytes


_PDF_ESCAPES = {
    b"n": b"\n", b"r": b"\r", b"t": b"\t", b"b": b"\b", b"f": b"\f",
    b"(": b"(", b")": b")", b"\\": b"\\",
}


def _literal_bytes(raw: bytes) -> bytes:
    """Unescape a PDF literal string body."""
    out = bytearray()
    i = 0
    while i < len(raw):
        c = raw[i : i + 1]
        if c == b"\\" and i + 1 < len(raw):
            nxt = raw[i + 1 : i + 2]
            if nxt.isdigit():
                j = 1
                while j <= 3 and i + j < len(raw) and chr(raw[i + j]).isdigit():
                    j += 1
                out.append(int(raw[i + 1 : i + j], 8) & 0xFF)
                i += j
                continue
            out.extend(_PDF_ESCAPES.get(nxt, nxt))
            i += 2
            continue
        out.extend(c)
        i += 1
    return bytes(out)


# Content-stream tokens we care about: strings, hex strings, names, operators.
_TOKEN_RE = re.compile(
    rb"\((?:\\.|[^()\\])*\)"      # literal string
    rb"|<[0-9A-Fa-f\s]*>"          # hex string
    rb"|/[^\s/\[\]()<>{}]+"        # name
    rb"|\[|\]"
    rb"|[A-Za-z'\"][A-Za-z0-9*'\"]*"  # operator
    rb"|[-+.0-9]+"                 # number
)


class MiniPdf:
    """Parsed PDF document with text extraction."""

    def __init__(self, data: bytes):
        self.data = data
        self.objects: Dict[int, bytes] = {
            int(m.group(1)): m.group(3) for m in _OBJ_RE.finditer(data)
        }

    def _stream(self, obj_num: int) -> bytes:
        body = self.objects.get(obj_num, b"")
        m = _STREAM_RE.search(body)
        if not m:
            return b""
        raw = m.group(1)
        if b"FlateDecode" in _dict_body(body):
            try:
                return zlib.decompress(raw)
            except zlib.error:
                return raw
        return raw

    def _font_for_ref(self, ref: int) -> _Font:
        d = _dict_body(self.objects.get(ref, b""))
        tu = _get_ref(d, b"/ToUnicode")
        if tu is not None:
            cmap, width = _parse_cmap(self._stream(tu))
            return _Font(cmap, width)
        return _Font({}, 1)

    def _pages(self) -> List[int]:
        order: List[int] = []

        def walk(ref: int) -> None:
            d = _dict_body(self.objects.get(ref, b""))
            if b"/Type" in d and b"/Pages" in d.split(b"/Type", 1)[1][:20]:
                for kid in _get_refs(d, b"/Kids"):
                    walk(kid)
            elif re.search(rb"/Type\s*/Page\b", d):
                order.append(ref)
            else:
                for kid in _get_refs(d, b"/Kids"):
                    walk(kid)

        roots = [
            num
            for num, body in self.objects.items()
            if re.search(rb"/Type\s*/Catalog\b", _dict_body(body))
        ]
        for r in roots:
            pages_ref = _get_ref(_dict_body(self.objects[r]), b"/Pages")
            if pages_ref is not None:
                walk(pages_ref)
        if not order:  # fallback: any object that looks like a page
            order = [
                num
                for num, body in self.objects.items()
                if re.search(rb"/Type\s*/Page\b", _dict_body(body))
                and not re.search(rb"/Type\s*/Pages\b", _dict_body(body))
            ]
        return order

    def _page_fonts(self, page_ref: int) -> Dict[bytes, _Font]:
        """Resolve the page's /Resources /Font table (with inheritance)."""
        fonts: Dict[bytes, _Font] = {}
        seen = set()
        ref: Optional[int] = page_ref
        while ref is not None and ref not in seen:
            seen.add(ref)
            d = _dict_body(self.objects.get(ref, b""))
            res = _inline_dict(d, b"/Resources")
            if res is None:
                res_ref = _get_ref(d, b"/Resources")
                if res_ref is not None:
                    res = _dict_body(self.objects.get(res_ref, b""))
            if res:
                fd = _inline_dict(res, b"/Font")
                if fd is None:
                    f_ref = _get_ref(res, b"/Font")
                    if f_ref is not None:
                        fd = _dict_body(self.objects.get(f_ref, b""))
                if fd:
                    for m in re.finditer(rb"/([^\s/<>\[\]]+)\s+(\d+)\s+\d+\s+R", fd):
                        name = b"/" + m.group(1)
                        if name not in fonts:
                            fonts[name] = self._font_for_ref(int(m.group(2)))
            ref = _get_ref(d, b"/Parent")
        return fonts

    def _page_text(self, page_ref: int) -> str:
        d = _dict_body(self.objects.get(page_ref, b""))
        fonts = self._page_fonts(page_ref)
        content = b"".join(self._stream(c) for c in _get_refs(d, b"/Contents"))
        if not content:
            return ""
        cur: Optional[_Font] = None
        pieces: List[str] = []
        pending_name: Optional[bytes] = None
        strings_since_td = 0
        for tok_m in _TOKEN_RE.finditer(content):
            tok = tok_m.group(0)
            if tok.startswith(b"/"):
                pending_name = tok
            elif tok in (b"Tf",) and pending_name is not None:
                cur = fonts.get(pending_name, cur)
                pending_name = None
            elif tok in (b"T*", b"ET"):
                # New text line / end of text block -> soft break.  `Td`/`Tm`
                # moves are NOT breaks: generators like Skia reposition within
                # a word for kerning, and breaking there splits words.
                if pieces and not pieces[-1].endswith("\n") and strings_since_td:
                    pieces.append("\n")
                strings_since_td = 0
            elif tok.startswith(b"(") and tok.endswith(b")"):
                raw = _literal_bytes(tok[1:-1])
                pieces.append((cur or _Font({}, 1)).decode(raw))
                strings_since_td += 1
            elif tok.startswith(b"<") and tok.endswith(b">"):
                h = re.sub(rb"\s", b"", tok[1:-1])
                if len(h) % 2:
                    h += b"0"
                try:
                    raw = bytes.fromhex(h.decode("ascii"))
                except ValueError:
                    continue
                pieces.append((cur or _Font({}, 2)).decode(raw))
                strings_since_td += 1
        text = "".join(pieces)
        # collapse intra-line runs, keep line structure
        lines = [" ".join(ln.split()) for ln in text.split("\n")]
        return "\n".join(ln for ln in lines if ln)

    def extract_text(self) -> str:
        """Concatenated page texts with 'Page N:' prefixes (matching the
        reference extractors' output shape, embedding_generator.py:228,249)."""
        out = []
        for i, page in enumerate(self._pages()):
            t = self._page_text(page)
            if t.strip():
                out.append(f"Page {i + 1}: {' '.join(t.split())}")
        return "\n".join(out)


def extract_text(path_or_bytes) -> str:
    data = (
        path_or_bytes
        if isinstance(path_or_bytes, (bytes, bytearray))
        else open(path_or_bytes, "rb").read()
    )
    return MiniPdf(bytes(data)).extract_text()
