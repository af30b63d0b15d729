"""Test fixtures, and comparisons of the float selection kernels with
their plain versions.

`create_sample_nodes` and `create_sample_query` are the 18 typed demo nodes
(products, documents, specifications, categories, an annotation; relevant
to irrelevant for the canonical query) and that query, with embeddings from
the hashing embedder, the same as the JAX package's `testing.py` gives.  `RowLookupEmbedder`
encodes a row's own text to the row's stored embedding, so questions over a
synthetic index of random rows find their rows, as with an encoder that
knows the corpus.

Kernels B4, B5, B7f and B8 take their f32 dot sums in another order than the
plain versions' matrix products, so the two agree to rounding, not to the
bit.
These checks state how far they may differ and raise AssertionError past
that; `tests/test_torch_cuda.py` and `chip_smoke.py` use them on the card.

  * B4 (`check_exact_topk`): values within `atol`; an index may differ only
    where the two rows' scores (recomputed in float64) lie within `atol` of
    each other, a near-tie that rounding can order either way.  Over a bf16
    bank B4 sums on the tensor cores (where `topk_cuda.b4_on_tensor_cores`)
    within `TC_DOT_ERROR` of the float64 dots, far inside `atol`; on exact
    dots it equals its plain version bit for bit on either loop.
  * B5 and B7f (`check_packed_topk`): keys equal, except in a tile where a
    row that either side selected has its shifted score within 1e-6 of a
    multiple of the key quantum (B5: 2^-11 above 2, 2^-12 below; B7f over
    lbits-row supertiles: lbits times 2^-22 above 2, 2^-23 below), where
    rounding can move the row's key by one quantum.  On inputs whose dots
    are exact in any order (multiples of 1/64, say) the two are bit-equal.
    Over a bf16 bank both kernels sum on the tensor cores, which add in
    their own order and rounding; the band holds for them while their sums
    stay within `TC_DOT_ERROR` (the same 1e-6) of the float64 dots.  On an
    NVIDIA H100 80GB HBM3 at 700 W the loop's largest error over 512 x
    65,536 normalized rows at d = 384 measured 1.6e-7 (an f32 matrix
    product's: 1.3e-7), so the band is unchanged; `chip_smoke.py` measures
    it again on every run and fails past the band.
  * B8c (`check_level1`): the [m1 | m2] keys equal, except where the row a
    differing key may come from (its column, in any tile) has its shifted
    score within 1e-6 of a multiple of the key quantum (2^-11 above 2,
    2^-12 below) and within a quantum of that key's score.  Bit-equal on
    exact dots.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from hcrag_tpu_torch.core.types import NodeInput, QueryInput, QueryIntent
from hcrag_tpu_torch.models.embedder import HashingEmbedder

_EMBEDDER = HashingEmbedder()

_FIXTURES = [
    # (text, node_type, entities)
    ("Premium Red Mountain Bike - Trail Blazer X1 with advanced suspension "
     "and lightweight frame, perfect for off-road adventures under $900",
     "product", ["red mountain bike", "trail", "suspension", "lightweight"]),
    ("Blue Mountain Bike - Rugged terrain specialist with 21-speed gear "
     "system, priced at $750",
     "product", ["blue mountain bike", "terrain", "gear system"]),
    ("Mountain Bike Maintenance Guide - Complete handbook for maintaining "
     "your mountain bike including brake adjustments, tire care, and gear "
     "tuning",
     "document", ["mountain bike", "maintenance", "brake", "tire"]),
    ("Red Road Bike - Speed demon for paved roads with aerodynamic design, "
     "$1200",
     "product", ["red road bike", "aerodynamic", "speed"]),
    ("Mountain Bike Frame Specifications - Technical details for aluminum "
     "and carbon fiber mountain bike frames, weight tolerances and geometry",
     "specification", ["mountain bike", "frame", "aluminum", "carbon fiber"]),
    ("Mountain Bikes Category - Off-road bicycles designed for rough "
     "terrain riding",
     "category", ["mountain bike", "off-road"]),
    ("Red Mountain Bike Helmet - Safety certified helmet with ventilation, "
     "matches red bikes, $85",
     "product", ["red", "helmet", "safety"]),
    ("Kitchen Blender 3000 - High-powered blender for smoothies and food "
     "preparation, $120",
     "product", ["blender", "kitchen"]),
    ("Office Chair Assembly Manual - Step-by-step guide for assembling "
     "ergonomic office chairs",
     "document", ["office chair", "assembly"]),
    ("Laptop Computer Specifications - 16GB RAM, 512GB SSD, 14-inch display "
     "technical specs",
     "specification", ["laptop", "computer"]),
    ("Mountain Bike Wheels 29-inch - Tubeless-ready wheels for mountain "
     "bikes, pair $320",
     "product", ["mountain bike", "wheel", "tubeless"]),
    ("Touring Bike Travel Guide - Long distance cycling routes and "
     "equipment recommendations",
     "document", ["touring bike", "travel"]),
    ("Bicycle Brake Pads Specification - Compatibility chart for disc and "
     "rim brake pads",
     "specification", ["brake", "bicycle"]),
    ("Garden Hose 50ft - Flexible watering hose for outdoor use, $35",
     "product", ["garden hose"]),
    ("Road Bikes Category - Lightweight bicycles optimized for paved "
     "surfaces",
     "category", ["road bike", "lightweight"]),
    ("Mountain Bike Suspension Service Manual - Fork and shock maintenance "
     "procedures with torque specifications",
     "document", ["mountain bike", "suspension", "fork"]),
    ("Black Mountain Bike Gloves - Padded cycling gloves size M-XL, $25",
     "product", ["black", "gloves", "mountain bike"]),
    ("Annotation: Mountain bike geometry diagram Figure 3",
     "annotation", ["mountain bike", "geometry"]),
]



def create_sample_nodes() -> List[NodeInput]:
    """18 typed fixture nodes with deterministic embeddings."""
    return [
        NodeInput(
            text=text,
            embeddings=_EMBEDDER.encode([text])[0],
            graph_relations={"type": node_type},
            node_type=node_type,
            entities=entities,
        )
        for text, node_type, entities in _FIXTURES
    ]


def create_sample_query(
    text: str = "Find red mountain bikes under $1000",
    intent: QueryIntent = QueryIntent.PRODUCT_SEARCH,
) -> QueryInput:
    """The canonical demo query with its embedding."""
    return QueryInput(
        text=text,
        embeddings=_EMBEDDER.encode([text])[0],
        entities=["red mountain bike"],
        intent=intent,
    )


class RowLookupEmbedder:
    """Encodes a text equal to an index row's text to that row's stored
    embedding (the first such row), any other text by the hashing embedder
    at the index's width.  Host numpy, like the hashing embedder; either
    package's engine takes it as its `embedder`."""

    def __init__(self, index):
        self.dim = int(np.asarray(index.emb).shape[1])
        self._emb = index.emb
        self._rows = {}
        for i, text in enumerate(index.texts):
            self._rows.setdefault(text, i)
        self._fallback = HashingEmbedder(dim=self.dim)

    def encode(self, texts: Sequence[str]) -> np.ndarray:
        out = np.empty((len(texts), self.dim), np.float32)
        for j, text in enumerate(texts):
            row = self._rows.get(text)
            out[j] = (self._fallback.encode([text])[0] if row is None
                      else np.asarray(self._emb[row], np.float32))
        return out


NEAR_BOUNDARY = 1e-6
#: The most the tensor-core dot loop of B5 / B7f (and of B4 over bf16) may
#: differ from the float64 dots for `check_packed_topk`'s band to hold.
TC_DOT_ERROR = NEAR_BOUNDARY


def _dots(q: torch.Tensor, e: torch.Tensor, b_idx, rows) -> torch.Tensor:
    """float64 dots of queries q[b_idx] with rows e[rows] (same shapes)."""
    return (q[b_idx].double() * e[rows.long()].double()).sum(dim=-1)


def check_exact_topk(kv, ki, pv, pi, q, e, mask, atol: float = 1e-5) -> Tuple[float, int]:
    """B4's kernel output (kv, ki) against its plain version's (pv, pi), all
    [B, tiles, k], for operands q [B, D], e [N, D], mask [N].  Returns (max
    abs value difference, number of indices that differ at near-ties)."""
    err = float((kv.double() - pv.double()).abs().max())
    if err > atol:
        raise AssertionError(f"values differ by {err} > {atol}")
    bad = (ki != pi).nonzero()
    if len(bad):
        at = tuple(bad.T)
        rk, rp = ki[at], pi[at]
        gap = (_dots(q, e, bad[:, 0], rk) - _dots(q, e, bad[:, 0], rp)).abs()
        ok = (kv[at] > -1e29) & mask[rk.long()] & mask[rp.long()] & (gap <= atol)
        if not bool(ok.all()):
            first = bad[~ok][0].tolist()
            raise AssertionError(f"indices differ at {first} beyond a near-tie")
    return err, len(bad)


def check_packed_topk(kv, ki, pv, pi, q, e, max_share: float = 0.02,
                      lane_bits: int = 2048) -> Tuple[float, int]:
    """B5's (or, with `lane_bits` = lbits, B7f's) kernel output (kv, ki)
    against its plain version's (pv, pi), all [B, tiles, k], for operands
    q [B, D], e [N, D].  Returns (max abs value difference over the slots
    that agree on their row, number of tiles that differ next to a
    key-quantum boundary); raises if such tiles exceed `max_share` of
    all."""
    same_i = ki == pi
    same = same_i & (kv.view(torch.int32) == pv.view(torch.int32))
    bad = (~same).any(dim=2).nonzero()
    if len(bad):
        b_idx, t_idx = bad[:, 0], bad[:, 1]
        rows = torch.cat([ki[b_idx, t_idx], pi[b_idx, t_idx]], dim=1)
        x = _dots(q, e, b_idx[:, None].expand_as(rows), rows.clamp(min=0)) + 2.0
        quantum = torch.where(x >= 2.0, lane_bits * 2.0**-22, lane_bits * 2.0**-23)
        near = ((x - torch.round(x / quantum) * quantum).abs() < NEAR_BOUNDARY)
        excused = (near & (rows >= 0)).any(dim=1)
        if not bool(excused.all()):
            first = bad[~excused][0].tolist()
            raise AssertionError(f"keys differ in (query, tile) {first} away from a boundary")
        if len(bad) > max_share * ki.shape[0] * ki.shape[1]:
            raise AssertionError(f"{len(bad)} tiles differ: more than {max_share:.0%}")
    diff = (kv.double() - pv.double()).abs()
    err = float(torch.where(same_i, diff, 0.0).max())
    return err, len(bad)


def check_level1(kernel_out, plain_out, q, e, tile_n: int, max_share: float = 0.02,
                 chunk: int = 64) -> int:
    """B8c's kernel output against its plain version's, both [B, 256] int32
    ([m1 | m2] keys), for operands q [B, D] and e [N, D] of whole `tile_n`-row
    tiles.  A key names its column in the tile, not the tile, so the rows
    it may come from are that column's rows in every tile; a differing
    entry is excused when, for one of the two keys, such a row lies next to
    a key-quantum boundary and within a quantum of the key's score.
    Returns the number of differing entries; raises past `max_share` of
    all, or at one that is not excused."""
    bad = (kernel_out != plain_out).nonzero()
    if not len(bad):
        return 0
    if len(bad) > max_share * kernel_out.numel():
        raise AssertionError(f"{len(bad)} keys differ: more than {max_share:.0%}")
    n = e.shape[0]
    tile_base = torch.arange(0, n, tile_n, device=e.device)
    for lo in range(0, len(bad), chunk):
        b_idx, slot = bad[lo:lo + chunk, 0], bad[lo:lo + chunk, 1]
        keys = torch.stack([kernel_out[b_idx, slot], plain_out[b_idx, slot]], dim=1)
        col = 2047 - (keys & 2047)
        score = (keys & ~2047).view(torch.float32).double()  # the key's s + 2
        rows = col[:, :, None] + tile_base  # [m, 2, tiles]
        real = ((keys > 0) & (col < tile_n))[:, :, None]
        x = _dots(q, e, b_idx[:, None, None].expand_as(rows), rows.clamp(max=n - 1)) + 2.0
        quantum = torch.where(x >= 2.0, 2.0**-11, 2.0**-12)
        near = (x - torch.round(x / quantum) * quantum).abs() < NEAR_BOUNDARY
        close = (x - score[:, :, None]).abs() <= quantum + NEAR_BOUNDARY
        excused = (near & close & real).flatten(1).any(dim=1)
        if not bool(excused.all()):
            first = bad[lo:lo + chunk][~excused][0].tolist()
            raise AssertionError(f"keys differ at (query, slot) {first} away from a boundary")
    return len(bad)


# ---------------------------------------------------------------------------
# An AdventureWorks-shaped corpus, written from a seed
# ---------------------------------------------------------------------------

#: Row counts of the reference corpus (the AdventureWorksLT export it ships:
#: `Product.csv` 100 rows, `ProductCategory.csv` 41, `SalesOrderHeader.csv`
#: 32, the other tables 100 each).
REFERENCE_ROWS = dict(products=100, categories=41, descriptions=100, models=100,
                      model_descriptions=100, order_headers=32, order_details=100)
#: The order and catalogue tables at the published row counts of
#: Microsoft's AdventureWorks OLTP sample database (Production.Product 504,
#: ProductModel 128, ProductDescription 762,
#: ProductModelProductDescriptionCulture 762, Sales.SalesOrderHeader 31,465,
#: Sales.SalesOrderDetail 121,317; 4 categories with 37 subcategories).
OLTP_ROWS = dict(products=504, categories=41, descriptions=762, models=128,
                 model_descriptions=762, order_headers=31465, order_details=121317)

_CATEGORIES = ["Bikes", "Components", "Clothing", "Accessories"]
#: (subcategory, parent, product families of that subcategory)
_SUBCATEGORIES = [
    ("Mountain Bikes", 1, ["Mountain-100", "Mountain-200", "Mountain-500"]),
    ("Road Bikes", 1, ["Road-150", "Road-350-W", "Road-650"]),
    ("Touring Bikes", 1, ["Touring-1000", "Touring-3000"]),
    ("Handlebars", 2, ["HL Mountain Handlebars", "ML Road Handlebars", "LL Touring Handlebars"]),
    ("Bottom Brackets", 2, ["HL Bottom Bracket", "LL Bottom Bracket"]),
    ("Brakes", 2, ["Front Brakes", "Rear Brakes"]),
    ("Chains", 2, ["Chain"]),
    ("Cranksets", 2, ["HL Crankset", "ML Crankset"]),
    ("Derailleurs", 2, ["Front Derailleur", "Rear Derailleur"]),
    ("Forks", 2, ["HL Fork", "LL Fork"]),
    ("Headsets", 2, ["HL Headset", "ML Headset"]),
    ("Mountain Frames", 2, ["HL Mountain Frame", "ML Mountain Frame-W"]),
    ("Pedals", 2, ["Touring Pedal", "ML Mountain Pedal"]),
    ("Road Frames", 2, ["HL Road Frame", "ML Road Frame-W", "LL Road Frame"]),
    ("Saddles", 2, ["HL Mountain Seat/Saddle", "LL Road Seat/Saddle"]),
    ("Touring Frames", 2, ["HL Touring Frame", "LL Touring Frame"]),
    ("Wheels", 2, ["HL Mountain Front Wheel", "ML Road Rear Wheel"]),
    ("Bib-Shorts", 3, ["Men's Bib-Shorts"]),
    ("Caps", 3, ["AWC Logo Cap"]),
    ("Gloves", 3, ["Full-Finger Gloves", "Half-Finger Gloves"]),
    ("Jerseys", 3, ["Long-Sleeve Logo Jersey", "Short-Sleeve Classic Jersey"]),
    ("Shorts", 3, ["Men's Sports Shorts", "Women's Mountain Shorts"]),
    ("Socks", 3, ["Mountain Bike Socks", "Racing Socks"]),
    ("Tights", 3, ["Women's Tights"]),
    ("Vests", 3, ["Classic Vest"]),
    ("Bike Racks", 4, ["Hitch Rack - 4-Bike"]),
    ("Bike Stands", 4, ["All-Purpose Bike Stand"]),
    ("Bottles and Cages", 4, ["Water Bottle - 30 oz.", "Mountain Bottle Cage"]),
    ("Cleaners", 4, ["Bike Wash - Dissolver"]),
    ("Fenders", 4, ["Fender Set - Mountain"]),
    ("Helmets", 4, ["Sport-100 Helmet"]),
    ("Hydration Packs", 4, ["Hydration Pack - 70 oz."]),
    ("Lights", 4, ["Headlights - Dual-Beam", "Taillights - Battery-Powered"]),
    ("Locks", 4, ["Cable Lock"]),
    ("Panniers", 4, ["Touring-Panniers, Large"]),
    ("Pumps", 4, ["Minipump", "Mountain Pump"]),
    ("Tires and Tubes", 4, ["HL Mountain Tire", "Road Tire Tube", "Patch Kit/8 Patches"]),
]
_COLORS = ["Black", "Red", "Silver", "Blue", "Yellow", "Multi", "White", ""]
_SIZES = ["38", "40", "42", "44", "46", "48", "52", "58", "62", "S", "M", "L", "XL", ""]
_WORDS = ("aluminum alloy carbon frame lightweight durable stiff comfortable "
          "responsive geometry racing touring trail suspension fork wheel "
          "tubing welded butted chromoly clincher tubeless brake lever crank "
          "pedal saddle padded breathable wicking reflective sealed bearing "
          "threadless headset cable ergonomic grip rider climbing descent").split()
_CULTURES = ["en    ", "fr    ", "ar    ", "he    ", "th    ", "zh-cht"]
#: The corpus's documents: (name, figure count, table count); 4 PDFs with
#: 3 figure JPGs and 6 JSON tables beside them.
_DOCUMENTS = [
    ("Mountain Bike Catalog", 1, 2),
    ("Road Frame Handbook", 1, 1),
    ("Handlebars Installation Guide", 1, 1),
    ("Jersey Care Guide", 0, 2),
]


def _decimal_comma(x: float) -> str:
    return f"{x:.2f}".replace(".", ",")


def _write_csv(path, header: Sequence[str], rows) -> None:
    import csv

    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f, delimiter=";", lineterminator="\n")
        w.writerow(header)
        w.writerows(rows)


def _sentences(rng, n: int, subject: str) -> str:
    verbs = ["is made of", "includes", "features", "is designed for", "provides",
             "is compatible with", "comes with", "requires"]
    out = []
    for _ in range(n):
        words = " ".join(rng.choice(_WORDS, size=int(rng.integers(2, 5))))
        out.append(f"The {subject} {verbs[int(rng.integers(len(verbs)))]} {words}.")
    return " ".join(out)


def _pdf_bytes(pages: Sequence[str], extra_literal: str = "") -> bytes:
    """A PDF whose pages show `pages` in a Type0 font (Identity-H, 2-byte
    glyph codes) with a Flate-compressed /ToUnicode CMap (bfchar entries,
    a bfrange for the digits, a U+FB01 ligature glyph wherever "fi"
    occurs), in Flate-compressed content streams that break lines with T*
    and kern inside TJ arrays; `extra_literal` is shown on the last page in
    a simple font as a literal string."""
    import zlib

    chars = sorted({c for p in pages for c in p.replace("fi", "")} - set("0123456789"))
    code_of = {c: 0x20 + i for i, c in enumerate(chars)}
    for d in range(10):
        code_of[str(d)] = 0x300 + d
    lig = 0x3F0

    def glyphs(text: str) -> str:
        out, i = [], 0
        while i < len(text):
            if text.startswith("fi", i):
                out.append(lig)
                i += 2
            else:
                out.append(code_of[text[i]])
                i += 1
        return "".join(f"{c:04X}" for c in out)

    bfchar = "".join(f"<{code_of[c]:04X}> <{ord(c):04X}>\n" for c in chars)
    cmap = (
        "/CIDInit /ProcSet findresource begin\n12 dict begin\nbegincmap\n"
        "1 begincodespacerange\n<0000> <FFFF>\nendcodespacerange\n"
        f"{len(chars) + 1} beginbfchar\n{bfchar}<{lig:04X}> <FB01>\nendbfchar\n"
        "1 beginbfrange\n<0300> <0309> <0030>\nendbfrange\n"
        "endcmap\nCMapName currentdict /CMap defineresource pop\nend\nend\n"
    ).encode()
    objs = {
        1: b"<< /Type /Catalog /Pages 2 0 R >>",
        4: (b"<< /Type /Font /Subtype /Type0 /BaseFont /AAAAAA+Arial /Encoding "
            b"/Identity-H /DescendantFonts [5 0 R] /ToUnicode 6 0 R >>"),
        5: (b"<< /Type /Font /Subtype /CIDFontType2 /BaseFont /AAAAAA+Arial "
            b"/CIDSystemInfo << /Registry (Adobe) /Ordering (Identity) /Supplement 0 >> >>"),
        7: b"<< /Type /Font /Subtype /Type1 /BaseFont /Helvetica >>",
    }
    streams = {6: zlib.compress(cmap)}
    kids = []
    for p, text in enumerate(pages):
        page_obj, content_obj = 10 + 2 * p, 11 + 2 * p
        kids.append(page_obj)
        ops = ["BT", "/F1 11 Tf", "72 720 Td"]
        for line in text.split("\n"):
            words = line.split(" ")
            if len(words) > 2:  # kerned within the line, as generators do
                head, tail = " ".join(words[:2]) + " ", " ".join(words[2:])
                ops.append(f"[<{glyphs(head)}> -12 <{glyphs(tail)}>] TJ")
            else:
                ops.append(f"<{glyphs(line)}> Tj")
            ops.append("T*")
        ops.append("ET")
        if extra_literal and p == len(pages) - 1:
            esc = extra_literal.replace("\\", "\\\\").replace("(", "\\(").replace(")", "\\)")
            ops += ["BT", "/F2 9 Tf", "72 60 Td", f"({esc}) Tj", "ET"]
        objs[page_obj] = (f"<< /Type /Page /Parent 2 0 R /MediaBox [0 0 612 792] "
                          f"/Contents {content_obj} 0 R >>").encode()
        streams[content_obj] = zlib.compress("\n".join(ops).encode())
    objs[2] = ("<< /Type /Pages /Kids [" + " ".join(f"{k} 0 R" for k in kids)
               + f"] /Count {len(kids)} /Resources << /Font << /F1 4 0 R /F2 7 0 R >> >> >>"
               ).encode()
    for num, data in streams.items():
        objs[num] = (f"<< /Length {len(data)} /Filter /FlateDecode >>\nstream\n".encode()
                     + data + b"\nendstream")
    out = bytearray(b"%PDF-1.4\n%\xe2\xe3\xcf\xd3\n")
    offsets = {}
    for num in sorted(objs):
        offsets[num] = len(out)
        out += f"{num} 0 obj\n".encode() + objs[num] + b"\nendobj\n"
    xref = len(out)
    top = max(objs) + 1
    out += f"xref\n0 {top}\n0000000000 65535 f \n".encode()
    for num in range(1, top):
        out += (f"{offsets[num]:010d} 00000 n \n" if num in offsets
                else "0000000000 65535 f \n").encode()
    out += f"trailer\n<< /Size {top} /Root 1 0 R >>\nstartxref\n{xref}\n%%EOF\n".encode()
    return bytes(out)


def write_adventureworks_corpus(root, *, seed: int = 0, rows: dict = REFERENCE_ROWS):
    """Write an AdventureWorks-shaped corpus under `root` and return its
    path: the seven `;`-separated CSVs of the reference corpus with the
    AdventureWorks columns (decimal-comma prices and amounts, empty cells,
    a True/False order flag, hex thumbnail blobs in `Product.csv`, quoted
    fields holding `;`), at `rows` (`REFERENCE_ROWS` or `OLTP_ROWS`), and
    `IngestedDocuments/` with 4 PDFs (`_pdf_bytes`), 6 JSON tables and 3
    JPGs named after them.  Everything comes from numpy's `default_rng(seed)`."""
    import json
    import uuid
    from pathlib import Path

    root = Path(root)
    docs = root / "IngestedDocuments"
    docs.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    date = "2008-06-01 00:00:00.000"

    def guid() -> str:
        return str(uuid.UUID(bytes=rng.bytes(16), version=4)).upper()

    # ProductCategory: 4 parents (empty ParentProductCategoryID) + 37 subcategories.
    cat_rows = [[i + 1, "", name, guid(), date] for i, name in enumerate(_CATEGORIES)]
    for j, (name, parent, _) in enumerate(_SUBCATEGORIES[: rows["categories"] - 4]):
        cat_rows.append([5 + j, parent, name, guid(), date])
    _write_csv(root / "ProductCategory.csv",
               ["ProductCategoryID", "ParentProductCategoryID", "Name", "rowguid",
                "ModifiedDate"], cat_rows)

    n_models = rows["models"]
    families = [(f, 5 + j) for j, (_, _, fams) in enumerate(_SUBCATEGORIES) for f in fams]
    model_rows = []
    for m in range(n_models):
        fam = families[m % len(families)][0]
        name = fam if m < len(families) else f"{fam} {m // len(families) + 1}"
        catalog = ""
        if m % 16 == 3:  # a few models carry a long catalogue text, with ';'
            catalog = (f"<Summary>{_sentences(rng, 3, name)} Sizes: S; M; L.</Summary>"
                       f"<Manufacturer>Adventure Works</Manufacturer>")
        model_rows.append([m + 1, name, catalog, guid(), date])
    _write_csv(root / "ProductModel.csv",
               ["ProductModelID", "Name", "CatalogDescription", "rowguid", "ModifiedDate"],
               model_rows)

    products = []
    seen_names = set()
    for i in range(rows["products"]):
        fam_idx = int(rng.integers(len(families)))
        fam, cat_id = families[fam_idx]
        color = _COLORS[int(rng.integers(len(_COLORS)))]
        size = _SIZES[int(rng.integers(len(_SIZES)))]
        name = fam + (f" - {color}" if color else "") + (f", {size}" if size else "")
        while name in seen_names:
            name += f" {i}"
        seen_names.add(name)
        price = float(rng.choice([0.0, rng.uniform(2, 3600)], p=[0.05, 0.95]))
        model_id = "" if i % 23 == 7 else str(1 + fam_idx % n_models)
        weight = "" if rng.random() < 0.4 else f"{rng.uniform(100, 14000):.2f}"
        blob = "0x" + rng.bytes(int(rng.integers(96, 160))).hex().upper()
        products.append([
            680 + i, name, f"{fam[:2].upper()}-{i:04d}{size}", color,
            _decimal_comma(price * 0.6), _decimal_comma(price), size, weight, cat_id,
            model_id, date, "" if rng.random() < 0.8 else date, "", blob,
            "no_image_available_small.gif" if i % 5 else f"frame_{i}_small.gif",
            guid(), date,
        ])
    _write_csv(root / "Product.csv",
               ["ProductID", "Name", "ProductNumber", "Color", "StandardCost", "ListPrice",
                "Size", "Weight", "ProductCategoryID", "ProductModelID", "SellStartDate",
                "SellEndDate", "DiscontinuedDate", "ThumbNailPhoto",
                "ThumbnailPhotoFileName", "rowguid", "ModifiedDate"], products)

    n_desc = rows["descriptions"]
    _write_csv(root / "ProductDescription.csv",
               ["ProductDescriptionID", "Description", "rowguid", "ModifiedDate"],
               [[3 + d, _sentences(rng, 2, families[d % len(families)][0]), guid(), date]
                for d in range(n_desc)])
    _write_csv(root / "ProductModelProductDescription.csv",
               ["ProductModelID", "ProductDescriptionID", "Culture", "rowguid",
                "ModifiedDate"],
               [[1 + k % n_models, 3 + k % n_desc, _CULTURES[k % len(_CULTURES)], guid(),
                 date] for k in range(rows["model_descriptions"])])

    n_head = rows["order_headers"]
    sub = rng.uniform(1, 120000, size=n_head)
    head_rows = [
        [71774 + h, 2, date, date, date, 5, ("True" if h % 3 == 0 else "False"),
         f"SO{71774 + h}", f"PO{rng.integers(10**9, 10**10)}",
         f"10-4020-{rng.integers(10**5, 10**6):06d}", 29000 + int(rng.integers(1000)),
         1000 + h, 1000 + h, "CARGO TRANSPORT 5", "", _decimal_comma(sub[h]),
         _decimal_comma(sub[h] * 0.08), _decimal_comma(sub[h] * 0.025),
         _decimal_comma(sub[h] * 1.105), "", guid(), date]
        for h in range(n_head)
    ]
    _write_csv(root / "SalesOrderHeader.csv",
               ["SalesOrderID", "RevisionNumber", "OrderDate", "DueDate", "ShipDate",
                "Status", "OnlineOrderFlag", "SalesOrderNumber", "PurchaseOrderNumber",
                "AccountNumber", "CustomerID", "ShipToAddressID", "BillToAddressID",
                "ShipMethod", "CreditCardApprovalCode", "SubTotal", "TaxAmt", "Freight",
                "TotalDue", "Comment", "rowguid", "ModifiedDate"], head_rows)

    n_det = rows["order_details"]
    order = rng.integers(0, n_head, size=n_det)
    qty = rng.integers(1, 30, size=n_det)
    prod = rng.integers(0, rows["products"], size=n_det)
    unit = rng.uniform(1, 2000, size=n_det)
    raw = rng.bytes(16 * n_det)
    guids = [str(uuid.UUID(bytes=raw[16 * k:16 * k + 16], version=4)).upper()
             for k in range(n_det)]
    _write_csv(root / "SalesOrderDetail.csv",
               ["SalesOrderID", "SalesOrderDetailID", "OrderQty", "ProductID", "UnitPrice",
                "UnitPriceDiscount", "LineTotal", "rowguid", "ModifiedDate"],
               [[71774 + int(order[k]), 110562 + k, int(qty[k]), 680 + int(prod[k]),
                 _decimal_comma(unit[k]), "0,00", _decimal_comma(unit[k] * qty[k]),
                 guids[k], date] for k in range(n_det)])

    for d, (name, n_fig, n_tab) in enumerate(_DOCUMENTS):
        subject = name.rsplit(" ", 1)[0]
        pages = [
            f"{name}\n" + _sentences(rng, 4, subject) + "\nSpecifications and fitting\n"
            + _sentences(rng, 6 + 4 * d, subject)
            for _ in range(1 + d % 2)
        ]
        (docs / f"{name}.pdf").write_bytes(
            _pdf_bytes(pages, extra_literal=f"(c) Adventure Works {2008 + d}"))
        for f in range(n_fig):
            (docs / f"{name} Fig {f + 1}.jpg").write_bytes(
                b"\xff\xd8\xff\xe0" + rng.bytes(64) + b"\xff\xd9")
        for t in range(n_tab):
            table = {
                "title": f"{subject} table {t + 1}",
                "columns": ["Size", "Weight", "Price"],
                "rows": [{"Size": str(s), "Weight": f"{rng.uniform(1, 12):.1f} kg",
                          "Price": round(float(rng.uniform(20, 900)), 2)}
                         for s in (38, 42, 46)],
                "notes": [_sentences(rng, 1, subject)],
            }
            (docs / f"{name} Table {t + 1}.json").write_text(json.dumps(table, indent=1))
    return root


def write_golden_pairs(path, texts: Sequence[str], vectors: np.ndarray,
                       metadata: Optional[Sequence[dict]] = None) -> str:
    """A pickle of (text, vector) pairs in the reference layout
    ({embeddings, metadata, texts, generation_info}): the golden set that
    `tools.distill_minilm` distils onto."""
    import pickle

    if metadata is None:
        metadata = [{"row": i} for i in range(len(texts))]
    with open(path, "wb") as f:
        pickle.dump({"embeddings": np.asarray(vectors, np.float32), "texts": list(texts),
                     "metadata": list(metadata),
                     "generation_info": {"total_entries": len(texts)}}, f)
    return str(path)


def write_golden_set(root, *, device=None, seed: int = 0) -> str:
    """The distillation's golden set over the seeded corpus: the corpus at
    the reference row counts under `root` (`write_adventureworks_corpus`),
    its texts (`process_corpus`, 589 rows), each paired with the committed
    distilled encoder's vector (the teacher: the same architecture, so the
    targets can be reached; on `device`, CUDA unless named), pickled at
    `root/pairs.pkl`.  Returns the pickle's path."""
    import os

    from hcrag_tpu_torch.ingest.adventureworks import process_corpus
    from hcrag_tpu_torch.models.minilm import load_distilled_embedder

    texts, metadata = process_corpus(
        write_adventureworks_corpus(os.path.join(root, "corpus"), seed=seed))
    teacher = load_distilled_embedder(device=device)
    if teacher is None:
        raise FileNotFoundError("the committed distilled encoder (tools/minilm_distilled*)")
    return write_golden_pairs(os.path.join(root, "pairs.pkl"), texts,
                              teacher.encode(texts), metadata)


def write_corpus_pairs(data, path) -> str:
    """A pickle at `path` of the corpus under `data`: its texts
    (`process_corpus`) paired with the hashing embedder's vectors, fitted on
    them, with the corpus's metadata (`write_golden_pairs`)."""
    from hcrag_tpu_torch.ingest.adventureworks import process_corpus
    from hcrag_tpu_torch.models.embedder import HashingEmbedder

    texts, metadata = process_corpus(data)
    embedder = HashingEmbedder()
    embedder.fit(texts)
    return write_golden_pairs(path, texts, embedder.encode(texts), metadata)


def seeded_corpus(root, seed: int = 0) -> Tuple[str, str]:
    """(data directory, pickle) of the seeded corpus under `root`: the
    corpus at the reference row counts (`write_adventureworks_corpus`) and
    its pickle (`write_corpus_pairs`)."""
    import os

    data = str(write_adventureworks_corpus(os.path.join(root, "corpus"), seed=seed))
    return data, write_corpus_pairs(data, os.path.join(root, "pairs.pkl"))
