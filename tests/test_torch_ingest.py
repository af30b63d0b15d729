"""The port's ingestion against the JAX package's on the same files.

A seeded AdventureWorks-shaped corpus (`testing.write_adventureworks_corpus`:
the reference corpus's seven CSVs at its row counts, 4 PDFs with Flate
streams and a Type0/ToUnicode font, 6 JSON tables, 3 JPGs, plus a Markdown
note) goes through both packages: every CSV, JSON and PDF, `minipdf`, the
chunker, the document grouping, and `build_adventureworks` whole, whose
texts, metadata, graph arrays (`row_ptr`, `col_idx`, `edge_type`,
`node_to_row`), links and index arrays must be equal (the embeddings bit
for bit: both run the same native library).  The JAX package reads the
tables with pandas, the port with `csv`: one parametrized case per pandas
behaviour the texts depend on, each a small table."""

import json

import numpy as np
import pandas as pd
import pytest

from hcrag_tpu.ingest import adventureworks as jaw
from hcrag_tpu.ingest import csv_ingest as jcsv
from hcrag_tpu.ingest import json_ingest as jjson
from hcrag_tpu.ingest import minipdf as jmini
from hcrag_tpu.ingest import pdf_ingest as jpdf
from hcrag_tpu_torch.ingest import adventureworks as taw
from hcrag_tpu_torch.ingest import csv_ingest as tcsv
from hcrag_tpu_torch.ingest import json_ingest as tjson
from hcrag_tpu_torch.ingest import minipdf as tmini
from hcrag_tpu_torch.ingest import pdf_ingest as tpdf
from hcrag_tpu_torch.testing import write_adventureworks_corpus

TABLES = ["Product", "ProductCategory", "ProductDescription", "ProductModel",
          "ProductModelProductDescription", "SalesOrderHeader", "SalesOrderDetail"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = write_adventureworks_corpus(tmp_path_factory.mktemp("aw") / "data", seed=0)
    (root / "Shop Notes.md").write_text(
        "# Shop notes\n\n" + " ".join(f"The HL Road Frame is made of alloy {i}."
                                      for i in range(120)))
    return root


@pytest.fixture(scope="module")
def builds(corpus):
    return jaw.build_adventureworks(corpus), taw.build_adventureworks(corpus)


@pytest.mark.parametrize("table", TABLES)
def test_csv_table_equals_jax(corpus, table):
    path = corpus / f"{table}.csv"
    assert tcsv.process_csv_table(path) == jcsv.process_csv_table(path)
    assert tcsv.analyze_data_patterns(tcsv.read_table(path)) == \
        jcsv.analyze_data_patterns(pd.read_csv(path, sep=";"))


def _docs(corpus, pattern):
    return sorted((corpus / "IngestedDocuments").glob(pattern))


def test_corpus_has_the_reference_shape(corpus):
    assert len(_docs(corpus, "*.pdf")) == 4
    assert len(_docs(corpus, "*.json")) == 6
    assert len(_docs(corpus, "*.jpg")) == 3
    rows = {t: len(pd.read_csv(corpus / f"{t}.csv", sep=";")) for t in TABLES}
    assert rows == dict(Product=100, ProductCategory=41, ProductDescription=100,
                        ProductModel=100, ProductModelProductDescription=100,
                        SalesOrderHeader=32, SalesOrderDetail=100)


@pytest.mark.parametrize("i", range(6))
def test_json_table_equals_jax(corpus, i):
    path = _docs(corpus, "*.json")[i]
    parent = path.stem.split(" Table ")[0]
    assert tjson.process_json_table(path, parent) == jjson.process_json_table(path, parent)
    data = json.loads(path.read_text())
    assert tjson.flatten_json_to_text(data) == jjson.flatten_json_to_text(data)


@pytest.mark.parametrize("i", range(4))
def test_pdf_equals_jax(corpus, i):
    path = _docs(corpus, "*.pdf")[i]
    text = tmini.extract_text(path.read_bytes())
    assert text == jmini.extract_text(path.read_bytes())
    assert text.startswith("Page 1: ") and "fi" in text  # ligature glyphs expanded
    assert tpdf.extract_text_from_pdf(path) == jpdf.extract_text_from_pdf(path) == text
    assert tpdf._extract_builtin(path.read_bytes()) == jpdf._extract_builtin(path.read_bytes())
    assert tpdf.process_pdf_document(path, path.stem) == jpdf.process_pdf_document(path, path.stem)


@pytest.mark.parametrize("size,overlap", [(800, 100), (200, 50), (1000, 100), (5000, 0)])
def test_chunk_text_equals_jax(corpus, size, overlap):
    text = (corpus / "Shop Notes.md").read_text()
    assert tpdf.chunk_text(text, size, overlap) == jpdf.chunk_text(text, size, overlap)


def test_unreadable_pdf_gives_the_placeholder(tmp_path):
    path = tmp_path / "Broken Scan.pdf"
    path.write_bytes(b"%PDF-1.4\n1 0 obj << /Type /Catalog >> endobj\n%%EOF\n")
    assert tpdf.extract_text_from_pdf(path) == jpdf.extract_text_from_pdf(path)
    assert "Text extraction failed" in tpdf.extract_text_from_pdf(path)


def test_document_grouping_equals_jax(corpus):
    j, t = jaw.analyze_ingested_documents(corpus), taw.analyze_ingested_documents(corpus)
    assert t == j
    assert sum(len(v["annotations"]) for v in t.values()) == 9


def test_process_corpus_equals_jax(corpus):
    texts, meta = taw.process_corpus(corpus)
    assert (texts, meta) == jaw.process_corpus(corpus)
    kinds = {m["type"] for m in meta}
    assert kinds == {"database_table", "json_table", "pdf_document", "text_document"}


def test_build_texts_metadata_and_graph_equal_jax(builds):
    jb, tb = builds
    assert tb.index.texts == jb.index.texts
    assert tb.index.metadata == jb.index.metadata
    for f in ("row_ptr", "col_idx", "edge_type", "node_to_row"):
        a, b = getattr(jb.graph, f), getattr(tb.graph, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert tb.graph.node_labels == jb.graph.node_labels
    assert tb.graph.node_texts == jb.graph.node_texts
    assert tb.graph.node_keys == jb.graph.node_keys
    assert tb.graph.directed_counts == jb.graph.directed_counts
    assert set(tb.graph.directed_counts) == {
        "SAME_CATEGORY", "SAME_MODEL", "SIMILAR_PRICE", "COMPATIBLE_PRODUCT",
        "COMPLEMENTARY_PRODUCT", "DESCRIBED_BY", "ANNOTATION"}


def test_build_index_arrays_equal_jax(builds):
    jb, tb = builds
    for f in ("emb", "entity_bits", "entity_counts", "type_ids", "graph_ids"):
        a, b = np.asarray(getattr(jb.index, f)), np.asarray(getattr(tb.index, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert tb.index.vocab.entity_to_id == jb.index.vocab.entity_to_id
    assert tb.index.generation_info == jb.index.generation_info
    assert (tb.index.graph_ids >= 0).sum() > 100  # products, categories, documents, tables


def test_build_with_embed_fn_and_link_rules(builds, corpus):
    jb, _ = builds
    fn = lambda texts: np.ones((len(texts), 8), np.float32)  # noqa: E731
    tb = taw.build_adventureworks(corpus, embed_fn=fn)
    j2 = jaw.build_adventureworks(corpus, embed_fn=fn)
    assert tb.index.generation_info == j2.index.generation_info
    g, n2r = taw.link_index_and_graph(jb.index.metadata, tb.graph)
    jg, jn2r = jaw.link_index_and_graph(jb.index.metadata, jb.graph)
    assert np.array_equal(g, jg) and np.array_equal(n2r, jn2r)


@pytest.mark.parametrize("value", ["1431,50", "3578.27", "0,00", "", "abc", "12", None,
                                   float("nan"), 2.5, 7])
def test_parse_price_equals_jax(value):
    assert taw._parse_price("" if value == "" else value) == jaw._parse_price(value)


# One case per behaviour of pandas.read_csv(sep=";") the texts depend on.
QUIRKS = {
    "int_column_with_missing_cell_prints_floats":
        "ProductModelID;Name\n5;Frame A\n;Frame B\n7;Frame C\n",
    "default_na_strings_dropped":
        "ID;Color;Size;Note\n1;NA;N/A;NULL\n2;nan;None;\n3;Red;#N/A;n/a\n4;<NA>;-nan;null\n",
    "floats_print_as_repr":
        "ID;Weight;Ratio;Big\n1;1.50;1e3;.5\n2;2.25;-0.0;inf\n3;10;3.;1E-5\n",
    "true_false_column_becomes_bool":
        "ID;Online;Flag\n1;True;TRUE\n2;false;\n3;FALSE;true\n",
    "quoted_field_holds_the_separator":
        'ID;Catalog\n1;"Sizes: S; M; L"\n2;"plain ""quoted"" text"\n3;x\n',
    "unique_runs_on_inferred_values":
        "ID;Cost\n1;1.0\n2;1\n3;1.00\n4;2\n5;2.0\n",
    "all_number_row_upcast_to_float":
        "SalesOrderID;Qty;Price\n10;2;3.5\n11;4;1.25\n",
    "decimal_comma_stays_text":
        "ProductID;ListPrice\n680;1431,50\n681;0,00\n682;3578,27\n",
    "hex_blob_is_a_high_field":
        "ProductID;ThumbNailPhoto\n" + "".join(
            f"{680 + i};0x{(i * 7919 + 13) ** 9:X}47494638396150003100F70000\n"
            for i in range(12)),
    "ints_with_sign_space_and_zeros":
        "ID;Code;Other\n+3; 7 ;007\n4;8;010\n",
    "blank_lines_and_repeated_header":
        "ID;Name;Name\n1;a;b\n\n  \n2;c;d\n;;\n",
    "mixed_number_and_text_column":
        "ID;Size\n1;58\n2;M\n3; 62\n",
}


@pytest.mark.parametrize("case", sorted(QUIRKS))
def test_pandas_behaviour_equals_jax(tmp_path, case):
    path = tmp_path / "Table.csv"
    path.write_text(QUIRKS[case])
    assert tcsv.process_csv_table(path) == jcsv.process_csv_table(path)
    assert tcsv.analyze_data_patterns(tcsv.read_table(path)) == \
        jcsv.analyze_data_patterns(pd.read_csv(path, sep=";"))


def test_quirk_cases_show_their_behaviour(tmp_path):
    """The cases above exercise what their names say (a guard on the data)."""
    def texts(case):
        path = tmp_path / f"{case}.csv"
        path.write_text(QUIRKS[case])
        return tcsv.process_csv_table(path)

    t, m = texts("int_column_with_missing_cell_prints_floats")
    assert m[0]["entity_id"] == "5.0" and "ProductModelID" not in t[1]
    t, _ = texts("default_na_strings_dropped")
    assert all("Color" not in x for x in t[:2]) and "Color: Red" in t[2]
    t, _ = texts("all_number_row_upcast_to_float")
    assert "SalesOrderID: 10.0" in t[0]
    t, _ = texts("true_false_column_becomes_bool")
    assert "Online: False" in t[1]
    t, _ = texts("quoted_field_holds_the_separator")
    assert "Sizes: S; M; L" in t[0]
