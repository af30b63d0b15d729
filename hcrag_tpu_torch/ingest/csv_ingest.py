"""Schema-adaptive CSV ingestion on the standard library's `csv`.

Counterpart of `hcrag_tpu/ingest/csv_ingest.py`, which reads each table
with `pandas.read_csv(sep=";")`.  The port's machines have no pandas, so
`read_table` reads the file with `csv` and infers each column's type the
way pandas' C parser does, as far as the texts depend on it:

  * pandas' default NA strings ("", "NA", "N/A", "NULL", "nan", "None",
    ...) are missing values and never enter a text;
  * a column whose other cells all read as integers ("+3", " 7 ", "007")
    holds ints, and floats when it also has a missing cell, so its cells
    print as "5.0";
  * a column of decimal numbers ("1.50", "1e3", ".5", "inf") holds floats,
    printed as Python's `repr` ("1.5", "1000.0");
  * a column of "True"/"TRUE"/"true" and their "False" forms holds bools
    (objects with a missing cell), printed "True" / "False";
  * any other column keeps its cells as written (quoted fields may hold
    the separator);
  * a row whose cells are all numbers and at least one a float is read as
    floats throughout, as `DataFrame.iterrows` upcasts it;
  * blank lines are skipped, and a repeated header name becomes "name.1".

Within a table the texts and metadata are equal to the JAX package's
("Table: {name}. {col}: {val}. ..." with the high / medium / low field
prioritization and the same id-column rule).
"""

from __future__ import annotations

import csv
import math
import re
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

#: pandas' default missing-value strings (`pandas.read_csv`'s `na_values`).
NA_STRINGS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null",
})
_TRUE = frozenset({"True", "TRUE", "true"})
_FALSE = frozenset({"False", "FALSE", "false"})
_INT_RE = re.compile(r"^\s*[+-]?[0-9]+\s*$")
_FLOAT_RE = re.compile(
    r"^\s*[+-]?(?:[0-9]+\.?[0-9]*|\.[0-9]+)(?:[eE][+-]?[0-9]+)?\s*$"
    r"|^[+-]?(?:inf|infinity)$",
    re.IGNORECASE,
)
#: The value of a missing cell, as pandas holds it.
NA = float("nan")


def is_na(value) -> bool:
    """`pandas.isna` for the values a table holds (None for an absent
    column, NaN for a missing cell)."""
    return value is None or (isinstance(value, float) and math.isnan(value))


def _infer(cells: List[str]) -> Tuple[str, list]:
    """(kind, values) of one column's raw cells: kind is "int", "float",
    "bool", "object" (bools with missing cells) or "str"."""
    present = [c for c in cells if c not in NA_STRINGS]
    has_na = len(present) < len(cells)
    if not present:
        return "float", [NA] * len(cells)
    if all(_INT_RE.match(c) for c in present):
        if has_na:
            return "float", [NA if c in NA_STRINGS else float(int(c)) for c in cells]
        return "int", [int(c) for c in cells]
    if all(_FLOAT_RE.match(c) for c in present):
        return "float", [NA if c in NA_STRINGS else float(c.strip()) for c in cells]
    if all(c in _TRUE or c in _FALSE for c in present):
        return ("object" if has_na else "bool"), [
            NA if c in NA_STRINGS else c in _TRUE for c in cells
        ]
    return "str", [NA if c in NA_STRINGS else c for c in cells]


class Table:
    """A CSV table as typed columns (the slice of `pandas.DataFrame` the
    ingestion uses)."""

    def __init__(self, columns: List[str], kinds: Dict[str, str],
                 values: Dict[str, list], n_rows: int):
        self.columns = columns
        self.kinds = kinds
        self._values = values
        self.n_rows = n_rows
        numeric = all(kinds[c] in ("int", "float") for c in columns)
        #: `iterrows` reads an all-number row with a float column as floats.
        self._row_as_float = numeric and any(kinds[c] == "float" for c in columns)

    def __getitem__(self, column: str) -> list:
        return self._values[column]

    def non_null(self, column: str) -> list:
        return [v for v in self._values[column] if not is_na(v)]

    def rows(self) -> Iterator[Tuple[int, Dict[str, object]]]:
        """(position, {column: value}) per row, with `iterrows`' upcast."""
        for i in range(self.n_rows):
            row = {c: self._values[c][i] for c in self.columns}
            if self._row_as_float:
                row = {c: float(v) for c, v in row.items()}
            yield i, row


def _dedupe_header(names: Sequence[str]) -> List[str]:
    out: List[str] = []
    counts: Dict[str, int] = {}
    for name in names:
        if name in counts:
            k = counts[name]
            while f"{name}.{k}" in counts:
                k += 1
            counts[name] = k + 1
            name = f"{name}.{k}"
        counts.setdefault(name, 1)
        out.append(name)
    return out


def read_table(path, sep: str = ";") -> Table:
    """Read a delimited file as `pandas.read_csv(path, sep=sep)` types it
    (see the module's docstring).  A row with more cells than the header
    raises."""
    with open(path, newline="", encoding="utf-8-sig") as f:
        rows = [
            r for r in csv.reader(f, delimiter=sep)
            if r and not (len(r) == 1 and not r[0].strip())
        ]
    if not rows:
        raise ValueError(f"{path}: no columns to parse")
    columns = _dedupe_header(rows[0])
    width = len(columns)
    body = rows[1:]
    for i, r in enumerate(body):
        if len(r) > width:
            raise ValueError(
                f"{path}: row {i} has {len(r)} fields, the header {width}")
    kinds: Dict[str, str] = {}
    values: Dict[str, list] = {}
    for j, col in enumerate(columns):
        cells = [r[j] if j < len(r) else "" for r in body]
        kinds[col], values[col] = _infer(cells)
    return Table(columns, kinds, values, len(body))


def analyze_data_patterns(table: Table) -> Dict[str, Dict]:
    """Categorize columns by semantic importance (embedding_generator.py:28-61).

    high:   unique_ratio > 0.9 and avg_length > 20 (descriptions, names)
    medium: unique_ratio > 0.8, or avg_length > 10
    low:    everything else (short codes, numbers, flags)

    avg_length is computed over the first 10 non-null values, unique_ratio
    over all non-null values.
    """
    field_analysis: Dict[str, Dict] = {}
    for col in table.columns:
        non_null = table.non_null(col)
        sample_values = [str(v) for v in non_null[:10]]
        if not sample_values:
            continue
        avg_length = float(np.mean([len(v) for v in sample_values]))
        unique_ratio = len(set(non_null)) / len(non_null)
        if unique_ratio > 0.9 and avg_length > 20:
            importance = "high"
        elif unique_ratio > 0.8:
            importance = "medium"
        elif avg_length > 10:
            importance = "medium"
        else:
            importance = "low"
        field_analysis[col] = {
            "importance": importance,
            "avg_length": avg_length,
            "unique_ratio": unique_ratio,
            "sample_values": sample_values[:3],
        }
    return field_analysis


def smart_text_representation(
    row: Dict[str, object],
    field_analysis: Dict[str, Dict],
    table_name: Optional[str] = None,
) -> str:
    """Prioritized row text (embedding_generator.py:63-104): every
    high-importance field, the first 3 medium, the first 2 low, joined by
    ". ", after "Table: {name}"."""
    high: List[str] = []
    medium: List[str] = []
    low: List[str] = []
    for col, analysis in field_analysis.items():
        val = row.get(col)
        if not is_na(val) and str(val).strip():
            field_info = f"{col}: {str(val).strip()}"
            if analysis["importance"] == "high":
                high.append(field_info)
            elif analysis["importance"] == "medium":
                medium.append(field_info)
            else:
                low.append(field_info)
    parts: List[str] = []
    if table_name:
        parts.append(f"Table: {table_name}")
    parts.extend(high)
    parts.extend(medium[:3])
    parts.extend(low[:2])
    return ". ".join(parts)


def find_entity_id_column(table: Table) -> Optional[str]:
    """First column whose name contains 'id' (embedding_generator.py:140-141)."""
    id_columns = [c for c in table.columns if "id" in c.lower()]
    return id_columns[0] if id_columns else None


def process_csv_table(csv_path, sep: str = ";") -> Tuple[List[str], List[dict]]:
    """CSV table -> (texts, metadata), one entry per non-empty row text;
    metadata {id, type=database_table, table_name, row_index, source_file
    [, entity_id]} (embedding_generator.py:131-146)."""
    csv_path = Path(csv_path)
    table = read_table(csv_path, sep=sep)
    table_name = csv_path.stem
    field_analysis = analyze_data_patterns(table)  # once per table
    id_col = find_entity_id_column(table)

    texts: List[str] = []
    metadata: List[dict] = []
    for idx, row in table.rows():
        text = smart_text_representation(row, field_analysis, table_name)
        if not text.strip():
            continue
        meta = {
            "id": f"{table_name}_{idx}",
            "type": "database_table",
            "table_name": table_name,
            "row_index": int(idx),
            "source_file": str(csv_path),
        }
        if id_col is not None:
            entity_id = row.get(id_col)
            if not is_na(entity_id):
                s = str(entity_id)
                meta["entity_id"] = int(entity_id) if s.isdigit() else s
        texts.append(text)
        metadata.append(meta)
    return texts, metadata
