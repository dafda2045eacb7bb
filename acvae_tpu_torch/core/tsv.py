"""Tab-separated tables read and written as pandas reads and writes them.

``cli concat_csv`` is ``pd.concat`` of ``pd.read_csv(path, sep="\\t")``
written back with ``to_csv(sep="\\t", index=False)`` in the JAX package
(utils/concat_csv.py); the card's machine has no pandas, so the port does
the same with the csv module and these rules of pandas' defaults:

* a column's kind comes from its values: ``int`` when each is an integer
  literal (``0001`` is 1, surrounding spaces dropped), ``float`` when each
  parses as a float, ``bool`` for ``True``/``TRUE``/``true`` and the
  falses, else ``str`` (kept as written); an empty field and pandas' other
  NA spellings (``NA``, ``nan``, ``None``, ...) are missing, which makes an
  int column float, and a column of nothing but missing values is float;
* the inputs' columns join in the order they first appear (a column an
  input lacks is missing there); ints and floats of several inputs make a
  float column, and any other mixture keeps each value as its own input
  read it;
* ints are written without leading zeros, floats in Python's shortest
  form (``1.0``, ``1e+20``, ``inf``), missing values as empty fields, with
  the csv module's minimal quoting.

Where pandas itself differs by version the port follows the rule above: a
column that is bool in one input and numeric in another keeps ``True``
where pandas 3 writes ``1`` (``tests/test_torch_cli_tools.py``).
"""
from __future__ import annotations

import csv
import re
from typing import Any, List, Sequence

# pandas' default NA spellings (pandas._libs.parsers.STR_NA_VALUES)
NA_VALUES = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"})
_TRUE, _FALSE = ("True", "TRUE", "true"), ("False", "FALSE", "false")
_INT = re.compile(r"^[+-]?\d+$")


def _is_float(v: str) -> bool:
    if "_" in v:          # Python's float() reads 1_0; pandas does not
        return False
    try:
        float(v)
    except ValueError:
        return False
    return True


def _column(raw: List[str]) -> List[Any]:
    """One input's column as pandas' read_csv types it (None: missing)."""
    vals = [None if v in NA_VALUES else v for v in raw]
    present = [v.strip() for v in vals if v is not None]
    if all(_INT.match(v) for v in present):
        # (a column of nothing but missing values is float: no value to type)
        conv = float if len(present) < len(vals) else int
    elif all(_is_float(v) for v in present):
        conv = float
    elif all(v in _TRUE + _FALSE for v in present):
        conv = _TRUE.__contains__
    else:
        return vals
    return [None if v is None else conv(v.strip()) for v in vals]


def read_tsv(path: str) -> dict:
    """{column: typed values}, in the file's column order."""
    with open(path, newline="") as f:
        rows = [r for r in csv.reader(f, delimiter="\t") if r]
    header, body = rows[0], rows[1:]
    return {name: _column([r[i] if i < len(r) else "" for r in body])
            for i, name in enumerate(header)}


def _kind(values: List[Any]) -> str:
    """The type of one input's column (each holds one): float when every
    value is missing."""
    return next((type(v).__name__ for v in values if v is not None), "float")


def _text(v: Any, as_float: bool) -> str:
    if v is None:
        return ""
    if as_float or isinstance(v, float):
        return repr(float(v))
    return str(v)


def concat_tsv(paths: Sequence[str], output: str) -> None:
    """The rows of every table at ``paths`` into one TSV at ``output``."""
    tables = [read_tsv(p) for p in paths]
    columns: List[str] = []
    for t in tables:
        columns += [c for c in t if c not in columns]
    merged = {}
    for c in columns:
        parts = [t.get(c, [None] * len(next(iter(t.values()), [])))
                 for t in tables]
        kinds = {_kind(p) for p in parts}
        as_float = kinds <= {"int", "float"} and "float" in kinds
        merged[c] = [_text(v, as_float) for p in parts for v in p]
    with open(output, "w", newline="") as f:
        w = csv.writer(f, delimiter="\t", lineterminator="\n")
        w.writerow(columns)
        w.writerows(zip(*merged.values()))
