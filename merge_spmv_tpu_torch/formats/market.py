"""Matrix Market (.mtx) ingest.

Behavioral parity with the reference parser (sparse_matrix.h:217-380):

* banner handled by substring detection of ``symmetric`` / ``skew`` /
  ``array`` (anything else, e.g. ``general``/``pattern``, falls through),
* coordinate entries are 1-based and converted to 0-based,
* a missing value token (pattern files) takes ``default_value``,
* ``symmetric`` duplicates every off-diagonal entry mirrored, ``skew``
  negates the mirrored value; diagonal entries are not mirrored,
* duplicate (row, col) entries are retained as distinct nonzeros,
* ``array`` banners are dense column-major value lists.

The implementation is vectorized NumPy (token-split of the whole payload)
rather than a per-line scalar loop; a C++ fast path of the parser and the
writer lives in csrc/market_io.cpp (formats/native_io.py), used by
CooMatrix.from_market and write_market where it builds.
"""

from __future__ import annotations

import numpy as np

__all__ = ["read_market", "write_market", "MarketHeader", "parse_header"]


class MarketHeader:
    """Parsed banner + size line of a Matrix Market file."""

    def __init__(self, symmetric: bool, skew: bool, array: bool,
                 num_rows: int, num_cols: int, num_entries: int):
        self.symmetric = symmetric
        self.skew = skew
        self.array = array
        self.num_rows = num_rows
        self.num_cols = num_cols
        self.num_entries = num_entries  # file entry count (pre-expansion)

    def __repr__(self):
        return (f"MarketHeader(symmetric={self.symmetric}, skew={self.skew}, "
                f"array={self.array}, shape=({self.num_rows},{self.num_cols}), "
                f"entries={self.num_entries})")


def parse_header(text_lines) -> tuple:
    """Split header (banner/comments + size line) from data lines.

    Returns (MarketHeader, first_data_line_index).
    """
    symmetric = skew = array = False
    size_line = None
    data_start = None
    for i, line in enumerate(text_lines):
        s = line.strip()
        if not s:
            continue
        if s.startswith("%"):
            if s.startswith("%%"):
                symmetric = "symmetric" in s
                skew = "skew" in s
                array = "array" in s
            continue
        size_line = s
        data_start = i + 1
        break
    if size_line is None:
        raise ValueError("MARKET parse error: no size line found")
    parts = size_line.split()
    if array:
        if len(parts) < 2:
            raise ValueError(f"MARKET parse error: invalid array size line: {size_line!r}")
        nr, nc = int(parts[0]), int(parts[1])
        ne = nr * nc
    else:
        if len(parts) < 3:
            raise ValueError(f"MARKET parse error: invalid size line: {size_line!r}")
        nr, nc, ne = int(parts[0]), int(parts[1]), int(parts[2])
    return MarketHeader(symmetric, skew, array, nr, nc, ne), data_start


def _tokenize(data_lines):
    """Token-split all data lines at once; returns (tokens, tokens_per_line)."""
    payload = "\n".join(data_lines)
    toks = payload.split()
    return toks


def read_market(path: str, default_value: float = 1.0,
                value_dtype=np.float64, index_dtype=np.int32):
    """Read a .mtx file → (num_rows, num_cols, rows, cols, vals) COO arrays.

    Mirrors sparse_matrix.h:217-380 semantics (see module docstring).
    """
    with open(path, "r") as f:
        text = f.read()
    lines = text.splitlines()
    header, data_start = parse_header(lines)

    # Strip comment/blank lines inside the data section (rare but legal).
    data_lines = [l for l in lines[data_start:] if l.strip() and not l.lstrip().startswith("%")]

    if header.array:
        toks = _tokenize(data_lines)
        vals = np.asarray(toks, dtype=value_dtype)
        if vals.size != header.num_entries:
            raise ValueError(
                f"MARKET parse error: expected {header.num_entries} array values, got {vals.size}")
        # Column-major enumeration (sparse_matrix.h:320-325).
        idx = np.arange(vals.size, dtype=np.int64)
        cols = (idx // header.num_rows).astype(index_dtype)
        rows = (idx - header.num_rows * (idx // header.num_rows)).astype(index_dtype)
        return header.num_rows, header.num_cols, rows, cols, vals

    n = len(data_lines)
    if n < header.num_entries:
        raise ValueError(
            f"MARKET parse error: expected {header.num_entries} entries, file has {n}")
    if n > header.num_entries:
        data_lines = data_lines[:header.num_entries]
        n = header.num_entries

    toks = _tokenize(data_lines)
    if n == 0:
        rows = np.zeros(0, dtype=index_dtype)
        cols = np.zeros(0, dtype=index_dtype)
        vals = np.zeros(0, dtype=value_dtype)
        return header.num_rows, header.num_cols, rows, cols, vals

    tpl, rem = divmod(len(toks), n)
    if rem != 0 or tpl < 2:
        # Ragged lines — fall back to slow per-line parsing.
        return _read_coordinate_slow(header, data_lines, default_value,
                                     value_dtype, index_dtype)

    arr = np.asarray(toks).reshape(n, tpl)
    rows = arr[:, 0].astype(np.int64) - 1
    cols = arr[:, 1].astype(np.int64) - 1
    if tpl >= 3:
        # Real / integer field; for complex-like extra columns take the first
        # value column (reference strtod reads only one value).
        vals = arr[:, 2].astype(value_dtype)
    else:
        vals = np.full(n, default_value, dtype=value_dtype)

    return _expand_symmetry(header, rows, cols, vals, index_dtype)


def _read_coordinate_slow(header, data_lines, default_value, value_dtype, index_dtype):
    n = len(data_lines)
    rows = np.empty(n, dtype=np.int64)
    cols = np.empty(n, dtype=np.int64)
    vals = np.empty(n, dtype=value_dtype)
    for i, line in enumerate(data_lines):
        p = line.split()
        rows[i] = int(p[0]) - 1
        cols[i] = int(p[1]) - 1
        vals[i] = value_dtype(p[2]) if len(p) > 2 else default_value
    return _expand_symmetry(header, rows, cols, vals, index_dtype)


def _expand_symmetry(header, rows, cols, vals, index_dtype):
    if header.symmetric:
        off = rows != cols
        sign = -1.0 if header.skew else 1.0
        mirror_rows, mirror_cols, mirror_vals = cols[off], rows[off], sign * vals[off]
        rows = np.concatenate([rows, mirror_rows])
        cols = np.concatenate([cols, mirror_cols])
        vals = np.concatenate([vals, mirror_vals])
    return (header.num_rows, header.num_cols,
            rows.astype(index_dtype), cols.astype(index_dtype), vals)


def write_market(path: str, num_rows: int, num_cols: int, rows, cols, vals,
                 comment: str = "generated by merge_spmv_tpu_torch"):
    """Write a general real coordinate .mtx file (round-trip/testing aid).

    Each entry is ``f"{r + 1} {c + 1} {float(v)!r}"``.  The C++ writer
    produces the same bytes in parallel (formats/native_io.py); the Python
    loop runs where it is unavailable.
    """
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    vals = np.asarray(vals)
    header = ("%%MatrixMarket matrix coordinate real general\n"
              f"% {comment}\n"
              f"{num_rows} {num_cols} {len(vals)}\n")
    if (len(rows) == len(cols) == len(vals) and rows.dtype.kind in "iu" and cols.dtype.kind in "iu"
            and vals.dtype.kind in "fiu"):
        from merge_spmv_tpu_torch.formats import native_io
        if native_io.write_market(path, header, rows, cols, vals):
            return
    with open(path, "w") as f:
        f.write(header)
        for r, c, v in zip(rows, cols, vals):
            f.write(f"{int(r) + 1} {int(c) + 1} {float(v)!r}\n")
