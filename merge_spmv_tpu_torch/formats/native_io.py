"""ctypes bindings for the port's host library (csrc/market_io.cpp).

The C++ fast paths of the data layer:

* ``read_market`` — Matrix Market parser (reference parity with
  CooMatrix::InitMarket, sparse_matrix.h:217-380),
* ``coo_to_csr`` — stable (row, col) sort + row-offset build with
  empty-row backfill (CsrMatrix::Init, sparse_matrix.h:666-728),
* ``write_market`` — the text of formats/market.py's writer, byte for
  byte, formatted in parallel.

The library is built by g++ at first use (utils/host_build.py, never at
import) into the package's gitignored build/ directory.  Every entry point
has a NumPy counterpart in formats/market.py and formats/csr.py, which the
callers use where the library is unavailable; the native paths exist
because ingest is the dominant host cost of a corpus sweep (the
reference's strtod loop is its I/O hot path).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from merge_spmv_tpu_torch.utils import host_build

__all__ = ["available", "build_error", "read_market", "coo_to_csr",
           "write_market"]

_LOCK = threading.Lock()
_LIB = None
_TRIED = False
_ERROR = None


def _load():
    global _LIB, _TRIED, _ERROR
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        try:
            lib = ctypes.CDLL(str(host_build.build_library("market_io")))
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            _ERROR = str(e)
            return None
        c_i64 = ctypes.c_int64
        c_p = ctypes.c_void_p
        lib.msp_read_market.restype = c_p
        lib.msp_read_market.argtypes = [ctypes.c_char_p, ctypes.c_double]
        lib.msp_coo_num_rows.restype = c_i64
        lib.msp_coo_num_rows.argtypes = [c_p]
        lib.msp_coo_num_cols.restype = c_i64
        lib.msp_coo_num_cols.argtypes = [c_p]
        lib.msp_coo_nnz.restype = c_i64
        lib.msp_coo_nnz.argtypes = [c_p]
        lib.msp_coo_error.restype = ctypes.c_char_p
        lib.msp_coo_error.argtypes = [c_p]
        lib.msp_coo_copy.restype = None
        lib.msp_coo_copy.argtypes = [c_p, c_p, c_p, c_p]
        lib.msp_coo_free.restype = None
        lib.msp_coo_free.argtypes = [c_p]
        lib.msp_coo_to_csr.restype = None
        lib.msp_coo_to_csr.argtypes = [c_i64, c_i64, c_p, c_p, c_p,
                                       c_p, c_p, c_p]
        if hasattr(lib, "msp_write_market"):
            lib.msp_write_market.restype = ctypes.c_int
            lib.msp_write_market.argtypes = [ctypes.c_char_p,
                                             ctypes.c_char_p, c_i64,
                                             c_p, c_p, c_p]
        _LIB = lib
        return _LIB


def available() -> bool:
    """True when the library is built (building it on the first call)."""
    return _load() is not None


def build_error():
    """Why the library is unavailable (None when it loaded or was never
    tried)."""
    return _ERROR


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def read_market(path: str, default_value: float = 1.0,
                value_dtype=np.float64):
    """Parse a .mtx file via the native library.

    Returns (num_rows, num_cols, rows, cols, vals).
    """
    lib = _load()
    if lib is None:
        raise ImportError("native host library unavailable")
    handle = lib.msp_read_market(os.fsencode(path), float(default_value))
    try:
        err = lib.msp_coo_error(handle)
        if err:
            raise ValueError(f"MARKET parse error: {err.decode()}")
        nr = lib.msp_coo_num_rows(handle)
        nc = lib.msp_coo_num_cols(handle)
        nnz = lib.msp_coo_nnz(handle)
        rows = np.empty(nnz, dtype=np.int32)
        cols = np.empty(nnz, dtype=np.int32)
        vals = np.empty(nnz, dtype=np.float64)
        lib.msp_coo_copy(handle, _ptr(rows), _ptr(cols), _ptr(vals))
    finally:
        lib.msp_coo_free(handle)
    if np.dtype(value_dtype) != np.float64:
        vals = vals.astype(value_dtype)
    return int(nr), int(nc), rows, cols, vals


def coo_to_csr(num_rows: int, rows, cols, vals):
    """Native COO→CSR: returns (row_offsets, cols_sorted, vals_sorted).

    Stable (row, col) order; duplicates retained; empty rows backfilled
    (sparse_matrix.h:666-728 semantics).  Row ids must lie in
    [0, num_rows).
    """
    lib = _load()
    if lib is None:
        raise ImportError("native host library unavailable")
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    cols = np.ascontiguousarray(cols, dtype=np.int32)
    vals64 = np.ascontiguousarray(vals, dtype=np.float64)
    nnz = len(vals64)
    row_offsets = np.empty(num_rows + 1, dtype=np.int32)
    out_cols = np.empty(nnz, dtype=np.int32)
    out_vals = np.empty(nnz, dtype=np.float64)
    lib.msp_coo_to_csr(nnz, int(num_rows), _ptr(rows), _ptr(cols),
                       _ptr(vals64), _ptr(row_offsets), _ptr(out_cols),
                       _ptr(out_vals))
    vals_dtype = np.asarray(vals).dtype
    if vals_dtype != np.float64:
        out_vals = out_vals.astype(vals_dtype)
    return row_offsets, out_cols, out_vals


def write_market(path: str, header: str, rows, cols, vals) -> bool:
    """Write ``header`` then one ``"r+1 c+1 repr(v)"`` line per entry.
    Returns False, writing nothing, where the library or its writer
    (which needs floating-point ``std::to_chars``) is unavailable; raises
    OSError if the file cannot be written."""
    lib = _load()
    if lib is None or not hasattr(lib, "msp_write_market"):
        return False
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int64)
    vals = np.ascontiguousarray(vals, dtype=np.float64)
    rc = lib.msp_write_market(os.fsencode(path), header.encode(), len(vals),
                              _ptr(rows), _ptr(cols), _ptr(vals))
    if rc != 0:
        raise OSError(rc, os.strerror(rc) if rc > 0 else "write failed",
                      path)
    return True
