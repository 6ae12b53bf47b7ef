"""The 2D merge-path decomposition.

CsrMV is recast as the merge of two sorted lists (Merrill & Garland SC'16):

* list A = row *end* offsets (``row_offsets[1:]``, length num_rows),
* list B = the natural numbers indexing the nonzeros (0..nnz-1, implicit).

The merge path has length ``num_rows + num_nonzeros``; splitting it at equal
diagonals yields equal-work shares regardless of row-length skew.  The split
coordinate on diagonal ``d`` is found by binary search (reference:
cpu_spmv.cpp:223-245, cub/thread/thread_search.cuh:53-84).

Because list B is a counting sequence, the 2D binary search collapses to a
1D ``searchsorted`` over the strictly increasing key
``row_end_offsets[r] + r``:

    consume-A condition  a[x] <= d - x - 1   ⇔   a[x] + x < d

so the split x is the first index with ``a[x] + x >= d``.  This turns the
reference's per-tile search kernel (dispatch_spmv_orig.cuh:104-143) into one
vectorized ``torch.searchsorted`` over all tile diagonals, run once per
matrix when the operator is built.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "merge_path_search",
    "merge_path_search_np",
    "merge_tile_coordinates",
    "merge_tile_coordinates_np",
    "num_merge_tiles",
]


# ---------------------------------------------------------------------- #
# Host (NumPy)
# ---------------------------------------------------------------------- #

def merge_path_search_np(diagonals, row_end_offsets, num_nonzeros: int):
    """Split coordinates for one or many diagonals, on the host.

    Returns (x, y): x = rows consumed (index into list A), y = nonzeros
    consumed (index into list B), with x + y == diagonal.
    """
    a = np.asarray(row_end_offsets, dtype=np.int64)
    d = np.asarray(diagonals, dtype=np.int64)
    a_len = a.shape[0]
    key = a + np.arange(a_len, dtype=np.int64)  # strictly increasing
    x = np.searchsorted(key, d, side="left")
    # Clamp to the legal window [max(d - nnz, 0), min(d, a_len)]
    # (cpu_spmv.cpp:231-232); the searchsorted result already satisfies the
    # upper bound only when d <= a_len + max(key); clamp explicitly.
    x = np.minimum(np.maximum(x, np.maximum(d - num_nonzeros, 0)),
                   np.minimum(d, a_len))
    y = d - x
    return x.astype(np.int64), y.astype(np.int64)


def merge_path_search(diagonals, row_end_offsets, num_nonzeros: int):
    """Device (torch) version: vectorized over `diagonals`.

    One ``torch.searchsorted`` replaces DeviceSpmvSearchKernel
    (dispatch_spmv_orig.cuh:104-143).  The key is formed in int64, so it
    cannot wrap; callers that hand the coordinates to the int32 kernel
    check ``num_rows + nnz < 2**31`` first (ops/plan.py).  Returns int32
    tensors on the device of ``row_end_offsets``.
    """
    a = torch.as_tensor(row_end_offsets).to(torch.int64)
    a_len = a.shape[0]
    d = torch.as_tensor(diagonals, device=a.device).to(torch.int64)
    key = a + torch.arange(a_len, dtype=torch.int64, device=a.device)
    x = torch.searchsorted(key, d, side="left")
    x = torch.minimum(torch.maximum(x, (d - num_nonzeros).clamp(min=0)),
                      d.clamp(max=a_len))
    y = d - x
    return x.to(torch.int32), y.to(torch.int32)


# ---------------------------------------------------------------------- #
# Tile planning
# ---------------------------------------------------------------------- #

def num_merge_tiles(num_rows: int, num_nonzeros: int, tile_items: int) -> int:
    """ceil((rows + nnz) / TILE_ITEMS)  (dispatch_spmv_orig.cuh:608-616)."""
    total = num_rows + num_nonzeros
    return max(1, -(-total // tile_items))


def merge_tile_coordinates_np(row_end_offsets, num_nonzeros: int,
                              tile_items: int):
    """Host tile split: returns (tile_rows, tile_nnz), each [num_tiles + 1].

    Tile t owns merge items [t*tile_items, (t+1)*tile_items): rows
    [tile_rows[t], tile_rows[t+1]) complete inside it and nonzeros
    [tile_nnz[t], tile_nnz[t+1]).
    """
    a = np.asarray(row_end_offsets)
    n_tiles = num_merge_tiles(len(a), num_nonzeros, tile_items)
    diags = np.minimum(np.arange(n_tiles + 1, dtype=np.int64) * tile_items,
                       len(a) + num_nonzeros)
    x, y = merge_path_search_np(diags, a, num_nonzeros)
    return x.astype(np.int32), y.astype(np.int32)


def merge_tile_coordinates(row_end_offsets, num_nonzeros: int,
                           tile_items: int):
    """Device tile split: (tile_rows, tile_nnz) int32 tensors, each
    [num_tiles + 1], on the device of ``row_end_offsets``."""
    a = torch.as_tensor(row_end_offsets)
    a_len = a.shape[0]
    n_tiles = num_merge_tiles(a_len, num_nonzeros, tile_items)
    diags = torch.clamp(
        torch.arange(n_tiles + 1, dtype=torch.int64, device=a.device)
        * tile_items, max=a_len + num_nonzeros)
    return merge_path_search(diags, a, num_nonzeros)
