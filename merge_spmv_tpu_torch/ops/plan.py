"""Two-phase plan contract and the Hopper tile policy.

Counterpart of merge_spmv_tpu/ops/plan.py.  The reference selects a
per-SM tuning policy at compile time (dispatch_spmv_orig.cuh:262-445): a
thread-block size and a number of merge items per thread, whose product is
the merge tile.  The plan pins the same shape-static facts: tile size, tile
count, backend, and the policy ``threads_per_block x items_per_thread ==
tile_items`` the CUDA tile kernel (csrc/merge_csrmv.cu) is launched with.

The TPU plan's VMEM, gather-list and x-window fields have no counterpart
here: Hopper gathers ``x[col]`` through its caches in hardware.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from merge_spmv_tpu_torch.ops.merge_path import num_merge_tiles
from merge_spmv_tpu_torch.utils.device import dtype_name, itemsize

__all__ = ["SpmvPlan", "make_plan", "ITEMS_PER_THREAD", "MIN_TILE_ITEMS",
           "MAX_TILE_ITEMS"]

# Merge items each thread consumes in sequence (CUB's ITEMS_PER_THREAD).
ITEMS_PER_THREAD = 8
# One warp is the smallest block; 512 threads the largest, which keeps the
# block's shared memory (a row end and a partial per tile row) in the
# default 48 KB for every value type.
MIN_TILE_ITEMS = 32 * ITEMS_PER_THREAD
MAX_TILE_ITEMS = 512 * ITEMS_PER_THREAD
DEFAULT_TILE_ITEMS = 256 * ITEMS_PER_THREAD

# The kernel indexes merge items, rows and nonzeros with int32.
_INT32_LIMIT = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class SpmvPlan:
    """Shape-static execution plan for CsrMV / CsrMM."""
    num_rows: int
    num_cols: int
    num_nonzeros: int
    dtype: str                 # value dtype name ("float32", ...)
    tile_items: int            # merge items per thread block
    num_tiles: int             # ceil((rows + nnz) / tile_items)
    backend: str               # "cuda" | "torch"
    num_rhs: int = 1           # k for SpMM (1 = SpMV)
    threads_per_block: int = DEFAULT_TILE_ITEMS // ITEMS_PER_THREAD
    items_per_thread: int = ITEMS_PER_THREAD

    def flops(self) -> int:
        """2*nnz*k multiply-adds (cpu_spmv.cpp:511 convention)."""
        return 2 * self.num_nonzeros * self.num_rhs

    def bytes_accessed(self) -> int:
        """The reference roofline byte model (cpu_spmv.cpp:508-509):
        per nonzero one value + one column index + one gathered x element;
        per row one offset + one y write.  RHS-scaled for SpMM."""
        vs = itemsize(self.dtype)
        os_ = 4  # OffsetT = int32
        return (self.num_nonzeros * (vs * (1 + self.num_rhs) + os_)
                + self.num_rows * (os_ + vs * self.num_rhs))

    def describe(self) -> str:
        return (f"SpmvPlan({self.num_rows}x{self.num_cols}, nnz="
                f"{self.num_nonzeros}, {self.dtype}, backend={self.backend}, "
                f"tile_items={self.tile_items}, tiles={self.num_tiles}, "
                f"policy={self.threads_per_block}x{self.items_per_thread}, "
                f"k={self.num_rhs})")


def make_plan(num_rows: int, num_cols: int, num_nonzeros: int,
              dtype="float32", tile_items: Optional[int] = None,
              backend: str = "auto", num_rhs: int = 1,
              device=None) -> SpmvPlan:
    """Build an execution plan (phase 1 of the two-phase contract).

    The backend follows the device: "cuda" (the merge-path CUDA kernel)
    when ``device`` is a CUDA device and "torch" (plain PyTorch)
    otherwise; ``device=None`` means CUDA.  ``backend="auto"`` picks it,
    and a backend that disagrees with the device raises.  Every shape
    takes the kernel on CUDA,
    including nnz == 0 and a single column.  ``tile_items`` is rounded up
    to a whole number of warps' items and capped at MAX_TILE_ITEMS.
    """
    dname = dtype_name(dtype)
    if num_rows + num_nonzeros > _INT32_LIMIT or num_cols > _INT32_LIMIT:
        raise ValueError(
            f"{num_rows} rows + {num_nonzeros} nonzeros exceed the kernel's "
            "int32 merge coordinates")
    if tile_items is None:
        tile_items = DEFAULT_TILE_ITEMS
        # no point in a tile much larger than the whole merge list
        total = num_rows + num_nonzeros
        while tile_items > MIN_TILE_ITEMS and tile_items >= 4 * total:
            tile_items //= 2
    tile_items = -(-int(tile_items) // MIN_TILE_ITEMS) * MIN_TILE_ITEMS
    tile_items = min(max(tile_items, MIN_TILE_ITEMS), MAX_TILE_ITEMS)

    if backend not in ("auto", "cuda", "torch"):
        raise ValueError(f"unknown backend {backend!r}")
    dev = torch.device("cuda" if device is None else device)
    expected = "cuda" if dev.type == "cuda" else "torch"
    if backend == "auto":
        backend = expected
    elif backend != expected:
        raise ValueError(f"backend {backend!r} does not run on {dev}")

    return SpmvPlan(
        num_rows=int(num_rows),
        num_cols=int(num_cols),
        num_nonzeros=int(num_nonzeros),
        dtype=dname,
        tile_items=int(tile_items),
        num_tiles=num_merge_tiles(num_rows, num_nonzeros, tile_items),
        backend=backend,
        num_rhs=int(num_rhs),
        threads_per_block=int(tile_items) // ITEMS_PER_THREAD,
        items_per_thread=ITEMS_PER_THREAD,
    )
