"""Merge-path CsrMV on the card: wrappers of the CUDA kernels in
csrc/merge_csrmv.cu, and their plain PyTorch versions.

Replaces ``merge_spmv_tpu/ops/csrmv_pallas.py::_spmv_kernel``.  That TPU
kernel walks the merge tiles in order and carries the open row's partial in
SMEM (csrmv_pallas.py:919-929).  On Hopper the computation goes back to the
reference's three steps, with persistent blocks:

* search: ``merge_tile_coordinates`` (ops/merge_path.py), once per matrix;
* ``merge_tile``: block b walks the contiguous run of tiles ``[b *
  run_tiles, (b + 1) * run_tiles)`` in order, carrying the open row's
  partial from tile to tile as the TPU kernel does; it writes every row
  that ends in its run and leaves one carry pair (row, partial) per run.
  ``tile_geometry`` (ops/plan.py) picks the runs: as few blocks as fill
  the card once;
* the fix-up: adds alpha times each row's carries into y in run order,
  without floating-point atomics, so repeated calls are bitwise equal.

``merge_csrmv`` (op(x)'s route) launches the two as one kernel: the block
that finishes last, counted by an integer ticket, runs the fix-up as its
tail.  ``merge_tile`` and ``carry_fixup`` launch them apart, for the tests
and the A/B timing; the fused kernel's bits are theirs.  The ticket counter
is the caller's (``ticket_counter``: every operator allocates its own at
build, so that no counter is allocated inside a CUDA-graph capture), or the
module's one per device for a call given none.  The kernel leaves it at 0.
Fused launches that share a counter must be stream-ordered: one operator's
calls on two streams at once, or two counter-less calls at once, would
share tickets.  Operators with their own counters may run on any streams.

What bounds it: HBM bytes on local columns (``SpmvPlan.bytes_accessed()``:
a value, a column index and a gathered x element per nonzero, a row end and
a y write per row), the L2's rate of scattered 32-byte sectors on
scattered ones (tools/gather_rate.py).  The tile kernel copies each tile's
values, column indices and row ends into shared memory with bulk
asynchronous copies two tiles ahead of its reduce, issues the tile's x
gathers while the tile before is reduced, reduces over shared memory only,
and writes each y once; the fix-up touches one word per run.  Each wrapper
takes a gather ``policy`` (ops/plan.py::POLICIES, the plan's
``policy``): "stream" launches as many blocks per SM as shared memory
holds, "l1" the blocks that fit a small carveout, leaving 192 KB of each
SM as L1 for x; in both, the blocks of one SM walk neighbouring runs.

``merge_csrmm`` is SpMM's route (``op.mm``): Y = alpha * A @ X + beta *
Y_in for X [num_cols, k] row-major in one launch of the multi-RHS tile
kernel K1m (csrc/merge_csrmm.cu), which reads A once for all k columns and
gathers each nonzero's X row as one coalesced request.  Same tiles, runs,
carry pairs (k values each) and fused tail as ``merge_csrmv``; the lane
layout and launch come from ops/plan.py::mm_layout / mm_geometry.  k above
MM_MAX_K (64) is cut into column blocks of 64, a launch each; a
non-row-major X (or Y_in) is made contiguous once, counted in ``COPIES``.
``merge_csrmm_plain`` is the same decomposition with k-wide partials.

Each wrapper runs the kernel for CUDA tensors and the plain version for CPU
tensors, and raises on anything else.  ``LAUNCHES`` counts kernel launches
(never plain-version calls) so a run can show that it went through the
kernels.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from merge_spmv_tpu_torch.ops.csrmv_torch import row_ids_from_offsets
from merge_spmv_tpu_torch.ops.merge_path import num_merge_tiles
from merge_spmv_tpu_torch.ops.plan import (MM_MAX_K, POLICIES, MmGeometry,
                                           TileGeometry, mm_geometry,
                                           run_ends, tile_geometry)
from merge_spmv_tpu_torch.utils.device import dtype_name
from merge_spmv_tpu_torch.utils.cuda_build import (alignment,
                                                   check_operand as _check,
                                                   device_context,
                                                   load_library,
                                                   on_cpu as _is_cpu,
                                                   raise_on_launch,
                                                   raw_stream, row_major)

__all__ = ["merge_tile", "carry_fixup", "merge_csrmv", "merge_tile_plain",
           "carry_fixup_plain", "merge_csrmv_plain", "launch_geometry",
           "kernel_occupancy", "ticket_counter", "LAUNCHES",
           "reset_launches", "KERNEL_SOURCE", "merge_csrmm",
           "merge_csrmm_plain", "mm_launch_geometry", "mm_kernel_occupancy",
           "COPIES", "MM_SOURCE"]

KERNEL_SOURCE = "merge_csrmv"
MM_SOURCE = "merge_csrmm"
LAUNCHES = {"merge_tile": 0, "merge_tile_fused": 0, "carry_fixup": 0,
            "merge_tile_mm": 0}
# contiguous copies merge_csrmm makes of a non-row-major X or Y_in
COPIES = {"x_row_major": 0}

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    COPIES["x_row_major"] = 0


def _lib():
    lib = load_library(KERNEL_SOURCE)
    if not getattr(lib, "_typed", False):
        for sfx in _SUFFIX.values():
            f = getattr(lib, f"merge_tile_{sfx}")
            f.argtypes = [_P, _P, _P, _P, _P, _P, _P, _D, _D, _P, _P, _P, _I,
                          _I, _I, _I, _I, _I, _I, _I, _P, _P]
            f.restype = _I
            f = getattr(lib, f"merge_tile_occupancy_{sfx}")
            f.argtypes = [_I, _I, _I, _I, ctypes.POINTER(_I),
                          ctypes.POINTER(_I)]
            f.restype = _I
            f = getattr(lib, f"carry_fixup_{sfx}")
            f.argtypes = [_P, _P, _I, _I, _D, _P, _P]
            f.restype = _I
        lib.merge_csrmv_init.argtypes = []
        lib.merge_csrmv_init.restype = _I
        lib._typed = True
    return lib


@functools.lru_cache(maxsize=None)
def _device_lib(index: int):
    """The library, with the tile kernel's shared-memory opt-in and the
    "l1" policy's carveout set on device ``index``: once, before its first
    launch there, never inside a launch (which a CUDA graph may be
    capturing)."""
    lib = _lib()
    with torch.cuda.device(index):
        raise_on_launch(KERNEL_SOURCE, lib.merge_csrmv_init(),
                        "merge_csrmv_init")
    return lib


@functools.lru_cache(maxsize=None)
def _occupancy(index: int, dtype: torch.dtype, threads: int, shared: int,
               fused: bool, policy: str):
    lib = _device_lib(index)
    blocks, regs = _I(0), _I(0)
    with torch.cuda.device(index):
        rc = getattr(lib, f"merge_tile_occupancy_{_SUFFIX[dtype]}")(
            int(fused), POLICIES.index(policy), threads, shared,
            ctypes.byref(blocks), ctypes.byref(regs))
    raise_on_launch(KERNEL_SOURCE, rc, "merge_tile occupancy query")
    return blocks.value, regs.value


def ticket_counter(device):
    """A zeroed ticket counter for the fused kernel's launches on
    ``device`` (None on the CPU, where no kernel runs)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    return torch.zeros(1, dtype=torch.int32, device=dev)


@functools.lru_cache(maxsize=None)
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def kernel_occupancy(dtype, tile_items: int, device=None,
                     fused: bool = False, policy: str = "stream"):
    """(blocks per SM, registers per thread) of the tile kernel at
    ``tile_items`` on the card, from the CUDA occupancy calculator:
    the unfused instantiation (``merge_tile``'s) or, with ``fused``, the
    one with the fix-up as its tail (``merge_csrmv``'s), of the gather
    ``policy`` (ops/plan.py::POLICIES: each has its own carveout)."""
    dev = torch.device("cuda" if device is None else device)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    kernel_dtype = (torch.float64 if dtype_name(dtype) == "float64"
                    else torch.float32)
    geo = tile_geometry(1, tile_items, dtype, policy=policy)   # checks both
    return _occupancy(index, kernel_dtype, geo.threads, geo.shared_bytes,
                      bool(fused), policy)


@functools.lru_cache(maxsize=256)
def launch_geometry(num_tiles: int, tile_items: int, dtype, device,
                    fused: bool = False,
                    policy: str = "stream") -> TileGeometry:
    """The launch of the tile kernel's instantiation (see
    ``kernel_occupancy``) for tensors on ``device``: on the card with its
    SM count and the occupancy the card reports for that instantiation
    (registers included); on the CPU with the H100's (the plain version's
    runs).  Cached: every op(x) asks for it, and it costs microseconds of
    host time."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return tile_geometry(num_tiles, tile_items, dtype, policy=policy)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    blocks, _ = kernel_occupancy(dtype, tile_items, dev, fused, policy)
    return tile_geometry(num_tiles, tile_items, dtype, num_sms=_num_sms(index),
                         blocks_per_sm=blocks, policy=policy)


# ---------------------------------------------------------------------- #
# Plain versions: the same decomposition in PyTorch
# ---------------------------------------------------------------------- #

def merge_tile_plain(values, col_indices, row_end_offsets, x, tile_rows,
                     tile_nnz, tile_items, y_in=None, alpha=1.0, beta=0.0,
                     run_tiles=1):
    """Per-run completed-row sums and carry pairs, as the tile kernel
    computes them with runs of ``run_tiles`` tiles (ops/plan.py::run_ends).
    Returns (y, carry_row, carry_val): y holds ``alpha * (the row's sum
    within the run that completes it) + beta * y_in`` and run b leaves the
    partial of row ``tile_rows[end_b]`` inside run b, where ``end_b`` is
    the run's end tile."""
    num_rows = row_end_offsets.shape[0]
    num_tiles = tile_rows.shape[0] - 1
    items = torch.diff(tile_rows) + torch.diff(tile_nnz)
    if num_tiles and int(items.max()) > tile_items:
        raise ValueError("a tile holds more than tile_items merge items")
    ends = run_ends(num_tiles, run_tiles).to(tile_rows.device)
    open_rows = tile_rows.long()[ends]
    nnz = values.shape[0]
    j = torch.arange(nnz, device=values.device)
    row_of = row_ids_from_offsets(row_end_offsets, nnz)
    tile_of = torch.searchsorted(tile_nnz.long(), j, right=True) - 1
    run_of = tile_of // run_tiles
    done = row_of < open_rows[run_of]
    # x is a vector, or X [num_cols, k] (merge_csrmm_plain)
    k = tuple(x.shape[1:])
    products = (values if not k else values[:, None]) * x[col_indices.long()]
    sums = torch.zeros((num_rows,) + k, dtype=values.dtype,
                       device=values.device)
    sums.index_add_(0, row_of[done], products[done])
    carry_val = torch.zeros((ends.shape[0],) + k, dtype=values.dtype,
                            device=values.device)
    carry_val.index_add_(0, run_of[~done], products[~done])
    y = alpha * sums
    if y_in is not None:
        y = y + beta * y_in
    return y, open_rows.to(torch.int32), carry_val


def carry_fixup_plain(y, carry_row, carry_val, alpha=1.0):
    """y[r] += alpha * (sum of row r's carries, in run order), in place."""
    valid = carry_row < y.shape[0]
    rows, seg = torch.unique_consecutive(carry_row[valid],
                                         return_inverse=True)
    sums = torch.zeros((rows.shape[0],) + tuple(carry_val.shape[1:]),
                       dtype=carry_val.dtype, device=carry_val.device)
    sums.index_add_(0, seg, carry_val[valid])
    y.index_add_(0, rows.long(), sums, alpha=alpha)
    return y


def merge_csrmv_plain(values, col_indices, row_end_offsets, x, tile_rows,
                      tile_nnz, tile_items, y_in=None, alpha=1.0, beta=0.0,
                      run_tiles=1):
    """y = alpha * A @ x + beta * y_in through the tile/carry/fix-up
    decomposition with runs of ``run_tiles`` tiles, in plain PyTorch: the
    fused kernel's function."""
    y, carry_row, carry_val = merge_tile_plain(
        values, col_indices, row_end_offsets, x, tile_rows, tile_nnz,
        tile_items, y_in, alpha, beta, run_tiles)
    return carry_fixup_plain(y, carry_row, carry_val, alpha)


def merge_csrmm_plain(values, col_indices, row_end_offsets, X, tile_rows,
                      tile_nnz, tile_items, Y_in=None, alpha=1.0, beta=0.0,
                      run_tiles=1):
    """Y = alpha * A @ X + beta * Y_in (X [num_cols, k]) through the same
    tile, run and fix-up decomposition with k-wide partials and carries,
    each row's carries summed in run order: K1m's function in plain
    PyTorch."""
    return merge_csrmv_plain(values, col_indices, row_end_offsets, X,
                             tile_rows, tile_nnz, tile_items, Y_in, alpha,
                             beta, run_tiles)


# ---------------------------------------------------------------------- #
# Kernel wrappers
# ---------------------------------------------------------------------- #

def _tile_call(values, col_indices, row_end_offsets, x, tile_rows, tile_nnz,
               tile_items, y_in, alpha, beta, run_tiles, fused, tickets=None,
               policy="stream"):
    """The checks and the launch of the tile kernel's unfused or fused
    instantiation of the gather ``policy``; (y, carry_row, carry_val),
    with the carries added into y when ``fused``, counting on
    ``tickets``.  The plain version for CPU tensors."""
    num_rows = row_end_offsets.shape[0]
    num_tiles = tile_rows.shape[0] - 1
    want_tiles = num_merge_tiles(num_rows, values.shape[0], tile_items)
    if num_tiles != want_tiles:
        raise ValueError(f"{num_tiles} tiles given, {want_tiles} at "
                         f"tile_items={tile_items}: the tile coordinates "
                         "were searched at another tile size")
    if run_tiles is not None and int(run_tiles) < 1:
        raise ValueError(f"run_tiles must be >= 1, got {run_tiles}")
    cpu = _is_cpu(values, col_indices, row_end_offsets, x, tile_rows,
                  tile_nnz, y_in, tickets)
    dtype = values.dtype
    if not cpu and dtype not in _SUFFIX:
        raise TypeError(f"the kernel takes float32 or float64, got {dtype}")
    geo = launch_geometry(num_tiles, tile_items, dtype, values.device, fused,
                          policy)
    run = geo.run_tiles if run_tiles is None else int(run_tiles)
    if cpu:
        y, carry_row, carry_val = merge_tile_plain(
            values, col_indices, row_end_offsets, x, tile_rows, tile_nnz,
            tile_items, y_in, alpha, beta, run)
        if fused:
            carry_fixup_plain(y, carry_row, carry_val, alpha)
        return y, carry_row, carry_val
    _check("values", values, dtype)
    _check("col_indices", col_indices, torch.int32, values.shape)
    _check("row_end_offsets", row_end_offsets, torch.int32)
    _check("x", x, dtype)
    _check("tile_rows", tile_rows, torch.int32)
    _check("tile_nnz", tile_nnz, torch.int32, tile_rows.shape)
    if values.dim() != 1 or x.dim() != 1:
        raise ValueError("values and x must be vectors")
    if y_in is not None:
        _check("y_in", y_in, dtype, (num_rows,))
    if tickets is not None:
        _check("tickets", tickets, torch.int32, (1,))
    dev = values.device
    num_runs = -(-num_tiles // run)
    # the blocks of one SM walk neighbouring runs (csrc/merge_csrmv.cu)
    sm_blocks = geo.blocks_per_sm if num_runs % geo.blocks_per_sm == 0 else 1
    y = torch.empty(num_rows, dtype=dtype, device=dev)
    carry_row = torch.empty(num_runs, dtype=torch.int32, device=dev)
    carry_val = torch.empty(num_runs, dtype=dtype, device=dev)
    lib = _device_lib(dev.index)
    with device_context(dev):
        rc = getattr(lib, f"merge_tile_{_SUFFIX[dtype]}")(
            values.data_ptr(), col_indices.data_ptr(),
            row_end_offsets.data_ptr(), x.data_ptr(),
            None if y_in is None else y_in.data_ptr(),
            tile_rows.data_ptr(), tile_nnz.data_ptr(), float(alpha),
            float(beta), y.data_ptr(), carry_row.data_ptr(),
            carry_val.data_ptr(), num_rows, num_tiles, run, sm_blocks,
            geo.threads, geo.shared_bytes, int(fused), POLICIES.index(policy),
            None if tickets is None else tickets.data_ptr(), raw_stream(dev))
    name = "merge_tile_fused" if fused else "merge_tile"
    raise_on_launch(KERNEL_SOURCE, rc, name)
    LAUNCHES[name] += 1
    return y, carry_row, carry_val


def merge_tile(values, col_indices, row_end_offsets, x, tile_rows, tile_nnz,
               tile_items, y_in=None, alpha=1.0, beta=0.0, run_tiles=None,
               policy="stream"):
    """Tile kernel: (y, carry_row, carry_val) as merge_tile_plain returns
    them, one carry pair per run.  ``tile_items`` fixes the block size
    (tile_items / ITEMS_PER_THREAD threads); tile_rows/tile_nnz must come
    from ``merge_tile_coordinates`` at the same tile_items.
    ``run_tiles=None`` takes the runs of ``launch_geometry``; an integer
    forces them (1: a block per tile).  ``policy`` is the gather policy
    (ops/plan.py::POLICIES).  The wrapper checks the tile count without a
    sync; the kernel never indexes shared memory past the tile, whatever
    the coordinates."""
    return _tile_call(values, col_indices, row_end_offsets, x, tile_rows,
                      tile_nnz, tile_items, y_in, alpha, beta, run_tiles,
                      fused=False, policy=policy)


def carry_fixup(y, carry_row, carry_val, alpha=1.0):
    """Fix-up kernel: y[r] += alpha * (sum of row r's carries in run
    order), in place; returns y."""
    if _is_cpu(y, carry_row, carry_val):
        return carry_fixup_plain(y, carry_row, carry_val, alpha)
    dtype = y.dtype
    if dtype not in _SUFFIX:
        raise TypeError(f"the kernel takes float32 or float64, got {dtype}")
    _check("y", y, dtype)
    _check("carry_row", carry_row, torch.int32)
    _check("carry_val", carry_val, dtype, carry_row.shape)
    num_pairs = carry_row.shape[0]
    if num_pairs < 1:
        raise ValueError("carry_row must be non-empty")
    lib = _lib()
    with device_context(y.device):
        rc = getattr(lib, f"carry_fixup_{_SUFFIX[dtype]}")(
            carry_row.data_ptr(), carry_val.data_ptr(), num_pairs,
            y.shape[0], float(alpha), y.data_ptr(), raw_stream(y.device))
    raise_on_launch(KERNEL_SOURCE, rc, "carry_fixup")
    LAUNCHES["carry_fixup"] += 1
    return y


def merge_csrmv(values, col_indices, row_end_offsets, x, tile_rows, tile_nnz,
                tile_items, y_in=None, alpha=1.0, beta=0.0, run_tiles=None,
                tickets=None, policy="stream"):
    """y = alpha * A @ x + beta * y_in in one launch: the tile kernel with
    the fix-up as its tail, bit for bit ``merge_tile`` then
    ``carry_fixup`` at the same runs (``merge_csrmv_plain`` for CPU
    tensors).  ``run_tiles`` and ``policy`` as for ``merge_tile``; the
    default takes the fused instantiation's geometry.  ``tickets`` is the
    kernel's counter (``ticket_counter``), None for the module's per
    device; launches that share one must be stream-ordered (the module's
    docstring says why)."""
    return _tile_call(values, col_indices, row_end_offsets, x, tile_rows,
                      tile_nnz, tile_items, y_in, alpha, beta, run_tiles,
                      fused=True, tickets=tickets, policy=policy)[0]


# ---------------------------------------------------------------------- #
# K1m: the multi-RHS tile kernel
# ---------------------------------------------------------------------- #

def _mm_lib():
    lib = load_library(MM_SOURCE)
    if not getattr(lib, "_typed", False):
        L = ctypes.c_longlong
        for sfx in _SUFFIX.values():
            f = getattr(lib, f"merge_tile_mm_{sfx}")
            f.argtypes = [_P, _P, _P, _P, L, _P, L, _P, _P, _D, _D, _P, L, _P,
                          _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                          _P, _P]
            f.restype = _I
            f = getattr(lib, f"merge_tile_mm_occupancy_{sfx}")
            f.argtypes = [_I, _I, _I, _I, _I, ctypes.POINTER(_I),
                          ctypes.POINTER(_I)]
            f.restype = _I
        lib.merge_csrmm_init.argtypes = []
        lib.merge_csrmm_init.restype = _I
        lib._typed = True
    return lib


@functools.lru_cache(maxsize=None)
def _mm_device_lib(index: int):
    """K1m's library with its shared-memory opt-in and carveout set on
    device ``index``, once, before its first launch there."""
    lib = _mm_lib()
    with torch.cuda.device(index):
        raise_on_launch(MM_SOURCE, lib.merge_csrmm_init(), "merge_csrmm_init")
    return lib


@functools.lru_cache(maxsize=None)
def _mm_occupancy(index: int, dtype: torch.dtype, per: int, vector: bool,
                  lanes: int, threads: int, shared: int):
    lib = _mm_device_lib(index)
    blocks, regs = _I(0), _I(0)
    with torch.cuda.device(index):
        rc = getattr(lib, f"merge_tile_mm_occupancy_{_SUFFIX[dtype]}")(
            per, int(vector), lanes, threads, shared, ctypes.byref(blocks),
            ctypes.byref(regs))
    raise_on_launch(MM_SOURCE, rc, "merge_tile_mm occupancy query")
    return blocks.value, regs.value


def _kernel_dtype(dtype) -> torch.dtype:
    return torch.float64 if dtype_name(dtype) == "float64" else torch.float32


def mm_kernel_occupancy(dtype, tile_items: int, k: int, device=None,
                        align_bytes: int = 16):
    """(blocks per SM, registers per thread) of K1m's instantiation for
    ``k`` columns (ops/plan.py::mm_layout) at ``tile_items``, from the
    CUDA occupancy calculator."""
    dev = torch.device("cuda" if device is None else device)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    geo = mm_geometry(1, tile_items, dtype, k, align_bytes)
    lay = geo.layout
    return _mm_occupancy(index, _kernel_dtype(dtype), lay.per, lay.vector,
                         lay.lanes, geo.threads, geo.shared_bytes)


@functools.lru_cache(maxsize=256)
def mm_launch_geometry(num_tiles: int, tile_items: int, dtype, device,
                       k: int, align_bytes: int = 16) -> MmGeometry:
    """K1m's launch for tensors on ``device``: on the card with its SM
    count and the occupancy it reports for the instantiation; on the CPU
    with the H100's (the plain version's runs)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return mm_geometry(num_tiles, tile_items, dtype, k, align_bytes)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    blocks, _ = mm_kernel_occupancy(dtype, tile_items, k, dev, align_bytes)
    return mm_geometry(num_tiles, tile_items, dtype, k, align_bytes,
                       num_sms=_num_sms(index), blocks_per_sm=blocks)


def merge_csrmm(values, col_indices, row_end_offsets, X, tile_rows, tile_nnz,
                tile_items, Y_in=None, alpha=1.0, beta=0.0, run_tiles=None,
                tickets=None):
    """Y = alpha * A @ X + beta * Y_in, X [num_cols, k] and Y_in [num_rows,
    k], in one launch of K1m (``merge_csrmm_plain`` for CPU tensors).

    Row-major X and Y_in are read in place, whatever their row stride; a
    column-major (or other) one is made contiguous once and counted in
    ``COPIES``.  k above MM_MAX_K is cut into column blocks of MM_MAX_K
    columns, one launch each (tiling: each block reads A once).  Same
    tiles (``tile_items``, from ``merge_tile_coordinates``), runs
    (``run_tiles=None``: ``mm_launch_geometry``'s) and ``tickets`` as
    ``merge_csrmv``; launches sharing a counter must be stream-ordered.
    Y is a new contiguous [num_rows, k] tensor."""
    num_rows = row_end_offsets.shape[0]
    num_tiles = tile_rows.shape[0] - 1
    want_tiles = num_merge_tiles(num_rows, values.shape[0], tile_items)
    if num_tiles != want_tiles:
        raise ValueError(f"{num_tiles} tiles given, {want_tiles} at "
                         f"tile_items={tile_items}: the tile coordinates "
                         "were searched at another tile size")
    if run_tiles is not None and int(run_tiles) < 1:
        raise ValueError(f"run_tiles must be >= 1, got {run_tiles}")
    if X.dim() != 2:
        raise ValueError(f"X must be [num_cols, k], got {tuple(X.shape)}")
    k = X.shape[1]
    if Y_in is not None and tuple(Y_in.shape) != (num_rows, k):
        raise ValueError(f"Y_in must have shape ({num_rows}, {k}), "
                         f"got {tuple(Y_in.shape)}")
    cpu = _is_cpu(values, col_indices, row_end_offsets, X, tile_rows,
                  tile_nnz, Y_in, tickets)
    dtype = values.dtype
    if not cpu and dtype not in _SUFFIX:
        raise TypeError(f"the kernel takes float32 or float64, got {dtype}")
    if k == 0:
        return torch.zeros(num_rows, 0, dtype=dtype, device=values.device)
    if cpu:
        geo = mm_launch_geometry(num_tiles, tile_items, dtype, values.device,
                                 min(k, MM_MAX_K))
        run = geo.run_tiles if run_tiles is None else int(run_tiles)
        return merge_csrmm_plain(values, col_indices, row_end_offsets, X,
                                 tile_rows, tile_nnz, tile_items, Y_in,
                                 alpha, beta, run)
    _check("values", values, dtype)
    _check("col_indices", col_indices, torch.int32, values.shape)
    _check("row_end_offsets", row_end_offsets, torch.int32)
    _check("tile_rows", tile_rows, torch.int32)
    _check("tile_nnz", tile_nnz, torch.int32, tile_rows.shape)
    if values.dim() != 1:
        raise ValueError("values must be a vector")
    if X.dtype != dtype or (Y_in is not None and Y_in.dtype != dtype):
        raise TypeError(f"X and Y_in must be {dtype}")
    if tickets is not None:
        _check("tickets", tickets, torch.int32, (1,))
    if not row_major(X):
        X = X.contiguous()
        COPIES["x_row_major"] += 1
    if Y_in is not None and not row_major(Y_in):
        Y_in = Y_in.contiguous()
        COPIES["x_row_major"] += 1
    dev = values.device
    Y = torch.empty(num_rows, k, dtype=dtype, device=dev)
    lib = _mm_device_lib(dev.index if dev.index is not None
                         else torch.cuda.current_device())
    launch = getattr(lib, f"merge_tile_mm_{_SUFFIX[dtype]}")
    size = values.element_size()
    for c0 in range(0, k, MM_MAX_K):
        kw = min(MM_MAX_K, k - c0)
        xs, ys = X[:, c0:c0 + kw], Y[:, c0:c0 + kw]
        yi = None if Y_in is None else Y_in[:, c0:c0 + kw]
        geo = mm_launch_geometry(num_tiles, tile_items, dtype, dev, kw,
                                 alignment(size, xs, ys, yi))
        run = geo.run_tiles if run_tiles is None else int(run_tiles)
        grid = -(-num_tiles // run)
        sm_blocks = geo.blocks_per_sm if grid % geo.blocks_per_sm == 0 else 1
        carry_row = torch.empty(grid, dtype=torch.int32, device=dev)
        carry_val = torch.empty(grid * kw, dtype=dtype, device=dev)
        lay = geo.layout
        with device_context(dev):
            rc = launch(
                values.data_ptr(), col_indices.data_ptr(),
                row_end_offsets.data_ptr(), xs.data_ptr(), xs.stride(0),
                None if yi is None else yi.data_ptr(),
                0 if yi is None else yi.stride(0), tile_rows.data_ptr(),
                tile_nnz.data_ptr(), float(alpha), float(beta), ys.data_ptr(),
                ys.stride(0), carry_row.data_ptr(), carry_val.data_ptr(),
                num_rows, num_tiles, run, geo.chunk_tiles, geo.chunk_items,
                sm_blocks, kw, lay.per, int(lay.vector), lay.lanes,
                geo.threads, geo.shared_bytes,
                None if tickets is None else tickets.data_ptr(),
                raw_stream(dev))
        raise_on_launch(MM_SOURCE, rc, "merge_tile_mm")
        LAUNCHES["merge_tile_mm"] += 1
    return Y
