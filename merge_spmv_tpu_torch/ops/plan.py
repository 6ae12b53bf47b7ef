"""Two-phase plan contract and the Hopper tile policy.

Counterpart of merge_spmv_tpu/ops/plan.py.  The reference selects a
per-SM tuning policy at compile time (dispatch_spmv_orig.cuh:262-445): a
thread-block size and a number of merge items per thread, whose product is
the merge tile.  The plan pins the same shape-static facts: tile size, tile
count, backend, and the policy ``threads_per_block x items_per_thread ==
tile_items`` the CUDA tile kernel (csrc/merge_csrmv.cu) is launched with.
``tile_geometry`` turns the policy into the kernel's launch: its shared
memory, the blocks that fit on an SM, and the runs of tiles that the
persistent blocks own.

The TPU plan's VMEM, gather-list and x-window fields have no counterpart
here: Hopper gathers ``x[col]`` through its caches in hardware.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from merge_spmv_tpu_torch.ops.merge_path import num_merge_tiles
from merge_spmv_tpu_torch.utils.device import dtype_name, itemsize

__all__ = ["SpmvPlan", "make_plan", "TileGeometry", "tile_geometry",
           "tile_shared_bytes", "run_ends", "ITEMS_PER_THREAD",
           "MIN_TILE_ITEMS", "MAX_TILE_ITEMS", "H100_SMS", "POLICIES",
           "gather_sectors_per_nonzero", "gather_policy",
           "l1_carveout_bytes", "L1_TILE_ITEMS", "MmLayout", "mm_layout",
           "mm_shared_bytes", "MmGeometry", "mm_geometry", "MM_MAX_K",
           "MM_THREADS", "MM_CHUNK_ITEMS", "MM_BLOCKS_PER_SM"]

# Merge items each thread consumes in sequence (CUB's ITEMS_PER_THREAD).
ITEMS_PER_THREAD = 8
# One warp is the smallest block, 512 threads the largest.  At 4096 items a
# float64 block takes 173 KB of shared memory (tile_shared_bytes), within a
# block's 227 KB only after the opt-in above the default 48 KB.
MIN_TILE_ITEMS = 32 * ITEMS_PER_THREAD
MAX_TILE_ITEMS = 512 * ITEMS_PER_THREAD
DEFAULT_TILE_ITEMS = 256 * ITEMS_PER_THREAD
# The "l1" policy's default tile: two blocks of 128 threads share the
# SM's smallest carveout that holds one default tile (l1_carveout_bytes).
L1_TILE_ITEMS = 128 * ITEMS_PER_THREAD

# Shared-memory stages of the tile kernel: a tile's streams arrive in one
# while the tile before is prepared from the other.
STAGES = 2
_MAX_WARPS = MAX_TILE_ITEMS // ITEMS_PER_THREAD // 32

# Hopper (sm_90) limits, from the CUDA programming guide's table of compute
# capabilities: per SM 2048 threads, 32 blocks and 228 KB of shared memory,
# of which each resident block leaves 1 KB to the system; per block 227 KB,
# and 48 KB of dynamic shared memory without the opt-in.
SM_THREADS = 2048
SM_BLOCKS = 32
SM_SHARED_BYTES = 233_472
BLOCK_RESERVED_SHARED = 1024
BLOCK_SHARED_MAX = 232_448
BLOCK_SHARED_DEFAULT = 49_152
# the shared-memory carveouts an SM can take, KB (the same guide)
SM_CARVEOUTS_KB = (0, 8, 16, 32, 64, 100, 132, 164, 196, 228)
# SMs of the H100 SXM: the geometry's default where no card is asked.
H100_SMS = 132

# Gather policies of the tile kernel, in the order of csrc/merge_csrmv.cu's
# Policy enum: "stream" runs as many blocks per SM as shared memory holds
# (about 28 KB of L1 left for x at the default tile); "l1" runs the blocks
# that fit the smallest carveout holding one default tile (64 KB in
# float32), so that the rest of the SM's 256 KB, 192 KB, is L1 for x.
# gather_policy picks one per matrix.
POLICIES = ("stream", "l1")
SECTOR_BYTES = 32          # an L2 sector: what a scattered 4-byte read moves
WARP = 32                  # nonzeros of one warp request of the gather
# "l1" when the gather's sectors move more than this many times the
# streams' bytes
GATHER_BOUND_RATIO = 2.0
_SPREAD_SAMPLES = 4096     # warp requests sampled by the statistic

# The multi-RHS tile kernel (K1m, csrc/merge_csrmm.cu): blocks of
# MM_THREADS threads, at most MM_BLOCKS_PER_SM an SM (its launch bounds: 64
# registers a thread), each staging about MM_CHUNK_ITEMS merge items at a
# time in two stages; at most MM_MAX_K columns a launch.
MM_THREADS = 256
MM_BLOCKS_PER_SM = 4
MM_CHUNK_ITEMS = 2048
MM_MAX_K = 64
_MM_WARPS = MM_THREADS // 32

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
    # the TPU package's make_plan knobs given here, accepted and ignored
    ignored: tuple = ()
    policy: str = "stream"     # the tile kernel's gather policy (POLICIES)

    @property
    def num_merge_items(self) -> int:
        return self.num_rows + self.num_nonzeros

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
        ignored = (f", ignored TPU knobs: {', '.join(self.ignored)}"
                   if self.ignored else "")
        return (f"SpmvPlan({self.num_rows}x{self.num_cols}, nnz="
                f"{self.num_nonzeros}, {self.dtype}, backend={self.backend}, "
                f"tile_items={self.tile_items}, tiles={self.num_tiles}, "
                f"block={self.threads_per_block}x{self.items_per_thread}, "
                f"gather={self.policy}, k={self.num_rhs}{ignored})")


# The TPU package's make_plan knobs (merge_spmv_tpu/ops/plan.py:158-175)
# and their defaults there: VMEM budgets, gather lists, x windows and the
# branchy kernel have no counterpart on Hopper, which gathers x[col]
# through its caches.
_TPU_KNOBS = (("vmem_bytes", None), ("r_win", None), ("meta_k", None),
              ("x_win", None), ("row_span", None),
              ("row_end_offsets", None),
              ("allow_x_streaming", True), ("runtime_skip", None),
              ("gather_group", 1), ("gather_cluster", None),
              ("gather_style", "tree"), ("gather_dlist", None),
              ("scratch", None))


def make_plan(num_rows: int, num_cols: int, num_nonzeros: int,
              dtype="float32", tile_items: Optional[int] = None,
              backend: str = "auto", num_rhs: int = 1,
              vmem_bytes: Optional[int] = None,
              r_win: Optional[int] = None,
              meta_k: Optional[int] = None,
              x_win: Optional[int] = None,
              row_span: Optional[int] = None,
              row_end_offsets=None, col_indices=None,
              allow_x_streaming: bool = True,
              runtime_skip: Optional[bool] = None,
              gather_group: int = 1,
              gather_cluster=None,
              gather_style: str = "tree",
              gather_dlist=None,
              scratch: Optional[dict] = None,
              device=None) -> SpmvPlan:
    """Build an execution plan (phase 1 of the two-phase contract).

    The arguments after ``num_rhs`` are the TPU package's, in its order,
    so that a caller of either package may call the other.  As there,
    ``col_indices`` (a numpy array or a tensor) tightens the kernel's
    knobs: it picks the gather policy (``gather_policy``) and, for "l1",
    the default tile L1_TILE_ITEMS; without it the policy is "stream".
    The others are accepted and ignored, and the plan names those given
    (``plan.ignored``, shown by ``describe()``).

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
    policy = ("stream" if col_indices is None else
              gather_policy(num_rows, num_nonzeros, col_indices, dname))
    if tile_items is None:
        tile_items = L1_TILE_ITEMS if policy == "l1" else DEFAULT_TILE_ITEMS
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

    given = dict(vmem_bytes=vmem_bytes, r_win=r_win, meta_k=meta_k,
                 x_win=x_win, row_span=row_span,
                 row_end_offsets=row_end_offsets,
                 allow_x_streaming=allow_x_streaming,
                 runtime_skip=runtime_skip, gather_group=gather_group,
                 gather_cluster=gather_cluster, gather_style=gather_style,
                 gather_dlist=gather_dlist, scratch=scratch)
    ignored = tuple(name for name, default in _TPU_KNOBS
                    if given[name] is not None and (default is None
                                                    or given[name] != default))
    num_tiles = num_merge_tiles(num_rows, num_nonzeros, tile_items)
    return SpmvPlan(
        num_rows=int(num_rows),
        num_cols=int(num_cols),
        num_nonzeros=int(num_nonzeros),
        dtype=dname,
        tile_items=int(tile_items),
        num_tiles=num_tiles,
        backend=backend,
        num_rhs=int(num_rhs),
        threads_per_block=tile_geometry(num_tiles, tile_items, dname).threads,
        items_per_thread=ITEMS_PER_THREAD,
        ignored=ignored,
        policy=policy,
    )


# ---------------------------------------------------------------------- #
# Launch geometry of the tile kernel
# ---------------------------------------------------------------------- #

def _value_size(dtype) -> int:
    """Bytes of the kernel's value type: bfloat16 computes in float32."""
    return 8 if dtype_name(dtype) == "float64" else 4


def tile_shared_bytes(tile_items: int, dtype) -> int:
    """Dynamic shared memory of one tile-kernel block, as
    csrc/merge_csrmv.cu lays it out: the stages' mbarriers (16 bytes) and
    headers (32 bytes each), the per-warp scan totals, one partial per
    tile row, the products with a pad after every ITEMS_PER_THREAD, a
    2-byte row mark per nonzero, and STAGES stages that each hold a tile's
    values and column indices (per nonzero) and row ends (per row; rows +
    nonzeros <= tile_items), with 96 bytes for rounding the three regions
    out to 16."""
    vs = _value_size(dtype)
    stage = tile_items * (vs + 4) + 96
    products = tile_items // ITEMS_PER_THREAD * (ITEMS_PER_THREAD + 1) * vs
    return (16 + STAGES * 32 + _MAX_WARPS * (vs + 4) + tile_items * vs
            + products + tile_items * 2 + STAGES * stage)


@dataclasses.dataclass(frozen=True)
class TileGeometry:
    """Launch of the tile kernel: ``grid`` persistent blocks of
    ``threads`` threads and ``shared_bytes`` of dynamic shared memory each;
    block b owns the contiguous tiles ``[b * run_tiles, (b + 1) *
    run_tiles)`` (the last run may be shorter) and leaves one carry pair.
    ``opt_in``: the block needs more than the default 48 KB."""
    threads: int
    stages: int
    shared_bytes: int
    opt_in: bool
    blocks_per_sm: int
    grid: int
    run_tiles: int


def tile_geometry(num_tiles: int, tile_items: int, dtype="float32",
                  num_sms: int = H100_SMS,
                  blocks_per_sm: Optional[int] = None,
                  policy: str = "stream") -> TileGeometry:
    """The tile kernel's launch for ``num_tiles`` tiles of ``tile_items``.

    Blocks per SM are what the threads and shared memory allow
    (``blocks_per_sm``, the card's own occupancy figure, which also counts
    registers, lowers it); under the "l1" policy, those that fit
    ``l1_carveout_bytes`` (at least one: a larger block makes the CUDA driver
    raise the carveout at launch).  Merge-path
    tiles are equal in work, so the tiles are cut into equal contiguous
    runs, as few as fill every resident block once: ``G = ceil(num_tiles
    / run_tiles) <= min(num_tiles, blocks_per_sm * num_sms)``, one wave
    with no tail."""
    if policy not in POLICIES:
        raise ValueError(f"unknown gather policy {policy!r}; one of "
                         f"{POLICIES}")
    if tile_items % MIN_TILE_ITEMS or not (
            MIN_TILE_ITEMS <= tile_items <= MAX_TILE_ITEMS):
        raise ValueError(f"tile_items must be a multiple of {MIN_TILE_ITEMS} "
                         f"in [{MIN_TILE_ITEMS}, {MAX_TILE_ITEMS}], "
                         f"got {tile_items}")
    if num_tiles < 1 or num_sms < 1:
        raise ValueError("num_tiles and num_sms must be positive")
    threads = tile_items // ITEMS_PER_THREAD
    shared = tile_shared_bytes(tile_items, dtype)
    fit = min(SM_THREADS // threads, SM_BLOCKS,
              SM_SHARED_BYTES // (shared + BLOCK_RESERVED_SHARED))
    if blocks_per_sm is not None:
        fit = min(fit, blocks_per_sm)
    if policy == "l1":
        fit = min(fit, l1_carveout_bytes(dtype)
                  // (shared + BLOCK_RESERVED_SHARED))
    fit = max(fit, 1)
    run_tiles = -(-num_tiles // (fit * num_sms))
    return TileGeometry(threads=threads, stages=STAGES, shared_bytes=shared,
                        opt_in=shared > BLOCK_SHARED_DEFAULT,
                        blocks_per_sm=fit, grid=-(-num_tiles // run_tiles),
                        run_tiles=run_tiles)


def run_ends(num_tiles: int, run_tiles: int) -> torch.Tensor:
    """End tile (exclusive) of each run: run b is ``[b * run_tiles,
    min((b + 1) * run_tiles, num_tiles))``, as the kernel's block b walks
    it.  int64, on the CPU."""
    if run_tiles < 1:
        raise ValueError(f"run_tiles must be >= 1, got {run_tiles}")
    num_runs = -(-num_tiles // run_tiles)
    return torch.clamp(torch.arange(1, num_runs + 1, dtype=torch.int64)
                       * run_tiles, max=num_tiles)


def gather_sectors_per_nonzero(col_indices, dtype="float32",
                               samples: Optional[int] = _SPREAD_SAMPLES
                               ) -> float:
    """Distinct 32-byte sectors of x per nonzero among WARP consecutive
    nonzeros (one warp request of the tile kernel's gather): about 1 when
    the columns scatter, 1 / WARP when a request reads one sector.  On
    ``samples`` requests spread evenly over the nonzeros, or on every
    request (the nonzeros cut into groups of WARP) with ``samples=None``.
    A torch tensor on any device, or a numpy array; one host read."""
    cols = torch.as_tensor(col_indices)
    nnz = cols.shape[0]
    if nnz == 0:
        return 0.0
    per_sector = SECTOR_BYTES // _value_size(dtype)
    width = min(WARP, nnz)
    groups = nnz // width
    count = groups if samples is None else min(samples, groups)
    # integer arithmetic: the same samples on every device
    step = width if count == groups else (nnz - width) // max(count - 1, 1)
    starts = torch.arange(count, device=cols.device) * step
    idx = starts[:, None] + torch.arange(width, device=cols.device)
    sectors = torch.sort(cols[idx].long() // per_sector, dim=1).values
    distinct = 1 + (sectors[:, 1:] != sectors[:, :-1]).sum(1)
    return float(distinct.double().mean()) / width


def l1_carveout_bytes(dtype="float32") -> int:
    """Shared memory per SM under the "l1" policy: the smallest carveout
    that holds one block of the default tile, which the kernel's
    preference (csrc/merge_csrmv.cu::l1_carveout) asks for."""
    need = (tile_shared_bytes(DEFAULT_TILE_ITEMS, dtype)
            + BLOCK_RESERVED_SHARED)
    return next(kb * 1024 for kb in SM_CARVEOUTS_KB if kb * 1024 >= need)


def gather_policy(num_rows: int, num_nonzeros: int, col_indices,
                  dtype="float32") -> str:
    """The gather policy for a matrix with these columns: "l1" when the
    sectors its gather moves (``gather_sectors_per_nonzero`` per nonzero,
    32 bytes each) exceed GATHER_BOUND_RATIO times its streams (a value
    and a column index per nonzero, a row end and a y per row), so that
    the time goes to the gather and L1 hits save it; "stream" otherwise."""
    vs = _value_size(dtype)
    gather = (num_nonzeros * SECTOR_BYTES
              * gather_sectors_per_nonzero(col_indices, dtype))
    streams = num_nonzeros * (vs + 4) + num_rows * (4 + vs)
    return "l1" if gather > GATHER_BOUND_RATIO * streams else "stream"


# ---------------------------------------------------------------------- #
# The multi-RHS tile kernel (K1m): lane layout and launch geometry
# ---------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class MmLayout:
    """How K1m's walkers hold k columns: a walker is ``lanes`` lanes of a
    warp; lane l holds ``per`` columns, ``l * per + e`` read by one vector
    load (``vector``) or ``l + e * lanes`` read one by one."""
    per: int
    vector: bool
    lanes: int

    @property
    def width(self) -> int:
        """Columns a walker holds (>= k)."""
        return self.per * self.lanes


def _next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def mm_layout(k: int, dtype="float32", align_bytes: int = 16) -> MmLayout:
    """K1m's layout for ``k`` columns (1 <= k <= MM_MAX_K): the widest
    vector load (16, 8 or 4 bytes) that divides a row of k values and
    ``align_bytes`` (the alignment shared by the operands' pointers and row
    strides), with a power of two of lanes at most 32; else strided scalar
    loads, two columns a lane over 32 lanes (k of 33-64 that allow no
    vector load)."""
    if not 1 <= k <= MM_MAX_K:
        raise ValueError(f"k must be in [1, {MM_MAX_K}] for one launch, "
                         f"got {k}")
    vs = _value_size(dtype)
    for vbytes in (16, 8, 4):
        per = vbytes // vs
        if per < 1 or vbytes > align_bytes or k % per:
            continue
        lanes = _next_pow2(-(-k // per))
        if lanes <= WARP:
            return MmLayout(per, True, lanes)
    return MmLayout(-(-k // WARP), False, WARP)


def mm_shared_bytes(chunk_items: int, dtype, width: int) -> int:
    """Dynamic shared memory of one K1m block, as csrc/merge_csrmm.cu lays
    it out: the warps' k-wide scan totals (``width`` values each) and
    flags, and two stages that each hold a chunk's values and its row ends
    and column indices (rows + nonzeros <= chunk_items)."""
    vs = _value_size(dtype)
    return (_MM_WARPS * width * vs + _MM_WARPS * 4
            + 2 * chunk_items * (vs + 4))


@dataclasses.dataclass(frozen=True)
class MmGeometry:
    """K1m's launch for k columns: ``grid`` persistent blocks of
    ``threads`` threads and ``shared_bytes`` of dynamic shared memory, at
    most ``blocks_per_sm`` an SM; block b owns the tiles ``[b * run_tiles,
    (b + 1) * run_tiles)`` and stages ``chunk_tiles`` of them
    (``chunk_items`` merge items at most) at a time; its carry pair holds k
    values (``carry_bytes`` over the grid)."""
    threads: int
    shared_bytes: int
    blocks_per_sm: int
    grid: int
    run_tiles: int
    chunk_tiles: int
    chunk_items: int
    layout: MmLayout
    carry_bytes: int


def mm_geometry(num_tiles: int, tile_items: int, dtype="float32",
                k: int = 1, align_bytes: int = 16, num_sms: int = H100_SMS,
                blocks_per_sm: Optional[int] = None) -> MmGeometry:
    """K1m's launch for ``num_tiles`` merge tiles of ``tile_items`` (the
    operator's, K1's) and ``k`` columns: the layout of ``mm_layout``; the
    tiles staged ``MM_CHUNK_ITEMS // tile_items`` at a time (at least
    one); blocks per SM what threads, shared memory and the kernel's launch
    bounds allow (``blocks_per_sm``, the card's occupancy figure, lowers
    it); the tiles cut into equal contiguous runs, as few as fill every
    resident block once, as ``tile_geometry`` cuts them for K1."""
    if tile_items % MIN_TILE_ITEMS or not (
            MIN_TILE_ITEMS <= tile_items <= MAX_TILE_ITEMS):
        raise ValueError(f"tile_items must be a multiple of {MIN_TILE_ITEMS} "
                         f"in [{MIN_TILE_ITEMS}, {MAX_TILE_ITEMS}], "
                         f"got {tile_items}")
    if num_tiles < 1 or num_sms < 1:
        raise ValueError("num_tiles and num_sms must be positive")
    layout = mm_layout(k, dtype, align_bytes)
    chunk_tiles = max(1, MM_CHUNK_ITEMS // tile_items)
    chunk_items = chunk_tiles * tile_items
    shared = mm_shared_bytes(chunk_items, dtype, layout.width)
    fit = min(SM_THREADS // MM_THREADS, MM_BLOCKS_PER_SM,
              SM_SHARED_BYTES // (shared + BLOCK_RESERVED_SHARED))
    if blocks_per_sm is not None:
        fit = min(fit, blocks_per_sm)
    fit = max(fit, 1)
    run_tiles = -(-num_tiles // (fit * num_sms))
    grid = -(-num_tiles // run_tiles)
    return MmGeometry(threads=MM_THREADS, shared_bytes=shared,
                      blocks_per_sm=fit, grid=grid, run_tiles=run_tiles,
                      chunk_tiles=chunk_tiles, chunk_items=chunk_items,
                      layout=layout,
                      carry_bytes=grid * (4 + k * _value_size(dtype)))
