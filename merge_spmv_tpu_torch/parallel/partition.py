"""Global merge-path partitioning of a CSR matrix into per-rank shares.

Counterpart of merge_spmv_tpu/parallel/partition.py: every array and the
x-sharding decision are bit for bit the JAX package's.

Each rank receives an equal share of ``num_rows + num_nonzeros`` merge
items (the equal-work guarantee the OMP kernel gives threads,
cpu_spmv.cpp:313-321), found by the diagonal search on the global row-end
offsets.  Shares are padded to common shapes (rows and nonzeros rounded up
to multiples of 128), as the SPMD JAX path needs them.

A share may start and end mid-row: every rank computes a full local SpMV
over its local row window, and the partial of the row spanning its end
boundary goes to the one rank whose first local row completes it
(``carry_dst``, static).  The runtime exchange is one reduce-scatter of S
scalars (parallel/distributed.py).

x sharding: x is cut into S contiguous blocks of ``cpad`` columns (a
multiple of 128).  When every share's columns stay within its own block
plus ``halo`` columns on each side, with ``halo <= cpad``, ``x_mode`` is
"halo" (two neighbour exchanges of the block edges per call, the column
indices shifted to the local window); otherwise "replicate" (every rank
holds the whole x).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from merge_spmv_tpu_torch.formats.csr import CsrMatrix
from merge_spmv_tpu_torch.ops.merge_path import merge_path_search_np

__all__ = ["MergePartition", "partition_csr"]


@dataclasses.dataclass
class MergePartition:
    """Host-side padded per-rank CSR shares.

    Shapes: values/cols [S, nnz_max]; rowends_local [S, rows_max] (local
    end offsets relative to the share's nnz window, clipped to it);
    meta [S, 6] = (row_start, nnz_start, local_rows, local_nnz, owned,
    carry_dst).
    """
    num_shards: int
    num_rows: int
    num_cols: int
    num_nonzeros: int
    rows_max: int
    nnz_max: int
    values: np.ndarray          # [S, nnz_max] value dtype
    col_indices: np.ndarray     # [S, nnz_max] int32 (window-local in halo)
    rowends_local: np.ndarray   # [S, rows_max] int32
    meta: np.ndarray            # [S, 6] int32
    row_starts: np.ndarray      # [S + 1] int32 (ownership boundaries)
    x_mode: str = "replicate"   # "halo" | "replicate"
    cpad: int = 0               # x block columns per rank (128-multiple)
    halo: int = 0               # halo columns each side (128-multiple)

    @property
    def local_x_width(self) -> int:
        """Columns visible to one rank's local SpMV."""
        if self.x_mode == "halo":
            return self.cpad + 2 * self.halo
        return self.num_cols

    def shard_x(self, x) -> np.ndarray:
        """Pad + reshape the global x into [S, cpad] column blocks."""
        x = np.asarray(x)
        out = np.zeros((self.num_shards, self.cpad), dtype=x.dtype)
        flat = out.reshape(-1)
        flat[:x.shape[0]] = x
        return out

    def to_device(self, rank: int, device=None):
        """Rank ``rank``'s share as tensors on ``device`` (None: the card):
        (values [nnz_max], col_indices [nnz_max], rowends_local
        [rows_max], meta [6]).  The counterpart of the JAX package's
        ``to_device_sharded``, which places every share on its device."""
        import torch

        from merge_spmv_tpu_torch.utils.device import resolve_device

        dev = resolve_device(device)
        return tuple(torch.from_numpy(np.ascontiguousarray(a[rank])).to(dev)
                     for a in (self.values, self.col_indices,
                               self.rowends_local, self.meta))


def partition_csr(csr: CsrMatrix, num_shards: int,
                  dtype=np.float32, allow_halo_x: bool = True
                  ) -> MergePartition:
    """Split ``csr`` into ``num_shards`` equal-merge-work shares."""
    n, nnz = csr.num_rows, csr.num_nonzeros
    S = num_shards
    total = n + nnz
    per = -(-total // S)
    diags = np.minimum(np.arange(S + 1, dtype=np.int64) * per, total)
    xs, ys = merge_path_search_np(diags, csr.row_end_offsets, nnz)
    row_starts = xs.astype(np.int64)     # completed-row boundaries
    nnz_starts = ys.astype(np.int64)

    # Local row window of share s: rows [row_starts[s], row_starts[s+1]]
    # (inclusive end: the spanning row's head items live in this share).
    owned = np.maximum(row_starts[1:] - row_starts[:-1], 0)
    local_rows = owned + (row_starts[1:] < n).astype(np.int64)
    local_nnz = nnz_starts[1:] - nnz_starts[:-1]

    # Carry routing: share s's carry row is row_starts[s+1]; it completes
    # in the share whose ownership range contains it.  Non-spanning
    # shares route a zero to themselves.
    carry_row = row_starts[1:]
    carry_dst = np.searchsorted(row_starts, carry_row, side="right") - 1
    carry_dst = np.clip(carry_dst, 0, S - 1).astype(np.int64)

    rows_max = int(local_rows.max()) if S else 0
    nnz_max = int(local_nnz.max()) if S else 0
    # padded to multiples of 128, as the JAX package pads them
    rows_max = max(8, -(-rows_max // 128) * 128)
    nnz_max = max(8, -(-nnz_max // 128) * 128)

    # x sharding decision: per-share column windows vs own block +- halo
    cols_per_shard = -(-csr.num_cols // S)          # ceil
    cpad = max(128, -(-cols_per_shard // 128) * 128)  # 128-aligned
    x_mode, halo = "replicate", 0
    if allow_halo_x and S > 1 and nnz:
        lo = np.full(S, np.int64(csr.num_cols))
        hi = np.full(S, np.int64(-1))
        for s in range(S):
            z0, z1 = nnz_starts[s], nnz_starts[s + 1]
            if z1 > z0:
                cs = csr.col_indices[z0:z1]
                lo[s] = cs.min()
                hi[s] = cs.max()
        own0 = np.arange(S, dtype=np.int64) * cpad
        need_l = np.maximum(own0 - lo, 0)
        need_r = np.maximum(hi + 1 - (own0 + cpad), 0)
        H = int(max(need_l.max(), need_r.max()))
        H = -(-H // 128) * 128
        if H <= cpad:   # windows only reach immediate neighbours
            x_mode, halo = "halo", H

    values = np.zeros((S, nnz_max), dtype=dtype)
    cols = np.zeros((S, nnz_max), dtype=np.int32)
    rowends = np.zeros((S, rows_max), dtype=np.int32)
    meta = np.zeros((S, 6), dtype=np.int32)

    re_global = csr.row_end_offsets
    for s in range(S):
        r0, r1 = row_starts[s], row_starts[s] + local_rows[s]
        z0, z1 = nnz_starts[s], nnz_starts[s + 1]
        ln = z1 - z0
        values[s, :ln] = csr.values[z0:z1].astype(dtype)
        local_cols = csr.col_indices[z0:z1].astype(np.int64)
        if x_mode == "halo":
            local_cols = local_cols - (s * cpad - halo)
        cols[s, :ln] = local_cols.astype(np.int32)
        lr = r1 - r0
        # local row-end offsets: clipped to this share's nnz window
        rowends[s, :lr] = np.clip(re_global[r0:r1].astype(np.int64) - z0,
                                  0, ln).astype(np.int32)
        rowends[s, lr:] = ln   # padding rows: empty at end
        meta[s] = (r0, z0, lr, ln, owned[s], carry_dst[s])

    return MergePartition(
        num_shards=S, num_rows=n, num_cols=csr.num_cols,
        num_nonzeros=nnz, rows_max=rows_max, nnz_max=nnz_max,
        values=values, col_indices=cols, rowends_local=rowends, meta=meta,
        row_starts=xs.astype(np.int32), x_mode=x_mode, cpad=cpad, halo=halo)
