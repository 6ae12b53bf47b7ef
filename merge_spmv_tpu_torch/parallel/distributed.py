"""SPMD merge-path CsrMV over a ``torch.distributed`` process group.

Counterpart of merge_spmv_tpu/parallel/distributed.py:211-476, with one
process per rank in place of ``shard_map`` over a mesh.  Each rank owns
one equal-merge-work share of the partition (parallel/partition.py); per
call it runs:

1. **x halo exchange** (halo mode): x lives as [S, cpad] column blocks;
   each rank holds its own and receives the ``halo``-wide edges of its
   neighbours' (one ``batch_isend_irecv`` of two sends and two receives),
   so it holds [left halo | own block | right halo].  Replicate mode
   takes the whole x.
2. **local SpMV**: the share's padded CSR window through K1, the merge
   operator of the port (ops/operator.py), built once with its gather
   policy from the share's columns; as in the JAX package, ``alpha``
   scales x before the product.
3. **carry reduce-scatter**: the partial of the row spanning the share's
   end goes to the rank whose first local row completes it (``carry_dst``,
   static); one ``reduce_scatter`` of S scalars gives each rank the sum
   routed to it, added at local row 0.
4. the rank's y window [rows_max], exclusive after the exchange;
   ``materialize_y`` assembles the windows on the host.

gloo takes CPU tensors only, so with gloo the halo edges and the carries
travel through the host (one copy each way); with NCCL they stay on the
device.  The JAX package's boundary-item split (distributed.py:180-205,
288-329), which lets XLA overlap the halo exchange with the kernel, and
its per-shard TPU gather lists are not ported: the results are the same.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from merge_spmv_tpu_torch.formats.csr import CsrMatrix
from merge_spmv_tpu_torch.ops.operator import build_operator
from merge_spmv_tpu_torch.parallel.partition import MergePartition
from merge_spmv_tpu_torch.utils.device import dtype_name, resolve_device

__all__ = ["distributed_csrmv", "materialize_y",
           "PreparedDistributedCsrmv"]


def _reduce_scatter(output, input_, group):
    # reduce_scatter_single is reduce_scatter_tensor's newer name
    fn = getattr(dist, "reduce_scatter_single", None) \
        or dist.reduce_scatter_tensor
    fn(output, input_, group=group)


def _local_share_csr(part: MergePartition, rank: int) -> CsrMatrix:
    """Rank ``rank``'s share as a CSR matrix of ``rows_max`` rows over its
    ``local_x_width`` columns: its ``local_nnz`` nonzeros (the share's
    padding holds none, as its padding rows end there)."""
    ln = int(part.meta[rank, 3])
    offsets = np.concatenate([[0], part.rowends_local[rank]]).astype(
        np.int32)
    return CsrMatrix(part.rows_max, part.local_x_width, offsets,
                     part.col_indices[rank, :ln], part.values[rank, :ln])


class PreparedDistributedCsrmv:
    """This rank's part of the SPMD operator, built once: its K1 operator
    over its share and the exchange buffers; call it with x per call.

    ``group`` is the process group (None: the default one), whose size
    must be the partition's S; the rank's share is its rank in the group.
    ``device=None`` means the card; ``"cpu"`` runs K1's plain version.
    ``op(x)`` takes the global x ([num_cols]) and returns the rank's y
    window [rows_max]; ``apply(x_in)`` takes the rank's own input
    (``x_block``), as a caller that holds only its block would.
    """

    def __init__(self, part: MergePartition, group=None, alpha: float = 1.0,
                 tile_items=None, device=None):
        self.part, self.group, self.alpha = part, group, float(alpha)
        world = dist.get_world_size(group)
        if world != part.num_shards:
            raise ValueError(f"the partition has {part.num_shards} shares, "
                             f"the process group {world} ranks")
        self.rank = s = dist.get_rank(group)
        self.device = resolve_device(device)
        self.op = build_operator(_local_share_csr(part, s),
                                 dtype=dtype_name(part.values.dtype),
                                 tile_items=tile_items, device=self.device)
        self.dtype = self.op.values.dtype
        _, _, local_rows, _, owned, dst = (int(v) for v in part.meta[s])
        self._owned, self._dst = owned, dst
        self._spanning = owned < local_rows
        self._mask = (torch.arange(part.rows_max, device=self.device)
                      < owned)
        # gloo runs on CPU tensors: stage the exchanges through the host
        staged = (dist.get_backend(group) == "gloo"
                  and self.device.type != "cpu")
        self._xdev = torch.device("cpu") if staged else self.device
        H = part.halo if part.x_mode == "halo" else 0
        self._halo_w = H if part.num_shards > 1 else 0
        self._lh = torch.zeros(self._halo_w, dtype=self.dtype,
                               device=self._xdev)
        self._rh = torch.zeros_like(self._lh)
        self._routed = torch.zeros(part.num_shards, dtype=self.dtype,
                                   device=self._xdev)
        self._received = torch.zeros(1, dtype=self.dtype, device=self._xdev)

    def _peer(self, rank: int) -> int:
        return (rank if self.group is None
                else dist.get_global_rank(self.group, rank))

    def x_block(self, x) -> torch.Tensor:
        """The rank's input from the global x: its [cpad] block (halo
        mode, zero-padded past num_cols) or the whole x (replicate)."""
        x = torch.as_tensor(x)
        p = self.part
        if p.x_mode == "halo":
            c0 = self.rank * p.cpad
            xb = torch.zeros(p.cpad, dtype=x.dtype, device=x.device)
            tail = x[c0:c0 + p.cpad]
            xb[:tail.shape[0]] = tail
            x = xb
        return x.to(device=self.device, dtype=self.dtype)

    def _halo_x(self, xb):
        """[left halo | own block | right halo] (halo mode)."""
        H, S, s = self._halo_w, self.part.num_shards, self.rank
        if not H:
            return xb
        cpad = self.part.cpad
        ops = []
        # only the edges go to the exchange's device
        if s + 1 < S:
            ops += [dist.P2POp(dist.isend, xb[cpad - H:].to(self._xdev),
                               self._peer(s + 1), self.group),
                    dist.P2POp(dist.irecv, self._rh, self._peer(s + 1),
                               self.group)]
        if s > 0:
            ops += [dist.P2POp(dist.isend, xb[:H].to(self._xdev),
                               self._peer(s - 1), self.group),
                    dist.P2POp(dist.irecv, self._lh, self._peer(s - 1),
                               self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return torch.cat([self._lh.to(xb.device), xb,
                          self._rh.to(xb.device)])

    def local(self, x_loc):
        """The local SpMV of the share over its x window."""
        if self.alpha != 1.0:
            x_loc = self.alpha * x_loc
        return self.op(x_loc)

    def _carry(self, y_local):
        """Exclusive window: owned rows kept, the received carries added
        at local row 0."""
        self._routed.zero_()
        if self._spanning:
            o, d = self._owned, self._dst
            self._routed[d:d + 1].copy_(y_local[o:o + 1])
        _reduce_scatter(self._received, self._routed, self.group)
        y = torch.where(self._mask, y_local, torch.zeros_like(y_local))
        y[:1] += self._received.to(y.device)
        return y

    def apply(self, x_in):
        """The rank's y window from its own input (``x_block``)."""
        x_loc = (self._halo_x(x_in) if self.part.x_mode == "halo"
                 else x_in)
        return self._carry(self.local(x_loc))

    def __call__(self, x):
        return self.apply(self.x_block(x))


def distributed_csrmv(group, part: MergePartition, x, alpha: float = 1.0,
                      device=None):
    """One-shot: this rank's y window of ``alpha * A @ x``.  Every rank of
    ``group`` (None: the default group) calls it with the same global x;
    the counterpart of the JAX ``distributed_csrmv(mesh, part, x)``."""
    return PreparedDistributedCsrmv(part, group, alpha=alpha,
                                    device=device)(x)


def materialize_y(y_windows, part: MergePartition) -> np.ndarray:
    """Assemble the dense global y from the exclusive per-rank windows
    ([S, rows_max], rank order)."""
    yw = np.asarray(y_windows)
    out = np.zeros(part.num_rows, dtype=yw.dtype)
    for s in range(part.num_shards):
        r0 = int(part.row_starts[s])
        r1 = int(part.row_starts[s + 1])
        if r1 > r0:
            out[r0:r1] += yw[s, :r1 - r0]
    return out
