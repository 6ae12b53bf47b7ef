"""SPMD merge-path CsrMV over a ``torch.distributed`` process group.

Counterpart of merge_spmv_tpu/parallel/distributed.py, with one process
per rank in place of ``shard_map`` over a mesh.  Each rank owns one
equal-merge-work share of the partition (parallel/partition.py).  Its
pieces:

* **x halo exchange** (halo mode, S > 1): x lives as [S, cpad] column
  blocks; each rank sends the ``halo``-wide edges of its block to its
  neighbours and receives theirs (one ``batch_isend_irecv`` of two sends
  and two receives) into a [2H] halo vector [left halo | right halo].
  Replicate mode takes the whole x and exchanges nothing.
* **local SpMV**: K1, the port's merge operator (ops/operator.py), built
  once with its gather policy from the columns it reads; as in the JAX
  package, ``alpha`` scales x before the product.
* **carry reduce-scatter** (S > 1): the partial of the row spanning the
  share's end goes to the rank whose first local row completes it
  (``carry_dst``, static); one ``reduce_scatter`` of S scalars gives each
  rank the sum routed to it, added at local row 0.  With one rank there
  is no carry, and no collective runs, as in the JAX package.
* the rank's y window [rows_max], exclusive after the exchange;
  ``materialize_y`` assembles the windows on the host.

Two orders of these pieces, those of the JAX package's two shard bodies:

* **split** (``PreparedDistributedCsrmv``, ``distributed_csrmv_fn(...,
  prepared=prepare_distributed_csrmv(part))``; JAX ``shard_body_prep``,
  distributed.py:290-329).  ``prepare_distributed_csrmv`` splits each
  share's nonzeros into interior items, whose columns lie in the rank's
  own x block, and boundary items, whose columns lie in the halo.  A call
  launches the interior K1 over the rank's own block first, so that it
  depends on nothing the exchange brings; the exchange runs after that
  launch without waiting for it; then the boundary items go through K1
  over the [2H] halo vector, added onto the interior's y (``y_in``,
  ``beta = 1``); then the carries, read after that add.  Two K1 launches
  a call; a rank whose share has no boundary item launches one.
* **unsplit** (``distributed_csrmv``, ``distributed_csrmv_fn(group,
  part)``; JAX ``shard_body``, :346-394): the exchange, one K1 over the
  share's window [left halo | own block | right halo], the carries.

The boundary items are removed from the interior CSR, not zeroed in
place: a zero whose column pointed at a real x lane would turn an
infinite x there into NaN, where the JAX package, whose interior kernel
sees zero halo lanes, gives 0.

gloo takes CPU tensors only, so with gloo on the card the halo edges and
the carries travel through the host.  The edges are copied into pinned
buffers on a side stream that waits only on an event recorded when x was
ready, so the interior K1 is not waited for; the side stream alone is
synchronised before the sends; the received edges go back on the side
stream, whose event the compute stream waits on.  With a device backend
(NCCL, not yet run) the exchange runs on device tensors, issued from the
side stream.  The JAX package's per-shard TPU gather lists, row lists and
``runtime_skip`` are not ported: they drive its Pallas kernel only.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from merge_spmv_tpu_torch.formats.csr import CsrMatrix
from merge_spmv_tpu_torch.ops.csrmv import compute_dtype
from merge_spmv_tpu_torch.ops.operator import build_operator
from merge_spmv_tpu_torch.parallel.partition import MergePartition
from merge_spmv_tpu_torch.utils.device import dtype_name, resolve_device

__all__ = ["distributed_csrmv", "distributed_csrmv_fn", "materialize_y",
           "prepare_distributed_csrmv", "PreparedDistributedCsrmv",
           "ShareSplit"]


def _reduce_scatter(output, input_, group):
    # reduce_scatter_single is reduce_scatter_tensor's newer name
    fn = getattr(dist, "reduce_scatter_single", None) \
        or dist.reduce_scatter_tensor
    fn(output, input_, group=group)


def _share_offsets(ends) -> np.ndarray:
    return np.concatenate([[0], ends]).astype(np.int32)


def _local_share_csr(part: MergePartition, rank: int) -> CsrMatrix:
    """Rank ``rank``'s share as a CSR matrix of ``rows_max`` rows over its
    ``local_x_width`` columns: its ``local_nnz`` nonzeros (the share's
    padding holds none, as its padding rows end there)."""
    ln = int(part.meta[rank, 3])
    return CsrMatrix(part.rows_max, part.local_x_width,
                     _share_offsets(part.rowends_local[rank]),
                     part.col_indices[rank, :ln], part.values[rank, :ln])


@dataclasses.dataclass
class ShareSplit:
    """``prepare_distributed_csrmv``'s result: each share's nonzeros split
    into interior and boundary items, and what each rank builds its two
    K1 operators from.

    ``arrays`` holds the JAX package's names: ``bvals``, ``bcols`` and
    ``brows`` [S, bmax] (bmax = max(8, the largest share's count rounded
    up to 8); padding at ``brows = rows_max - 1``, ``bvals = 0``), absent
    when no share has a boundary item.  ``boundary_ids[s]`` are share s's
    boundary positions among its ``local_nnz`` items (empty in replicate
    mode, where every item is interior).
    """
    part: MergePartition
    dtype: str
    tile_items: Optional[int]
    boundary_ids: list
    arrays: dict

    @property
    def halo(self) -> int:
        """H, the halo vector's half width (0: no exchange)."""
        p = self.part
        return p.halo if p.x_mode == "halo" and p.num_shards > 1 else 0

    def boundary_count(self, s: int) -> int:
        return len(self.boundary_ids[s])

    def _mask(self, s):
        ln = int(self.part.meta[s, 3])
        mask = np.zeros(ln, bool)
        mask[self.boundary_ids[s]] = True
        # boundary items before each row end: the rows' boundary offsets
        before = np.concatenate([[0], np.cumsum(mask)])
        return mask, before[self.part.rowends_local[s]]

    def interior_csr(self, s: int) -> CsrMatrix:
        """Share s without its boundary items, ``rows_max`` rows over the
        rank's own x block (columns shifted by -H; the whole x in
        replicate mode)."""
        p = self.part
        ln = int(p.meta[s, 3])
        mask, bends = self._mask(s)
        keep = ~mask
        width = p.cpad if p.x_mode == "halo" else p.num_cols
        cols = p.col_indices[s, :ln][keep] - (p.halo if p.x_mode == "halo"
                                              else 0)
        return CsrMatrix(p.rows_max, width,
                         _share_offsets(p.rowends_local[s] - bends),
                         cols.astype(np.int32), p.values[s, :ln][keep])

    def boundary_csr(self, s: int, alpha: float = 1.0) -> CsrMatrix:
        """Share s's boundary items over the [2H] halo vector (column c
        for c < H, c - cpad past the own block), ``rows_max`` rows, the
        values times ``alpha`` (JAX: ``alpha * bvals * x_h[bcols]``)."""
        p = self.part
        ids = self.boundary_ids[s]
        _, bends = self._mask(s)
        cols = p.col_indices[s][ids]
        cols = np.where(cols < p.halo, cols, cols - p.cpad).astype(np.int32)
        vals = p.values[s][ids]
        vals = vals * vals.dtype.type(alpha)
        return CsrMatrix(p.rows_max, 2 * self.halo, _share_offsets(bends),
                         cols, vals)


def prepare_distributed_csrmv(part: MergePartition, dtype="float32",
                              tile_items=None) -> ShareSplit:
    """The host side of the split path, done once (JAX
    distributed.py:49-208 without the TPU gather lists, row lists and
    ``runtime_skip``): in halo mode, each share's items whose columns lie
    outside its own x block, ``(col < H) | (col >= H + cpad)`` over its
    first ``local_nnz`` items, and the JAX package's ``bvals``, ``bcols``,
    ``brows`` stacks of them (``brows`` by ``searchsorted(rowends_local,
    ids, side="right")``).  ``dtype`` and ``tile_items`` are the ranks' K1
    operators'."""
    S = part.num_shards
    ids_all = [np.zeros(0, np.int64)] * S
    arrays = {}
    if part.x_mode == "halo" and part.halo:
        H, cpad = part.halo, part.cpad
        for s in range(S):
            ln = int(part.meta[s, 3])
            wcols = part.col_indices[s][:ln]
            ids_all[s] = np.nonzero((wcols < H) | (wcols >= H + cpad))[0]
        top = max(len(ids) for ids in ids_all)
        bmax = max(8, -(-top // 8) * 8) if top else 0
        if bmax:
            bvals = np.zeros((S, bmax), np.float32)
            bcols = np.zeros((S, bmax), np.int32)
            brows = np.full((S, bmax), part.rows_max - 1, np.int32)
            for s, ids in enumerate(ids_all):
                if len(ids):
                    bvals[s, :len(ids)] = part.values[s][ids]
                    bcols[s, :len(ids)] = part.col_indices[s][ids]
                    brows[s, :len(ids)] = np.searchsorted(
                        part.rowends_local[s].astype(np.int64), ids,
                        side="right")
            arrays = {"bvals": bvals, "bcols": bcols, "brows": brows}
    return ShareSplit(part, dtype_name(dtype), tile_items, ids_all, arrays)


class _RankCsrmv:
    """What both orders share: this rank of ``group`` (None: the default
    group, whose size must be the partition's S), its x block, the halo
    exchange and the carries.  ``collectives`` counts the collectives it
    issued (an exchange, a reduce-scatter); ``timeline``, None unless a
    caller sets it, gets ``mark(name, where)`` at the call's steps
    (parallel/mp_worker.py's evidence)."""

    def __init__(self, part: MergePartition, group, alpha, device):
        self.part, self.group, self.alpha = part, group, float(alpha)
        world = dist.get_world_size(group)
        if world != part.num_shards:
            raise ValueError(f"the partition has {part.num_shards} shares, "
                             f"the process group {world} ranks")
        self.rank = s = dist.get_rank(group)
        self.device = resolve_device(device)
        self.dtype = compute_dtype(dtype_name(part.values.dtype))
        _, _, local_rows, _, owned, dst = (int(v) for v in part.meta[s])
        self._owned, self._dst = owned, dst
        self._spanning = owned < local_rows
        self._mask = (torch.arange(part.rows_max, device=self.device)
                      < owned)
        self.collectives = 0
        self.timeline = None
        H = part.halo if part.x_mode == "halo" and part.num_shards > 1 else 0
        self._halo_w = H
        # [left halo | right halo]; a side with no neighbour stays zero
        self._halo = torch.zeros(2 * H, dtype=self.dtype, device=self.device)
        on_card = self.device.type == "cuda"
        # gloo runs on CPU tensors: stage the exchanges through the host
        self._staged = on_card and dist.get_backend(group) == "gloo"
        carry_dev = torch.device("cpu") if self._staged else self.device
        self._routed = torch.zeros(part.num_shards, dtype=self.dtype,
                                   device=carry_dev)
        self._received = torch.zeros(1, dtype=self.dtype, device=carry_dev)
        if on_card and H:
            self._side = torch.cuda.Stream(self.device)
            self._x_ready = torch.cuda.Event()
            self._landed = torch.cuda.Event()
        if self._staged and H:
            pin = dict(dtype=self.dtype, pin_memory=True)
            self._send = {d: torch.zeros(H, **pin) for d in (-1, 1)}
            self._recv = {d: torch.zeros(H, **pin) for d in (-1, 1)}

    def _peer(self, rank: int) -> int:
        return (rank if self.group is None
                else dist.get_global_rank(self.group, rank))

    def _mark(self, name, where):
        if self.timeline is not None:
            self.timeline.mark(name, where)

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

    def _ready(self):
        """An event on the compute stream marking x ready (on the card
        with an exchange to make), for the side stream to wait on."""
        if self.device.type != "cuda" or not self._halo_w:
            return None
        # a wait enqueued on the event keeps the record it saw
        self._x_ready.record(torch.cuda.current_stream(self.device))
        return self._x_ready

    def _neighbours(self):
        """(direction, peer, edge of the own block it gets, halo slice it
        fills): +1 the right neighbour (our last H columns go, its first
        H arrive as our right halo), -1 the left."""
        H, S, s = self._halo_w, self.part.num_shards, self.rank
        cpad = self.part.cpad
        out = []
        if s + 1 < S:
            out.append((1, self._peer(s + 1), slice(cpad - H, cpad),
                        slice(H, 2 * H)))
        if s > 0:
            out.append((-1, self._peer(s - 1), slice(0, H), slice(0, H)))
        return out

    def exchange(self, x_in, ready=None) -> Optional[torch.Tensor]:
        """The halo vector [2H] from the neighbours' edges of x (None
        without an exchange).  ``ready`` is ``_ready()``'s event, taken
        before work the exchange must not wait for; on the card the
        compute stream waits for the halo, the host does not."""
        if not self._halo_w:
            return None
        self.collectives += 1
        nb = self._neighbours()
        if self.device.type != "cuda":
            self._post([(p, x_in[e], self._halo[h]) for _, p, e, h in nb])
            return self._halo
        side = self._side
        side.wait_event(ready if ready is not None else self._ready())
        if self._staged:
            with torch.cuda.stream(side):
                for d, _, e, _ in nb:
                    self._send[d].copy_(x_in[e], non_blocking=True)
            side.synchronize()   # the edges are in host memory
            self._post([(p, self._send[d], self._recv[d])
                        for d, p, _, _ in nb])
            with torch.cuda.stream(side):
                for d, _, _, h in nb:
                    self._halo[h].copy_(self._recv[d], non_blocking=True)
        else:
            with torch.cuda.stream(side):
                self._post([(p, x_in[e], self._halo[h])
                            for _, p, e, h in nb])
        self._mark("halo_landed", "side")   # stamped before the event
        self._landed.record(side)
        torch.cuda.current_stream(self.device).wait_event(self._landed)
        return self._halo

    def _post(self, pairs):
        """One ``batch_isend_irecv`` of a send and a receive per
        (peer, send, receive), waited for."""
        ops = []
        for peer, send, recv in pairs:
            ops += [dist.P2POp(dist.isend, send, peer, self.group),
                    dist.P2POp(dist.irecv, recv, peer, self.group)]
        self._mark("exchange_post", "host")
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        self._mark("exchange_done", "host")

    def _carry(self, y_local):
        """Exclusive window: owned rows kept, the received carries added
        at local row 0 (no collective with one rank)."""
        y = torch.where(self._mask, y_local, torch.zeros_like(y_local))
        if self.part.num_shards == 1:
            return y
        self.collectives += 1
        self._routed.zero_()
        if self._spanning:
            o, d = self._owned, self._dst
            self._routed[d:d + 1].copy_(y_local[o:o + 1])
        _reduce_scatter(self._received, self._routed, self.group)
        y[:1] += self._received.to(y.device)
        return y

    def __call__(self, x):
        return self.apply(self.x_block(x))


class _WindowCsrmv(_RankCsrmv):
    """The unsplit order (JAX ``shard_body``): the exchange, one K1 over
    the share's window, the carries; ``op`` is the window's K1
    operator."""

    def __init__(self, part, group=None, alpha=1.0, tile_items=None,
                 device=None):
        super().__init__(part, group, alpha, device)
        self.op = build_operator(_local_share_csr(part, self.rank),
                                 dtype=dtype_name(part.values.dtype),
                                 tile_items=tile_items, device=self.device)

    def local(self, x_in, halo=None):
        """K1 over [left halo | own block | right halo] (x in replicate
        mode)."""
        H = self._halo_w
        x_loc = (torch.cat([halo[:H], x_in, halo[H:]]) if halo is not None
                 else x_in)
        if self.alpha != 1.0:
            x_loc = self.alpha * x_loc
        self._mark("window_start", "compute")
        y = self.op(x_loc)
        self._mark("window_end", "compute")
        return y

    def apply(self, x_in):
        """The rank's y window from its own input (``x_block``)."""
        return self._carry(self.local(x_in, self.exchange(x_in)))


class _SplitCsrmv(_RankCsrmv):
    """The split order (JAX ``shard_body_prep``) over a ``ShareSplit``
    (``split``): ``interior`` is the K1 operator of the share's interior
    items, ``boundary`` that of its boundary items (None when it has
    none)."""

    def __init__(self, split: ShareSplit, group=None, alpha=1.0,
                 device=None):
        super().__init__(split.part, group, alpha, device)
        s = self.rank
        self.split = split
        self.num_boundary = split.boundary_count(s)
        kw = dict(dtype=split.dtype, tile_items=split.tile_items,
                  device=self.device)
        self.interior = build_operator(split.interior_csr(s), **kw)
        self.boundary = (build_operator(split.boundary_csr(s, self.alpha),
                                        **kw)
                         if self.num_boundary else None)

    def _interior(self, x_in):
        self._mark("interior_start", "compute")
        y = self.interior(x_in if self.alpha == 1.0 else self.alpha * x_in)
        self._mark("interior_end", "compute")
        return y

    def _boundary(self, y, halo):
        """The boundary items added onto the interior's y: one K1 launch,
        ``y_in = y``, ``beta = 1`` (alpha is in the values)."""
        if self.boundary is None:
            return y
        self._mark("boundary_start", "compute")
        y = self.boundary(halo, y_in=y, beta=1.0)
        self._mark("boundary_end", "compute")
        return y

    def local(self, x_in, halo=None):
        """Both K1 launches of the share over a halo vector already
        exchanged (no exchange)."""
        return self._boundary(self._interior(x_in), halo)

    def apply(self, x_in):
        """The rank's y window from its own input (``x_block``): the
        interior K1 launched, then the exchange, the boundary K1, the
        carries."""
        ready = self._ready()
        y = self._interior(x_in)
        halo = self.exchange(x_in, ready)
        y = self._carry(self._boundary(y, halo))
        self._mark("carry_done", "host")
        return y


class PreparedDistributedCsrmv(_SplitCsrmv):
    """This rank's part of the SPMD operator, built once on the split
    path: ``prepare_distributed_csrmv`` and its two K1 operators; call it
    with x per call.

    ``group`` is the process group (None: the default one), whose size
    must be the partition's S; the rank's share is its rank in the group.
    ``device=None`` means the card; ``"cpu"`` runs K1's plain version.
    ``op(x)`` takes the global x ([num_cols]) and returns the rank's y
    window [rows_max]; ``apply(x_in)`` takes the rank's own input
    (``x_block``), as a caller that holds only its block would.
    """

    def __init__(self, part: MergePartition, group=None, alpha: float = 1.0,
                 tile_items=None, device=None):
        super().__init__(prepare_distributed_csrmv(
            part, dtype_name(part.values.dtype), tile_items), group, alpha,
            device)


def distributed_csrmv_fn(group, part: MergePartition, alpha: float = 1.0,
                         prepared: Optional[ShareSplit] = None,
                         device=None):
    """This rank's per-call callable, built once: ``fn(x)`` from the
    global x, ``fn.apply(x_in)`` from the rank's block, each returning
    its y window.  With ``prepared`` (``prepare_distributed_csrmv(part)``)
    the split order, else the unsplit one, as the JAX
    ``distributed_csrmv_fn(mesh, part, prepared=...)`` builds them."""
    if prepared is not None:
        if prepared.part is not part:
            raise ValueError("prepared was made from another partition")
        return _SplitCsrmv(prepared, group, alpha, device)
    return _WindowCsrmv(part, group, alpha, device=device)


def distributed_csrmv(group, part: MergePartition, x, alpha: float = 1.0,
                      device=None):
    """One-shot: this rank's y window of ``alpha * A @ x`` in the unsplit
    order.  Every rank of ``group`` (None: the default group) calls it
    with the same global x; the counterpart of the JAX
    ``distributed_csrmv(mesh, part, x)``."""
    return distributed_csrmv_fn(group, part, alpha, device=device)(x)


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
