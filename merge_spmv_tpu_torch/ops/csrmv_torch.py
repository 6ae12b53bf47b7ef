"""Segment-sum CsrMV/CsrMM in plain PyTorch — the "torch" backend and the
tests' independent oracle.

Counterpart of merge_spmv_tpu/ops/csrmv_xla.py:

    row_ids  = searchsorted(row_end_offsets, 0..nnz-1, right=True)
    products = values * x[col_indices]
    y        = alpha * segment_sum(products, row_ids) + beta * y_in

The segment sum is ``index_add_``; above ``_SCATTER_NNZ_CAP`` nonzeros the
scatter-free sorted-segment form with a compensated (hi, lo) block prefix
takes over, as in the JAX package.  ``index_add_`` on a CUDA tensor adds
with atomics in no fixed order; the operator's path on the card is the
merge kernel (ops/csrmv_cuda.py), not this module.
"""

from __future__ import annotations

import torch

__all__ = ["csrmv_torch", "csrmm_torch", "row_ids_from_offsets"]

# Above this nnz count the scatter-add is replaced by the sorted-segment
# cumsum-difference form (csrmv_xla.py:39-44).
_SCATTER_NNZ_CAP = 1 << 22

_BLOCK = 1024


def row_ids_from_offsets(row_end_offsets, num_nonzeros: int):
    """Per-nonzero row id: first r with row_end_offsets[r] > j (empty rows
    are skipped naturally)."""
    j = torch.arange(num_nonzeros, device=row_end_offsets.device)
    return torch.searchsorted(row_end_offsets.long(), j, right=True)


def _twofloat_exclusive_scan(x, dim=0):
    """Compensated (hi, lo) exclusive prefix scan along ``dim``: each prefix
    carries a residual term, so DIFFERENCES of two prefixes recover the
    range sum to ~eps * |range sum| instead of ~eps * |global prefix|
    (csrmv_xla.py:47-69).  A log-step (Hillis-Steele) scan of Knuth's
    TwoSum in place of ``lax.associative_scan``."""

    def two_add(ah, al, bh, bl):
        s = ah + bh
        bp = s - ah
        err = (ah - (s - bp)) + (bh - bp)
        return s, al + bl + err

    n = x.shape[dim]
    hi, lo = x, torch.zeros_like(x)
    step = 1
    while step < n:
        sh, sl = two_add(hi.narrow(dim, 0, n - step), lo.narrow(dim, 0, n - step),
                         hi.narrow(dim, step, n - step),
                         lo.narrow(dim, step, n - step))
        hi = torch.cat([hi.narrow(dim, 0, step), sh], dim)
        lo = torch.cat([lo.narrow(dim, 0, step), sl], dim)
        step *= 2
    shape = list(x.shape)
    shape[dim] = 1
    zero = torch.zeros(shape, dtype=x.dtype, device=x.device)
    return (torch.cat([zero, hi.narrow(dim, 0, n - 1)], dim),
            torch.cat([zero, lo.narrow(dim, 0, n - 1)], dim))


def _sorted_segment_sum(products, row_end_offsets):
    """Segment sum over SORTED segments given CSR row-end offsets,
    scatter-free (csrmv_xla.py:72-135): block-local cumsums + a compensated
    block-prefix scan, endpoint gathers and a first difference.  Works on
    products of shape [nnz] or [nnz, k].  Each endpoint stays the triple
    (block-local cs, prefix hi, prefix lo) until the difference, so rows
    keep ~eps * |block-local prefix| error."""
    nnz = products.shape[0]
    rest = tuple(products.shape[1:])
    nb = -(-nnz // _BLOCK)
    padded = torch.zeros((nb * _BLOCK,) + rest, dtype=products.dtype,
                         device=products.device)
    padded[:nnz] = products
    cs = torch.cumsum(padded.reshape((nb, _BLOCK) + rest), dim=1)
    bh, bl = _twofloat_exclusive_scan(cs[:, -1], dim=0)
    cs_flat = cs.reshape((nb * _BLOCK,) + rest)
    ends = row_end_offsets.long()
    prev = torch.cat([ends.new_zeros(1), ends[:-1]])

    def endpoint(p):
        """(cs, bh, bl) at inclusive position p - 1; S(-1) = (0, 0, 0)."""
        valid = (p > 0).reshape((-1,) + (1,) * len(rest))
        pos = (p - 1).clamp(min=0)
        blk = pos // _BLOCK
        z = torch.zeros((), dtype=products.dtype, device=products.device)
        return (torch.where(valid, cs_flat[pos], z),
                torch.where(valid, bh[blk], z),
                torch.where(valid, bl[blk], z))

    ce, he, le = endpoint(ends)
    cs_, hs, ls = endpoint(prev)
    return (ce - cs_) + ((he - hs) + (le - ls))


def _segment_sum(products, row_end_offsets):
    num_rows = row_end_offsets.shape[0]
    nnz = products.shape[0]
    if nnz > _SCATTER_NNZ_CAP:
        return _sorted_segment_sum(products, row_end_offsets)
    out = torch.zeros((num_rows,) + tuple(products.shape[1:]),
                      dtype=products.dtype, device=products.device)
    return out.index_add_(0, row_ids_from_offsets(row_end_offsets, nnz),
                          products)


def csrmv_torch(values, row_end_offsets, col_indices, x, y_in=None,
                alpha=1.0, beta=0.0):
    """y = alpha * A @ x + beta * y_in over CSR arrays (values/col_indices
    [nnz], row_end_offsets [num_rows], x [num_cols]); duplicates
    accumulate and empty rows yield beta * y_in, as SpmvGold
    (cpu_spmv.cpp:257-277)."""
    products = values * x[col_indices.long()]
    y = alpha * _segment_sum(products, row_end_offsets)
    if y_in is not None:
        y = y + beta * y_in
    return y


def csrmm_torch(values, row_end_offsets, col_indices, X, Y_in=None,
                alpha=1.0, beta=0.0):
    """Y = alpha * A @ X + beta * Y_in, X: [num_cols, k]."""
    products = X[col_indices.long()] * values[:, None]
    Y = alpha * _segment_sum(products, row_end_offsets)
    if Y_in is not None:
        Y = Y + beta * Y_in
    return Y
