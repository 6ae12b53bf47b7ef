"""The plain reference and the comparison that decides ``correct``.

Plain PyTorch over the CSR that the benchmark's own generator makes
(``generators/``): no kernel, no operator, nothing of the package under
test.  Products run in blocks of nonzeros, each gathering at most
``BLOCK`` elements of x (2^24 nonzeros at k = 1, 2^16 at k = 256), so the
reference fits beside what is left on the card after a run.

``dtype`` is the precision the reference computes in: float64 for the
reference, the next precision below the configuration's for the control
(``control.py``: float32 under a float64 configuration, bfloat16 under a
float32 one).  ``product_error`` measures in the unit roundoff of the
configuration's dtype (``unit_roundoff``).
"""

from __future__ import annotations

import torch

# the most elements of x (nonzeros x columns) one block gathers
BLOCK = 1 << 24


def row_lengths(csr: dict) -> torch.Tensor:
    return csr["row_offsets"][1:] - csr["row_offsets"][:-1]


def max_row_abs_sum(csr: dict) -> float:
    """max over rows of sum |a_ij|, in float64, by a segment reduction:
    the same bits on every call, so the harness's alpha and the
    reference's agree."""
    sums = torch.segment_reduce(csr["values"].double().abs(), "sum",
                                offsets=csr["row_offsets"])
    return float(sums.max())


def unit_roundoff(dtype: str) -> float:
    """The unit roundoff of the dtype named ``dtype``: 2^-53 for
    float64, 2^-24 for float32."""
    return torch.finfo(getattr(torch, dtype)).eps / 2


def block_nonzeros(columns: int) -> int:
    """The nonzeros a block of ``product`` takes for x of ``columns``
    columns: BLOCK gathered elements, at least one nonzero."""
    return max(BLOCK // columns, 1)


def product(csr: dict, x: torch.Tensor, dtype=torch.float64,
            absolute: bool = False) -> torch.Tensor:
    """A @ x (or |A| @ |x| with ``absolute``) for x [cols] or [cols, k],
    summed in ``dtype`` by rows, ``block_nonzeros(k)`` nonzeros at a
    time."""
    offsets = csr["row_offsets"]
    nnz = int(offsets[-1])
    xs = x.to(dtype)
    if absolute:
        xs = xs.abs()
    out = torch.zeros((csr["num_rows"],) + tuple(x.shape[1:]), dtype=dtype,
                      device=x.device)
    block = block_nonzeros(x.shape[1] if x.dim() == 2 else 1)
    for start in range(0, nnz, block):
        stop = min(start + block, nnz)
        pos = torch.arange(start, stop, device=x.device)
        rows = torch.searchsorted(offsets, pos, right=True) - 1
        vals = csr["values"][start:stop].to(dtype)
        if absolute:
            vals = vals.abs()
        gathered = xs[csr["col_indices"][start:stop].long()]
        if gathered.dim() == 2:
            vals = vals[:, None]
        out.index_add_(0, rows, vals * gathered)
    return out


def affine(csr: dict, x, y_in, alpha: float, beta: float,
           dtype=torch.float64) -> torch.Tensor:
    """alpha A x + beta y_in in ``dtype``, returned in float64."""
    y = alpha * product(csr, x, dtype)
    if beta != 0.0:
        y = y + beta * y_in.to(dtype)
    return y.double()


def conjugate_gradient(csr: dict, b: torch.Tensor, maxiter: int,
                       dtype=torch.float64):
    """Hestenes-Stiefel CG from x0 = 0 for ``maxiter`` iterations in
    ``dtype``; returns (x, ||r|| of the recurrence) in float64."""
    b = b.to(dtype)
    x = torch.zeros_like(b)
    r = b.clone()
    p = r.clone()
    rs = torch.dot(r, r)
    for _ in range(maxiter):
        ap = product(csr, p, dtype)
        alpha = rs / torch.dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        rs_n = torch.dot(r, r)
        p = r + (rs_n / rs) * p
        rs = rs_n
    return x.double(), float(torch.sqrt(rs))


def product_error(csr: dict, y, x, y_in, alpha: float, beta: float,
                  y_ref, unit: float) -> float:
    """The worst |y - y_ref| over all rows (and right-hand sides), in
    units of u ((n + 2) |alpha| (|A| |x|) + |beta y_in|) of its row, u =
    ``unit`` the unit roundoff of the configuration's dtype
    (``unit_roundoff``) and n the row's length: a sum of a row in that
    dtype, in any order, lies within about 1 of it of the exact sum, and
    so within about 2 of the float64 reference's."""
    n = row_lengths(csr).to(torch.float64)
    if y.dim() == 2:
        n = n[:, None]
    scale = (n + 2) * abs(alpha) * product(csr, x, absolute=True)
    if beta != 0.0:
        scale = scale + abs(beta) * y_in.double().abs()
    scale = scale * unit
    err = (y.double() - y_ref).abs()
    ratio = torch.where(scale > 0, err / scale,
                        torch.where(err > 0, torch.inf, 0.0))
    ratio = torch.where(torch.isnan(y.double()), torch.inf, ratio)
    return float(ratio.max())


def relative_error(x, x_ref) -> float:
    """max |x - x_ref| over max |x_ref|; inf where x is not finite."""
    x = x.double()
    if not bool(torch.isfinite(x).all()):
        return float("inf")
    return float((x - x_ref).abs().max() / x_ref.abs().max())
