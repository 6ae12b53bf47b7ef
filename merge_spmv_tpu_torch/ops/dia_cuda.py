"""DIA matvec on the card: the wrapper of the CUDA kernel in
csrc/dia_matvec.cu, and its plain PyTorch version.

Replaces ``merge_spmv_tpu/ops/dia_pallas.py::_dia_kernel`` (launched by
``_dia_matvec_pallas_x32``).  Both compute

    y[r] = alpha * sum_d vtab[d, r] * x[r + offsets[d]]

with x taken as zero outside ``[0, num_cols)``.  The TPU kernel stages a
padded x in VMEM and streams (D, R) tiles of the table; the card's kernel
reads the table coalesced, one thread per row, and x through the read-only
cache with a bounds predicate, so no padded copy of x is made per call
(the source note in csrc/dia_matvec.cu says what bounds it).

``dia_matmat`` (K3m, the same source) is the product over k columns at
once, ``Y[r, :] = alpha * sum_d vtab[d, r] * X[r + offsets[d], :] (+ beta
* Y_in[r, :])``, X [num_cols, k] row-major: the JAX package's DIA mm
(merge_spmv_tpu/ops/dia.py:200-220), one shifted multiply-add per diagonal
over the whole table, in one launch that reads the table once.

The wrappers run the kernels for CUDA tensors and the plain versions for
CPU tensors, and raise on anything else.  ``LAUNCHES`` counts kernel
launches (never plain-version calls).
"""

from __future__ import annotations

import ctypes

import torch

from merge_spmv_tpu_torch.utils.cuda_build import (alignment, check_operand,
                                                   device_context,
                                                   load_library, on_cpu,
                                                   raise_on_launch,
                                                   raw_stream, row_major)

__all__ = ["dia_matvec", "dia_matvec_plain", "dia_matmat",
           "dia_matmat_plain", "LAUNCHES",
           "reset_launches", "KERNEL_SOURCE", "MAX_DIAGS"]

KERNEL_SOURCE = "dia_matvec"
LAUNCHES = {"dia_matvec": 0, "dia_matmat": 0}
# dia_matmat's offsets fill at most 48 KB of shared memory
MAX_DIAGS = 6144

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_P = ctypes.c_void_p


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib():
    lib = load_library(KERNEL_SOURCE)
    if not getattr(lib, "_typed", False):
        for sfx in _SUFFIX.values():
            f = getattr(lib, f"dia_matvec_{sfx}")
            f.argtypes = [_P, _P, _P, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_longlong, ctypes.c_double, _P, _P]
            f.restype = ctypes.c_int
            f = getattr(lib, f"dia_matmat_{sfx}")
            L = ctypes.c_longlong
            f.argtypes = [_P, _P, L, _P, ctypes.c_int, L, L, ctypes.c_int,
                          ctypes.c_int, ctypes.c_double, ctypes.c_double, _P,
                          L, _P, L, _P]
            f.restype = ctypes.c_int
        lib._typed = True
    return lib


def dia_matvec_plain(vtab, x, offsets, num_rows, num_cols, alpha=1.0):
    """The JAX package's XLA chain (ops/dia.py:175-181) in PyTorch: x
    zero-padded so every shifted window is in bounds, then one
    multiply-add per diagonal in offset order.  Reads the offsets on the
    host."""
    offs = [int(o) for o in offsets.tolist()]
    m = int(num_rows)
    acc = torch.zeros(m, dtype=vtab.dtype, device=vtab.device)
    if offs:
        lpad = max(0, -min(offs))
        rpad = max(0, m - 1 + max(offs) - (int(num_cols) - 1))
        xp = torch.cat([x.new_zeros(lpad), x, x.new_zeros(rpad)])
        for i, off in enumerate(offs):
            s = lpad + off
            acc = acc + vtab[i] * xp[s:s + m]
    return acc if alpha == 1.0 else alpha * acc


def dia_matvec(vtab, x, offsets, num_rows, num_cols, alpha=1.0):
    """y = alpha * (the DIA product): the kernel for CUDA tensors, the
    plain version for CPU tensors.  ``vtab`` is (D, num_rows) float32 or
    float64, ``x`` (num_cols,) of the same type, ``offsets`` (D,) int64 on
    the same device.  Checked on the host, without a sync."""
    if on_cpu(vtab, x, offsets):
        return dia_matvec_plain(vtab, x, offsets, num_rows, num_cols, alpha)
    dtype = vtab.dtype
    if dtype not in _SUFFIX:
        raise TypeError(f"the kernel takes float32 or float64, got {dtype}")
    num_diags = offsets.shape[0] if offsets.dim() == 1 else -1
    check_operand("offsets", offsets, torch.int64, (num_diags,))
    check_operand("vtab", vtab, dtype, (num_diags, num_rows))
    check_operand("x", x, dtype, (num_cols,))
    y = torch.empty(num_rows, dtype=dtype, device=vtab.device)
    if num_rows == 0:
        return y
    lib = _lib()
    with device_context(vtab.device):
        rc = getattr(lib, f"dia_matvec_{_SUFFIX[dtype]}")(
            vtab.data_ptr(), x.data_ptr(), offsets.data_ptr(), num_diags,
            num_rows, num_cols, float(alpha), y.data_ptr(),
            raw_stream(vtab.device))
    raise_on_launch(KERNEL_SOURCE, rc, "dia_matvec")
    LAUNCHES["dia_matvec"] += 1
    return y


def dia_matmat_plain(vtab, X, offsets, num_rows, num_cols, alpha=1.0,
                     Y_in=None, beta=0.0):
    """The JAX package's DIA mm (ops/dia.py:200-220) in PyTorch: X
    zero-padded so every shifted window is in bounds, then one multiply-add
    per diagonal over all k columns, in offset order; ``beta * Y_in`` added
    last when given."""
    offs = [int(o) for o in offsets.tolist()]
    m, k = int(num_rows), X.shape[1]
    acc = torch.zeros(m, k, dtype=vtab.dtype, device=vtab.device)
    if offs:
        lpad = max(0, -min(offs))
        rpad = max(0, m - 1 + max(offs) - (int(num_cols) - 1))
        Xp = torch.cat([X.new_zeros(lpad, k), X, X.new_zeros(rpad, k)])
        for i, off in enumerate(offs):
            s = lpad + off
            acc = acc + vtab[i][:, None] * Xp[s:s + m]
    Y = acc if alpha == 1.0 else alpha * acc
    return Y if Y_in is None else Y + beta * Y_in


def _vector_width(k: int, align: int, itemsize: int) -> int:
    """Values a K3m thread loads at once: the widest of 16, 8 and 4-byte
    loads that divides a row of k values and the operands' ``align``."""
    for vbytes in (16, 8, 4):
        vec = vbytes // itemsize
        if vec >= 1 and vbytes <= align and k % vec == 0:
            return vec
    return 1


def dia_matmat(vtab, X, offsets, num_rows, num_cols, alpha=1.0, Y_in=None,
               beta=0.0):
    """Y = alpha * (the DIA product over the k columns of X) + beta * Y_in
    in one launch (K3m): the kernel for CUDA tensors, the plain version for
    CPU tensors.  ``vtab`` (D, num_rows) float32 or float64, ``X``
    (num_cols, k) and ``Y_in`` (num_rows, k) of the same type, read in
    place when row-major (any row stride; else made contiguous once),
    ``offsets`` (D,) int64.  Checked on the host, without a sync."""
    if on_cpu(vtab, X, offsets, Y_in):
        return dia_matmat_plain(vtab, X, offsets, num_rows, num_cols, alpha,
                                Y_in, beta)
    dtype = vtab.dtype
    if dtype not in _SUFFIX:
        raise TypeError(f"the kernel takes float32 or float64, got {dtype}")
    num_diags = offsets.shape[0] if offsets.dim() == 1 else -1
    check_operand("offsets", offsets, torch.int64, (num_diags,))
    check_operand("vtab", vtab, dtype, (num_diags, num_rows))
    if num_diags > MAX_DIAGS:
        raise ValueError(f"the kernel takes at most {MAX_DIAGS} diagonals, "
                         f"got {num_diags}")
    if X.dtype != dtype or (Y_in is not None and Y_in.dtype != dtype):
        raise TypeError(f"X and Y_in must be {dtype}")
    if X.dim() != 2 or X.shape[0] != num_cols:
        raise ValueError(f"X must be ({num_cols}, k), got {tuple(X.shape)}")
    k = X.shape[1]
    if Y_in is not None and tuple(Y_in.shape) != (num_rows, k):
        raise ValueError(f"Y_in must be ({num_rows}, {k})")
    if not row_major(X):
        X = X.contiguous()
    if Y_in is not None and not row_major(Y_in):
        Y_in = Y_in.contiguous()
    Y = torch.empty(num_rows, k, dtype=dtype, device=vtab.device)
    if num_rows == 0 or k == 0:
        return Y
    size = vtab.element_size()
    vec = _vector_width(k, alignment(size, X, Y, Y_in), size)
    lib = _lib()
    with device_context(vtab.device):
        rc = getattr(lib, f"dia_matmat_{_SUFFIX[dtype]}")(
            vtab.data_ptr(), X.data_ptr(), X.stride(0), offsets.data_ptr(),
            num_diags, num_rows, num_cols, k, vec, float(alpha), float(beta),
            None if Y_in is None else Y_in.data_ptr(),
            0 if Y_in is None else Y_in.stride(0), Y.data_ptr(), Y.stride(0),
            raw_stream(vtab.device))
    raise_on_launch(KERNEL_SOURCE, rc, "dia_matmat")
    LAUNCHES["dia_matmat"] += 1
    return Y
