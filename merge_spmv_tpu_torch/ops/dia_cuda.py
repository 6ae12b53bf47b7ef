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

The wrapper runs the kernel for CUDA tensors and the plain version for CPU
tensors, and raises on anything else.  ``LAUNCHES`` counts kernel launches
(never plain-version calls).
"""

from __future__ import annotations

import ctypes

import torch

from merge_spmv_tpu_torch.utils.cuda_build import (check_operand,
                                                   device_context,
                                                   load_library, on_cpu,
                                                   raise_on_launch,
                                                   raw_stream)

__all__ = ["dia_matvec", "dia_matvec_plain", "LAUNCHES", "reset_launches",
           "KERNEL_SOURCE"]

KERNEL_SOURCE = "dia_matvec"
LAUNCHES = {"dia_matvec": 0}

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_P = ctypes.c_void_p


def reset_launches():
    LAUNCHES["dia_matvec"] = 0


def _lib():
    lib = load_library(KERNEL_SOURCE)
    if not getattr(lib, "_typed", False):
        for sfx in _SUFFIX.values():
            f = getattr(lib, f"dia_matvec_{sfx}")
            f.argtypes = [_P, _P, _P, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_longlong, ctypes.c_double, _P, _P]
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
