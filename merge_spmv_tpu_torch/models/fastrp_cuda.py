"""FastRP's normalise-and-accumulate on the card: the wrapper of
csrc/row_normalize.cu, and its plain version.

After each product N = P X, ``models/solvers.py::fastrp`` divides every row
of N by its L2 norm (a row of norm 0 stays 0), n(N), and adds w n(N) into
the embedding E.  ``row_normalize(n, e, w, store_n)`` does it in one launch
that reads N once, on a CUDA device (``takes``), in the port's three
dtypes: float32 and float64 computed in their own precision, bfloat16
loaded and stored as such and computed in float32.  ``row_normalize_plain``
is the torch code the solver ran before, four passes over N (the norms,
the division, E's multiply or add); it runs on the CPU, and the card tests
hold the kernel to it.

Both take N [rows, d], contiguous; E [rows, d] of N's dtype and device, or
None; the weight w; and ``store_n``, whether n(N) is written back into N
(else N keeps its values).  What E receives follows from w and E:

    w == 0          E untouched (returned as given, None included)
    E is None       E = w n(N), a new tensor
    otherwise       E += w n(N), in place

and both return that E.  With neither ``store_n`` nor a nonzero w a call
writes nothing (the kernel still reads N once; fastrp makes no such
call).  Nothing waits on the host.  ``LAUNCHES`` counts the kernel's
launches.
"""

from __future__ import annotations

import ctypes

import torch

from merge_spmv_tpu_torch.utils.cuda_build import (alignment, check_operand,
                                                   device_context,
                                                   load_library, on_cpu,
                                                   raise_on_launch,
                                                   raw_stream)

__all__ = ["row_normalize", "row_normalize_plain", "takes",
           "vectors_per_lane", "grid_blocks", "LAUNCHES", "reset_launches",
           "KERNEL_SOURCE", "THREADS", "ROWS_IN_FLIGHT", "MAX_VECTORS",
           "MAX_BLOCKS"]

KERNEL_SOURCE = "row_normalize"
LAUNCHES = {"row_normalize": 0}
THREADS = 256           # csrc/row_normalize.cu::kThreads
ROWS_IN_FLIGHT = 2      # csrc/row_normalize.cu::kRowsInFlight
MAX_VECTORS = 4         # 16-byte vectors a lane a row on the vector path
MAX_BLOCKS = 2 ** 31 - 1          # the grid's x dimension
E_NONE, E_SET, E_ADD = 0, 1, 2    # csrc/row_normalize.cu's e_mode

_SUFFIX = {torch.float32: "f32", torch.float64: "f64",
           torch.bfloat16: "bf16"}
_P, _L, _I, _D = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, \
    ctypes.c_double


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def takes(device) -> bool:
    """Whether the normalise-and-accumulate on ``device`` is the kernel's:
    on every CUDA device, where a dtype the kernel lacks raises."""
    return torch.device(device).type == "cuda"


def vectors_per_lane(d: int, itemsize: int, align: int) -> int:
    """The kernel's path for rows of ``d`` values of ``itemsize`` bytes
    whose addresses and strides are multiples of ``align`` bytes: the
    16-byte vectors each of a warp's 32 lanes holds of a row (1 to
    MAX_VECTORS), or 0, the scalar path, where a row is not a whole number
    of aligned vectors or is longer than 32 * MAX_VECTORS of them."""
    row = d * itemsize
    if d < 1 or align % 16 or row % 16 or row > 16 * 32 * MAX_VECTORS:
        return 0
    return -(-(row // 16) // 32)


def _lib():
    lib = load_library(KERNEL_SOURCE)
    if not getattr(lib, "_typed", False):
        for sfx in _SUFFIX.values():
            f = getattr(lib, f"row_normalize_{sfx}")
            f.argtypes = [_P, _L, _I, _L, _P, _D, _I, _I, _I, _I, _P]
            f.restype = ctypes.c_int
        lib._typed = True
    return lib


def grid_blocks(rows: int, vectors: int) -> int:
    """The grid: a block per (THREADS / 32) * ROWS_IN_FLIGHT rows on the
    vector path (a warp a row on the scalar path), at most MAX_BLOCKS; a
    warp strides over the rows past them."""
    per_block = (THREADS // 32) * (ROWS_IN_FLIGHT if vectors else 1)
    return max(1, min(MAX_BLOCKS, -(-rows // per_block)))


def _check(n, e):
    """N [rows, d] contiguous; E, where given, N's shape, dtype and
    device, contiguous.  On the host, without a sync."""
    if n.dim() != 2:
        raise ValueError(f"N must be [rows, d], got shape {tuple(n.shape)}")
    check_operand("N", n, n.dtype)
    if e is not None:
        check_operand("E", e, n.dtype, n.shape)
        on_cpu(n, e)      # raises if they lie on two devices


def _e_mode(e, w) -> int:
    return E_NONE if w == 0.0 else E_SET if e is None else E_ADD


def row_normalize_plain(n, e, w: float, store_n: bool = True):
    """The torch ops: the norms, the division (in place when ``store_n``),
    E's multiply or add."""
    _check(n, e)
    norms = torch.linalg.vector_norm(n, dim=1, keepdim=True)
    norms = torch.where(norms > 0, norms, 1.0)
    m = n.div_(norms) if store_n else n / norms
    mode = _e_mode(e, w)
    if mode == E_SET:
        return m * w
    if mode == E_ADD:
        e.add_(m, alpha=w)
    return e


def row_normalize(n, e, w: float, store_n: bool = True):
    """The kernel: one launch on the current stream, E allocated here
    where it is new."""
    _check(n, e)
    if n.dtype not in _SUFFIX:
        raise TypeError(f"the row normalisation takes float32, float64 or "
                        f"bfloat16, got {n.dtype}")
    if on_cpu(n, e):
        raise ValueError("the row normalisation kernel runs on a CUDA "
                         "device")
    w = float(w)
    mode = _e_mode(e, w)
    if mode == E_SET:
        e = torch.empty_like(n)
    rows, d = n.shape
    vectors = vectors_per_lane(d, n.element_size(),
                               alignment(n.element_size(), n, e))
    dev = n.device
    with device_context(dev):
        rc = getattr(_lib(), f"row_normalize_{_SUFFIX[n.dtype]}")(
            n.data_ptr(), rows, d, n.stride(0),
            None if e is None else e.data_ptr(), w, int(store_n), mode,
            vectors, grid_blocks(rows, vectors), raw_stream(dev))
    raise_on_launch(KERNEL_SOURCE, rc, "row_normalize")
    LAUNCHES["row_normalize"] += 1
    return e
