"""The multigrid V-cycle's kernels on the card: the wrappers of
csrc/multigrid.cu, and their plain versions.

``models/multigrid.py`` runs HPCG's V-cycle as these kernels and each
level's residual product (K1, through the level's SpmvOperator):

    bind_colour_step(x, r, op, rows, diag)   y = A_c x over the colour's
                                             gathered rows (op), then
                                             x[rows] += (r[rows] - y) / diag
    bind_restrict(rc, xc, r, axf, f2c)       rc = r[f2c] - axf[f2c]; xc = 0
    bind_prolong(x, xc, f2c)                 x[f2c] += xc
    bind_zero(x)                             x = 0 (a memset on the card)

all in place, on contiguous tensors of one dtype (float32 or float64) and
int32 index vectors, on one device.  Each checks its operands once and
returns a launcher: ``launch(stream=None)`` runs the kernel for CUDA
tensors and its plain version (the same arithmetic in torch ops, the CPU
tests' route) for CPU tensors; a dtype the kernel lacks raises on the
card.  A colour step is one launch on the card (symgs_update_kernel);
on the CPU it is the colour operator's bound product, then
``symgs_update_plain``.  An empty index vector launches nothing.  A card
launcher carries its C entry and arguments (``entry``) and the count it
adds to (``counter``), so that ``Graph`` can capture a run of launchers,
these and K1's (``csrmv_cuda.bind_merge_csrmv``), into one CUDA graph:
the V-cycle then costs the host one call a level's run, not one a
kernel.  ``LAUNCHES`` counts the kernels' launches by entry; a launch
recorded into a CUDA graph counts once, at capture, and ``Graph`` leaves
the counting to its caller.
"""

from __future__ import annotations

import ctypes

import torch

from merge_spmv_tpu_torch.utils.cuda_build import (check_operand,
                                                   device_context,
                                                   load_library, on_cpu,
                                                   raise_on_launch,
                                                   raw_stream)

__all__ = ["bind_colour_step", "bind_restrict", "bind_prolong", "bind_zero",
           "Graph", "symgs_update_plain",
           "restrict_plain", "prolong_plain", "LAUNCHES", "reset_launches",
           "KERNEL_SOURCE", "THREADS"]

KERNEL_SOURCE = "multigrid"
LAUNCHES = {"symgs_colour": 0, "mg_restrict": 0, "mg_prolong": 0}
THREADS = 256   # csrc/multigrid.cu::kThreads

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib():
    lib = load_library(KERNEL_SOURCE)
    if not getattr(lib, "_typed", False):
        for sfx in _SUFFIX.values():
            for name, args in (("symgs_colour", [_P] * 7),
                               ("mg_restrict", [_P] * 5),
                               ("mg_prolong", [_P] * 3)):
                f = getattr(lib, f"{name}_{sfx}")
                f.argtypes = args + [_I, _P]
                f.restype = _I
        for name, args in (("mg_zero", [_P, _L, _P]),
                           ("mg_capture_begin", [_P]),
                           ("mg_capture_end",
                            [_P, ctypes.POINTER(_P), ctypes.POINTER(_P)]),
                           ("mg_graph_launch", [_P, _P, _P]),
                           ("mg_graph_destroy", [_P, _P])):
            f = getattr(lib, name)
            f.argtypes = args
            f.restype = _I
        lib._typed = True
    return lib


def symgs_update_plain(x, r, y, rows, diag):
    rows = rows.long()
    x[rows] += (r[rows] - y) / diag
    return x


def restrict_plain(rc, xc, r, axf, f2c):
    f2c = f2c.long()
    torch.sub(r[f2c], axf[f2c], out=rc)
    xc.zero_()
    return rc


def prolong_plain(x, xc, f2c):
    x[f2c.long()] += xc
    return x


def _nothing(stream=None):
    return None


def _bind(name, plain, vectors, indices, n, pointers):
    """Check the operands once and return a launcher, ``launch(stream=
    None)``: a call of the kernel on ``pointers`` for CUDA tensors, on the
    given raw stream (the caller's device current) or else on the current
    stream; ``plain`` for CPU ones.  ``vectors``: (name, tensor, length or
    None) of the value type; ``indices``: (name, tensor, length) int32."""
    tensors = [t for _, t, _ in vectors] + [t for _, t, _ in indices]
    if on_cpu(*tensors):
        return plain
    dtype = vectors[0][1].dtype
    if dtype not in _SUFFIX:
        raise TypeError(f"{name} takes float32 or float64, got {dtype}")
    for label, t, length in vectors:
        check_operand(label, t, dtype, None if length is None else (length,))
        if t.dim() != 1:
            raise ValueError(f"{label} must be a vector")
    for label, t, length in indices:
        check_operand(label, t, torch.int32, (length,))
    if n == 0:
        return _nothing
    dev = vectors[0][1].device
    fn = getattr(_lib(), f"{name}_{_SUFFIX[dtype]}")
    args = tuple(t.data_ptr() for t in pointers) + (n,)

    def launch(stream=None):
        if stream is None:
            with device_context(dev):
                rc = fn(*args, raw_stream(dev))
        else:
            rc = fn(*args, stream)
        if rc:
            raise_on_launch(KERNEL_SOURCE, rc, name)
        LAUNCHES[name] += 1
    launch.operands = pointers   # alive while the launcher points at them
    launch.entry, launch.counter = (fn, args), (LAUNCHES, name)
    return launch


def bind_colour_step(x, r, op, rows, diag):
    """A launcher of one colour's Gauss-Seidel step, in place: y = A_c x
    over the colour's rows, then x[rows] += (r[rows] - y) / diag.  ``op``
    is the SpmvOperator of the colour's gathered rows (all columns), rows
    and diag have one entry a row of it; the tensors must stay alive and in
    place while the launcher is used.  On the card one launch of
    symgs_update_kernel over op's CSR arrays; on the CPU op's bound
    product (into a y of its own), then symgs_update_plain."""
    n = rows.shape[0]
    if op.shape != (n, x.shape[0]):
        raise ValueError(f"op must be {n} x {x.shape[0]}, got {op.shape}")
    if on_cpu(x, r, rows, diag, op.values):
        product, y = op.bind(x)

        def plain(stream=None):
            product(stream)
            symgs_update_plain(x, r, y, rows, diag)
        return plain
    nnz = op.values.shape[0]
    return _bind("symgs_colour", None,
                 [("x", x, None), ("r", r, x.shape[0]),
                  ("values", op.values, nnz), ("diag", diag, n)],
                 [("rows", rows, n), ("row_ends", op.row_end_offsets, n),
                  ("cols", op.col_indices, nnz)], n,
                 (x, r, op.values, op.col_indices, op.row_end_offsets, rows,
                  diag))


def bind_restrict(rc, xc, r, axf, f2c):
    """A launcher of rc = r[f2c] - axf[f2c] and xc = 0, in place: the
    coarse residual by injection and the coarse level's start."""
    n = f2c.shape[0]
    return _bind("mg_restrict",
                 lambda stream=None: restrict_plain(rc, xc, r, axf, f2c),
                 [("rc", rc, n), ("xc", xc, n), ("r", r, None),
                  ("axf", axf, r.shape[0])], [("f2c", f2c, n)], n,
                 (rc, xc, r, axf, f2c))


def bind_prolong(x, xc, f2c):
    """A launcher of x[f2c] += xc, in place."""
    n = f2c.shape[0]
    return _bind("mg_prolong", lambda stream=None: prolong_plain(x, xc, f2c),
                 [("x", x, None), ("xc", xc, n)], [("f2c", f2c, n)], n,
                 (x, xc, f2c))


def bind_zero(x):
    """A launcher of x = 0, in place: a memset on the card (+0.0 is all
    zero bits), ``x.zero_()`` on the CPU.  Counted nowhere."""
    if on_cpu(x):
        return lambda stream=None: x.zero_()
    check_operand("x", x, x.dtype)
    dev, fn = x.device, _lib().mg_zero
    args = (x.data_ptr(), x.numel() * x.element_size())

    def launch(stream=None):
        if stream is None:
            with device_context(dev):
                rc = fn(*args, raw_stream(dev))
        else:
            rc = fn(*args, stream)
        if rc:
            raise_on_launch(KERNEL_SOURCE, rc, "mg_zero")
    launch.operands = (x,)
    launch.entry, launch.counter = (fn, args), None
    return launch


class Graph:
    """One CUDA graph of card ``launchers`` (each with ``entry``), in
    order, captured once on a side stream of ``device``: their C entries
    called on it, nothing counted.  ``launch(stream)`` runs it on that raw
    stream, or, while the stream is being captured, adds it to that
    capture as one child-graph node (a copy: this graph may go first).
    Holds the launchers' operands while it points at them."""

    def __init__(self, launchers, device):
        lib = self._lib = _lib()
        side = torch.cuda.Stream(device)   # non-blocking: never the null one
        graph, exe = _P(), _P()
        failed = None
        with device_context(device):
            raise_on_launch(KERNEL_SOURCE,
                            lib.mg_capture_begin(side.cuda_stream),
                            "graph capture")
            try:
                for launch in launchers:
                    fn, args = launch.entry
                    rc = fn(*args, side.cuda_stream)
                    if rc:
                        failed = rc
                        break
            finally:
                ended = lib.mg_capture_end(side.cuda_stream,
                                           ctypes.byref(graph),
                                           ctypes.byref(exe))
        raise_on_launch(KERNEL_SOURCE, failed or 0, "a captured kernel")
        raise_on_launch(KERNEL_SOURCE, ended, "graph capture")
        self._handles = (graph.value, exe.value)
        self.operands = tuple(launch.operands for launch in launchers)

    def launch(self, stream):
        raise_on_launch(KERNEL_SOURCE,
                        self._lib.mg_graph_launch(*self._handles, stream),
                        "graph")

    def __del__(self):
        handles = getattr(self, "_handles", None)
        if handles is not None:
            self._handles = None
            self._lib.mg_graph_destroy(*handles)

