"""CG's masked step on the card: the wrapper of the three fused vector
kernels in csrc/cg_step.cu.

``conjugate_gradient`` (models/solvers.py) takes this step where
``takes(device, dtype)`` holds, a CUDA device and float32 or float64; the
torch step there is its plain version everywhere else and the card tests'
yardstick.  A step is the operator's product ap = op(p) and then

    step(ap)    cg_pap:       act = (rs > tol2) & (k < maxiter);
                              alpha = rs / (p . ap)
                cg_update:    where act: x += alpha p, r -= alpha ap,
                              rs_n = r . r, beta = rs_n / rs, rs = rs_n,
                              k += 1
                cg_direction: where act: p = r + beta p

on the solve's own state, in place.  Preconditioned CG (``z`` and ``rz``
given) takes

    step(ap, m) pcg_pap:      act as above; alpha = rz / (p . ap)
                pcg_update:   where act: x += alpha p, r -= alpha ap,
                              rs = r . r, k += 1
                m()           z = M r, the caller's V-cycle, in place
                pcg_rz:       where act: rz_n = r . z, beta = rz_n / rz,
                              rz = rz_n
                cg_direction: where act: p = z + beta p

``FusedCgStep`` is made once a solve,
in its prologue: it checks the state, allocates the kernels' scratch
(``flags``: act and the last-block ticket; ``work``: alpha, beta and one
partial sum a block), which the solve drops at its return, and loads the
library, so nothing is loaded before the first solve on the card.
``LAUNCHES`` counts kernel launches (``PCG_LAUNCHES`` the preconditioned
step's own three); a launch recorded into a CUDA graph counts once, at
capture.
"""

from __future__ import annotations

import ctypes

import torch

from merge_spmv_tpu_torch.utils.cuda_build import (check_operand,
                                                   device_context,
                                                   load_library, on_cpu,
                                                   raise_on_launch,
                                                   raw_stream)

__all__ = ["FusedCgStep", "takes", "grid_blocks", "LAUNCHES",
           "PCG_LAUNCHES", "reset_launches", "KERNEL_SOURCE", "THREADS",
           "MAX_BLOCKS"]

KERNEL_SOURCE = "cg_step"
LAUNCHES = {"cg_pap": 0, "cg_update": 0, "cg_direction": 0}
PCG_LAUNCHES = {"pcg_pap": 0, "pcg_update": 0, "pcg_rz": 0}
THREADS = 256       # csrc/cg_step.cu::kThreads
MAX_BLOCKS = 1024   # csrc/cg_step.cu::kMaxBlocks: one wave, 8 blocks an SM
HEAD = 2            # work[0] alpha, work[1] beta, then the partials

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


def reset_launches():
    for counts in (LAUNCHES, PCG_LAUNCHES):
        for k in counts:
            counts[k] = 0


def takes(device, dtype) -> bool:
    """Whether CG's step on ``device`` in ``dtype`` is the fused one."""
    return torch.device(device).type == "cuda" and dtype in _SUFFIX


def grid_blocks(n: int) -> int:
    """The kernels' grid for vectors of ``n`` values: a function of n
    alone, so the sums' order, and their bits, never change."""
    return max(1, min(-(-n // THREADS), MAX_BLOCKS))


def _lib():
    lib = load_library(KERNEL_SOURCE)
    if not getattr(lib, "_typed", False):
        for sfx in _SUFFIX.values():
            f = getattr(lib, f"cg_pap_{sfx}")
            f.argtypes = [_P, _P, _L, _P, _P, _P, _I, _P, _P, _I, _P]
            f = getattr(lib, f"cg_update_{sfx}")
            f.argtypes = [_P, _P, _P, _P, _L, _P, _P, _P, _P, _I, _P]
            f = getattr(lib, f"cg_direction_{sfx}")
            f.argtypes = [_P, _P, _L, _P, _P, _I, _P]
            f = getattr(lib, f"pcg_pap_{sfx}")
            f.argtypes = [_P, _P, _L, _P, _P, _P, _P, _I, _P, _P, _I, _P]
            f = getattr(lib, f"pcg_update_{sfx}")
            f.argtypes = [_P, _P, _P, _P, _L, _P, _P, _P, _P, _I, _P]
            f = getattr(lib, f"pcg_rz_{sfx}")
            f.argtypes = [_P, _P, _L, _P, _P, _P, _I, _P]
            for name in ("cg_pap", "cg_update", "cg_direction", "pcg_pap",
                         "pcg_update", "pcg_rz"):
                getattr(lib, f"{name}_{sfx}").restype = ctypes.c_int
        lib._typed = True
    return lib


class FusedCgStep:
    """The fused step over one solve's state: x, r, p (n,) and rs, tol2
    (0-dim) of one dtype, k (0-dim int32), and for preconditioned CG z
    (n,) and rz (0-dim), all contiguous on one CUDA device; updated in
    place by ``step(ap)`` (``step(ap, precondition)`` with z).  Checked
    here, on the host, without a sync."""

    def __init__(self, x, r, p, rs, tol2, k, maxiter: int, z=None, rz=None):
        dtype = x.dtype
        if dtype not in _SUFFIX:
            raise TypeError(f"the fused CG step takes float32 or float64, "
                            f"got {dtype}")
        if (z is None) != (rz is None):
            raise ValueError("preconditioned CG takes both z and rz")
        n = x.shape[0] if x.dim() == 1 else -1
        vectors = (("x", x), ("r", r), ("p", p)) + (
            () if z is None else (("z", z),))
        for name, t in vectors:
            check_operand(name, t, dtype, (n,))
        for name, t in (("rs", rs), ("tol2", tol2)) + (
                () if rz is None else (("rz", rz),)):
            check_operand(name, t, dtype, ())
        check_operand("k", k, torch.int32, ())
        if on_cpu(x, r, p, rs, tol2, k, z, rz):
            raise ValueError("the fused CG step runs on a CUDA device")
        self.preconditioned = z is not None
        self.state = (x, r, p, rs, tol2, k, z, rz)   # alive while pointed at
        self.device, self.dtype, self.n = x.device, dtype, n
        self.maxiter = min(int(maxiter), 2 ** 31 - 1)   # k is int32
        self.blocks = grid_blocks(n)
        self.flags = torch.zeros(2, dtype=torch.int32, device=x.device)
        self.work = torch.empty(HEAD + self.blocks, dtype=dtype,
                                device=x.device)
        self._ptr = {name: t.data_ptr() for name, t in zip(
            ("x", "r", "p", "rs", "tol2", "k", "z", "rz", "flags", "work"),
            (*self.state, self.flags, self.work)) if t is not None}
        lib, sfx = _lib(), _SUFFIX[dtype]
        self._kernels = {name: getattr(lib, f"{name}_{sfx}")
                         for name in (*LAUNCHES, *PCG_LAUNCHES)}

    def _launch(self, name, stream, *args):
        rc = self._kernels[name](*args, self.blocks, stream)
        raise_on_launch(KERNEL_SOURCE, rc, name)
        (PCG_LAUNCHES if name in PCG_LAUNCHES else LAUNCHES)[name] += 1

    def step(self, ap, precondition=None):
        """One masked step after ap = op(p): three launches; with z,
        ``precondition()`` (z = M r, in place) between the update and the
        direction, and four launches."""
        check_operand("ap", ap, self.dtype, (self.n,))
        if ap.device != self.device:
            raise ValueError(f"ap must be on {self.device}, got {ap.device}")
        if (precondition is None) == self.preconditioned:
            raise ValueError("a preconditioned step takes precondition, "
                             "and only it")
        q, a, n = self._ptr, ap.data_ptr(), self.n
        with device_context(self.device):
            st = raw_stream(self.device)
            if not self.preconditioned:
                self._launch("cg_pap", st, q["p"], a, n, q["rs"], q["tol2"],
                             q["k"], self.maxiter, q["flags"], q["work"])
                self._launch("cg_update", st, q["x"], q["r"], q["p"], a, n,
                             q["rs"], q["k"], q["flags"], q["work"])
                self._launch("cg_direction", st, q["p"], q["r"], n, q["flags"],
                             q["work"])
                return
            self._launch("pcg_pap", st, q["p"], a, n, q["rs"], q["rz"],
                         q["tol2"], q["k"], self.maxiter, q["flags"],
                         q["work"])
            self._launch("pcg_update", st, q["x"], q["r"], q["p"], a, n,
                         q["rs"], q["k"], q["flags"], q["work"])
            precondition()
            self._launch("pcg_rz", st, q["r"], q["z"], n, q["rz"], q["flags"],
                         q["work"])
            self._launch("cg_direction", st, q["p"], q["z"], n, q["flags"],
                         q["work"])
