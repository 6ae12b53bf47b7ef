"""Build the package's CUDA sources into plain-C shared libraries, and the
operand checks every kernel wrapper shares.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into
``build/lib<name>-<hash>.so`` at first use, where ``<hash>`` is taken from
the source text, so an edited source never loads a stale library.  The
libraries expose ``extern "C"`` entry points and are loaded with ctypes;
no PyTorch header is compiled, which keeps a build to seconds.  Every
library exports ``<name>_error_string(code)`` for its launch codes.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import math
import os
import shutil
import subprocess
from pathlib import Path

import torch

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "build_library",
           "load_library", "on_cpu", "check_operand", "raise_on_launch",
           "device_context", "raw_stream", "row_major", "alignment"]

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LOADED: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _library_path(name: str) -> Path:
    text = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha1(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build_library(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its current library exists.
    Returns the compiler's output ("" when nothing was compiled); raises
    if nvcc fails."""
    out = _library_path(name)
    if out.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}")
    os.replace(tmp, out)   # a concurrent loader never sees half a file
    return proc.stdout


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        build_library(name)
        lib = ctypes.CDLL(str(_library_path(name)))
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _LOADED[name] = lib
    return lib


def raise_on_launch(name: str, rc: int, what: str):
    """Raise if a launch of library ``name`` returned a CUDA error code."""
    if rc != 0:
        msg = getattr(load_library(name), f"{name}_error_string")(rc)
        raise RuntimeError(f"{what} launch failed: CUDA error {rc}: "
                           f"{msg.decode()}")


def on_cpu(*tensors) -> bool:
    """True when every given tensor lies on the CPU (the plain versions'
    route), False when all lie on one CUDA device; raises otherwise."""
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type == "cpu"


def device_context(dev):
    """Makes CUDA device ``dev`` current for a launch: a no-op when it
    already is (the common case), since entering ``torch.cuda.device``
    costs host time on every call."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def raw_stream(dev) -> int:
    """The handle of device ``dev``'s current stream, looked up without
    making a ``torch.cuda.Stream`` object."""
    index = torch.cuda.current_device() if dev.index is None else dev.index
    return torch._C._cuda_getCurrentRawStream(index)


def check_operand(name, t, dtype, shape=None):
    """A kernel operand must have ``dtype``, be contiguous and, where
    given, have ``shape``: checked on the host, without a sync."""
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")


def row_major(t) -> bool:
    """Rows of ``t`` [n, k] lie apart at ``stride(0)``, their k values next
    to each other: what the multi-RHS kernels read in place."""
    return (t.shape[1] <= 1 or t.stride(1) == 1) and \
        (t.shape[0] <= 1 or t.stride(0) >= t.shape[1])


def alignment(itemsize: int, *tensors) -> int:
    """The largest of 16, 8, 4, ... bytes that divides every given
    tensor's address and row stride in bytes: the widest vector load a
    multi-RHS kernel may use on them."""
    a = 16
    for t in tensors:
        if t is not None:
            a = math.gcd(a, t.data_ptr(), t.stride(0) * itemsize)
    return a
