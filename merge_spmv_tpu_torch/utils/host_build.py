"""Build the package's host C++ sources (``csrc/<name>.cpp``) with g++.

The counterpart of ``utils/cuda_build.py`` for code that runs on the host:
``csrc/market_io.cpp`` (Matrix Market parsing, COO->CSR and the writer) is
compiled at first use, never at import, into
``build/lib<name>-<hash>.so`` with the TPU package's native/Makefile
flags.  ``<hash>`` is taken from the source text, the flags and the
macros g++ defines for ``-march=native`` on this machine, so an edited
source or a build dir carried to another CPU never loads a stale or
foreign library.  Imports no torch: the host data layer is NumPy only.
"""

from __future__ import annotations

import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["CSRC_DIR", "BUILD_DIR", "CXX_FLAGS", "BUILT", "library_path",
           "build_library"]

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"

CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-fopenmp", "-std=c++17",
             "-shared")

BUILT: dict = {}   # name -> library path, for each library this process built


def _gxx() -> str:
    path = shutil.which("g++")
    if path is None:
        raise RuntimeError("g++ not found: the host library cannot be built")
    return path


@functools.lru_cache(maxsize=None)
def _target_macros() -> bytes:
    """The macros g++ defines under CXX_FLAGS here (the CPU's ISA
    extensions among them)."""
    proc = subprocess.run([_gxx(), *CXX_FLAGS, "-dM", "-E", "-x", "c++",
                           os.devnull], capture_output=True, check=True,
                          timeout=60)
    return proc.stdout


def library_path(name: str) -> Path:
    text = (CSRC_DIR / f"{name}.cpp").read_bytes()
    digest = hashlib.sha1(text + " ".join(CXX_FLAGS).encode()
                          + _target_macros()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build_library(name: str) -> Path:
    """Compile ``csrc/<name>.cpp`` unless its current library exists;
    returns the library's path.  Raises if g++ fails."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [_gxx(), *CXX_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cpp")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        timeout=600)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {name}:\n{proc.stdout}")
    os.replace(tmp, out)   # a concurrent loader never sees half a file
    BUILT[name] = out
    return out
