"""Host allocator tuning for plan/ingest-time NumPy passes.

The ingest and plan-construction paths (formats/market.py, ops/split.py,
the corpus tools) stream tens of 100MB+ NumPy temporaries.  glibc hands
every such allocation to ``mmap`` (anything beyond M_MMAP_THRESHOLD), so
each temporary pays first-touch page faults for its whole footprint.  On
the virtualized single-core host the TPU package was built on, the fault
path ran at ~50-120 MB/s (10-30 s per 450 MB temporary, vs 0.1-0.3 s for
the same write on warm pages).  Raising the mmap/trim thresholds keeps big
buffers on the heap, where freed pages stay faulted-in and are reused
warm (there: a 56.7M-element alloc+fill 15.1 s cold -> 0.07 s on reuse).

This is the host-side analog of the reference's caching device allocator
(util_allocator.cuh:101 — repeat allocations served from a warm pool
instead of round-tripping through the driver).

Call ``enable_warm_heap()`` once at tool startup (the corpus tools in
tools/ do).  It mutates process-wide glibc malloc state, so the library
never calls it implicitly on import.
"""

from __future__ import annotations

import ctypes
import ctypes.util

__all__ = ["enable_warm_heap"]

_M_TRIM_THRESHOLD = -1
_M_MMAP_THRESHOLD = -3

_enabled = False


def enable_warm_heap(threshold_bytes: int = 2**31 - 1) -> bool:
    """Keep large NumPy buffers on the glibc heap so freed pages are
    reused warm.  Returns True if both mallopt calls succeeded (glibc
    only; silently a no-op elsewhere).  Idempotent."""
    global _enabled
    if _enabled:
        return True
    try:
        libc = ctypes.CDLL(ctypes.util.find_library("c"), use_errno=True)
        ok = (libc.mallopt(_M_MMAP_THRESHOLD, threshold_bytes) == 1
              and libc.mallopt(_M_TRIM_THRESHOLD, threshold_bytes) == 1)
    except (OSError, AttributeError):
        return False
    _enabled = bool(ok)
    return _enabled
