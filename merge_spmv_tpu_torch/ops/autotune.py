"""Tile-size autotuner with a persistent cache.

Counterpart of merge_spmv_tpu/ops/autotune.py, the runtime analog of the
reference's per-SM compile-time policy ladder (dispatch_spmv_orig.cuh:
262-445).  The port's merge kernel has one policy knob, ``tile_items``
(threads per block = tile_items / ITEMS_PER_THREAD, ops/plan.py); the
tuner times each candidate once per matrix shape class on the card and
caches the fastest:

    op = build_operator(csr, autotune=True)      # sweeps on first sight

Shape classes bucket (log2 rows, log2 nnz/row, card name, dtype): matrices
of one class on one kind of card share a policy, as one reference policy
serves every matrix on a given SM.  The cache is the port's own file,
``MERGE_SPMV_TORCH_TUNE_CACHE`` or ``.tune_cache_torch.json`` at the
repository root, never the JAX package's.  Every candidate fits the card
(``tile_shared_bytes(4096)`` is under a block's 227 KB), so a candidate
that fails to build or launch raises.  Off the card the tuner times
nothing and returns the plan's choice.  ``TIMED`` counts the candidates
timed, so a caller can show that a cached class timed none.
"""

from __future__ import annotations

import json
import math
import os
import threading

import torch

from merge_spmv_tpu_torch.ops.plan import make_plan
from merge_spmv_tpu_torch.utils.device import resolve_device

__all__ = ["autotune_plan", "autotune_tile_items", "shape_class",
           "cache_path", "CACHE_ENV", "DEFAULT_CANDIDATES", "TIMED",
           "reset_timed"]

DEFAULT_CANDIDATES = (1024, 2048, 4096)

CACHE_ENV = "MERGE_SPMV_TORCH_TUNE_CACHE"
_DEFAULT_CACHE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), ".tune_cache_torch.json")
_LOCK = threading.Lock()

TIMED = {"candidates": 0}


def reset_timed():
    TIMED["candidates"] = 0


def shape_class(num_rows: int, num_nonzeros: int, device_name: str,
                dtype: str) -> str:
    """Bucket key: matrices in one class share a tile policy."""
    lr = int(math.log2(max(num_rows, 1)))
    deg = max(1, num_nonzeros // max(num_rows, 1))
    ld = int(math.log2(deg))
    return f"r{lr}_d{ld}_{device_name}_{dtype}"


def cache_path() -> str:
    """The cache file: ``$MERGE_SPMV_TORCH_TUNE_CACHE``, read at each call,
    or ``.tune_cache_torch.json`` at the repository root."""
    return os.environ.get(CACHE_ENV) or _DEFAULT_CACHE


def _load_cache() -> dict:
    try:
        with open(cache_path()) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _store(key: str, entry: dict):
    with _LOCK:
        cache = _load_cache()
        cache[key] = entry
        path = cache_path()
        tmp = path + ".tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(cache, f, indent=1)
            os.replace(tmp, path)
        except OSError:
            pass   # a read-only checkout: the next build times again


def _time_operator(csr, dtype, tile_items: int, device) -> float:
    """Device ms per op(x) at ``tile_items`` (CUDA-graph replay of a
    chain of dependent calls, utils/timers.py::chained_rate_ms)."""
    from merge_spmv_tpu_torch.ops.operator import build_operator
    from merge_spmv_tpu_torch.utils.timers import chained_rate_ms

    op = build_operator(csr, dtype=dtype, tile_items=tile_items,
                        device=device)
    x0 = torch.ones(csr.num_cols, dtype=op.values.dtype, device=device)
    TIMED["candidates"] += 1
    return chained_rate_ms(op, x0, n=16, reps=3)


def autotune_plan(csr, dtype="float32", candidates=DEFAULT_CANDIDATES,
                  verbose: bool = False, device=None) -> dict:
    """The fastest ``tile_items`` for this matrix's shape class on the
    card, from the cache or from timing every candidate once.  Returns
    {"tile_items": int}; off the card, the plan's choice, untimed and
    uncached."""
    dev = resolve_device(device)
    probe = make_plan(csr.num_rows, csr.num_cols, csr.num_nonzeros,
                      dtype=dtype, device=dev)
    if dev.type != "cuda":
        return {"tile_items": probe.tile_items}
    key = shape_class(csr.num_rows, csr.num_nonzeros,
                      torch.cuda.get_device_name(dev), probe.dtype)
    cached = _load_cache().get(key)
    if cached:
        return {"tile_items": int(cached["tile_items"])}
    results = {}
    for cand in candidates:
        results[cand] = _time_operator(csr, dtype, cand, dev)
        if verbose:
            print(f"  autotune {key}: T={cand}: {results[cand]:.5f} ms",
                  flush=True)
    best = min(results, key=results.get)
    _store(key, {"tile_items": int(best),
                 "ms": {f"T{c}": round(v, 5) for c, v in results.items()}})
    return {"tile_items": int(best)}


def autotune_tile_items(csr, dtype="float32",
                        candidates=DEFAULT_CANDIDATES,
                        verbose: bool = False, device=None) -> int:
    """tile_items from ``autotune_plan``."""
    return autotune_plan(csr, dtype=dtype, candidates=candidates,
                         verbose=verbose, device=device)["tile_items"]
