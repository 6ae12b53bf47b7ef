"""The card's rate of scattered 4-byte reads, and the gather bound of a
sparse matrix-vector product that it gives.

The merge tile kernel (csrc/merge_csrmv.cu) gathers ``x[col]`` for every
nonzero.  On columns that scatter, each read moves a 32-byte L2 sector
while the byte model (``SpmvPlan.bytes_accessed``) charges 4 bytes, so the
bytes bound cannot be met.  The probe kernel (csrc/gather_rate.cu) computes

    out[t] = sum over k of x[idx[t + k * T]]      (T threads, k order)

over a coalesced index stream; ``gather_sum_plain`` is the same function in
PyTorch.  ``measure`` times it with random indices over an x of each given
size and with coalesced ones, and turns the random case into an L2 sector
rate: ``count * 32 B / (time - the index and output streams at the HBM
peak)``.  ``gather_bound_ms`` then charges a matrix its distinct sectors
per warp request (``warp_sectors``) at that rate, plus its streams at the
HBM peak.

The rows class is the multi-RHS tile kernel's gather (csrc/merge_csrmm.cu):
every read a whole X row of 4 * lanes floats (32 B at k = 8, 128 B at
k = 32), ``gather_rows`` / ``gather_rows_plain``.  ``measure_rows`` times it
at a matrix's own column indices (spread over the grid, so that neighbouring
nonzeros go to different SMs: L2's rate for whole requests) and at random
ones over the same X; ``rows_gather_bound_ms`` charges an SpMM its nnz row
requests at that rate plus A, X and Y once at the HBM peak.

    python -m merge_spmv_tpu_torch.tools.gather_rate

prints one JSON line with the rates.  It writes no file.
"""

from __future__ import annotations

import ctypes
import json
import sys

import torch

from merge_spmv_tpu_torch.ops.plan import (SECTOR_BYTES, WARP,
                                           gather_sectors_per_nonzero)
from merge_spmv_tpu_torch.utils.cuda_build import (check_operand,
                                                   device_context,
                                                   load_library, on_cpu,
                                                   raise_on_launch,
                                                   raw_stream)
from merge_spmv_tpu_torch.utils.device import device_info, peak_hbm_bandwidth

__all__ = ["gather_sum", "gather_sum_plain", "warp_sectors", "measure",
           "gather_bound_ms", "gather_rows", "gather_rows_plain",
           "measure_rows", "rows_gather_bound_ms", "LAUNCHES",
           "reset_launches", "KERNEL_SOURCE", "SIZES", "ROW_FLOATS"]

KERNEL_SOURCE = "gather_rate"
LAUNCHES = {"gather_rate": 0, "gather_rows": 0}
# row widths of the rows class: 4 * lanes floats
ROW_FLOATS = (4, 8, 16, 32, 64)
THREADS = 256
BLOCKS_PER_SM = 8            # 2048 threads: a full SM
H100_SMS = 132
# x lengths probed: the circuit5M class's x (22 MB) and the kron class's
# (4 MB), both in L2; 32 KB and 128 KB, which fit one SM's L1
SIZES = (5_558_326, 1_048_576, 32_768, 8_192)
COUNT = 1 << 26              # reads per launch


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib():
    lib = load_library(KERNEL_SOURCE)
    if not getattr(lib, "_typed", False):
        p = ctypes.c_void_p
        lib.gather_rate_f32.argtypes = [p, p, ctypes.c_longlong,
                                        ctypes.c_int, p, p]
        lib.gather_rate_f32.restype = ctypes.c_int
        lib.gather_rows_f32.argtypes = [p, p, ctypes.c_longlong,
                                        ctypes.c_int, ctypes.c_int, p, p]
        lib.gather_rows_f32.restype = ctypes.c_int
        lib._typed = True
    return lib


def _blocks(device) -> int:
    if device.type != "cuda":
        return H100_SMS * BLOCKS_PER_SM
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return sms * BLOCKS_PER_SM


def gather_sum_plain(x, idx, threads):
    """``out[t] = sum_k x[idx[t + k * threads]]`` summed in k order."""
    count = idx.shape[0]
    out = torch.zeros(threads, dtype=torch.float32, device=x.device)
    for k in range(0, count, threads):
        seg = idx[k:k + threads].long()
        out[:seg.shape[0]] += x[seg]
    return out


def gather_sum(x, idx, blocks=None):
    """The probe's function: the kernel for CUDA tensors (``blocks`` of
    256 threads, default a full card), the plain version for CPU tensors.
    ``x`` float32, ``idx`` int32 in ``[0, len(x))``, both contiguous."""
    dev = x.device
    blocks = _blocks(dev) if blocks is None else int(blocks)
    if on_cpu(x, idx):
        return gather_sum_plain(x, idx, blocks * THREADS)
    check_operand("x", x, torch.float32)
    check_operand("idx", idx, torch.int32)
    if x.dim() != 1 or idx.dim() != 1:
        raise ValueError("x and idx must be vectors")
    out = torch.empty(blocks * THREADS, dtype=torch.float32, device=dev)
    with device_context(dev):
        rc = _lib().gather_rate_f32(x.data_ptr(), idx.data_ptr(),
                                    idx.shape[0], blocks, out.data_ptr(),
                                    raw_stream(dev))
    raise_on_launch(KERNEL_SOURCE, rc, "gather_rate")
    LAUNCHES["gather_rate"] += 1
    return out


def gather_rows_plain(X, idx, threads):
    """``out[g, :] = sum_j X[idx[g + j * G], :]`` in j order, G = threads
    / lanes groups of lanes = X.shape[1] / 4 threads, flattened: thread t's
    four floats at [4 t, 4 t + 4)."""
    G = threads * 4 // X.shape[1]
    out = torch.zeros(G, X.shape[1], dtype=torch.float32, device=X.device)
    for j in range(0, idx.shape[0], G):
        seg = idx[j:j + G].long()
        out[:seg.shape[0]] += X[seg]
    return out.reshape(-1)


def gather_rows(X, idx, blocks=None):
    """The rows class: the kernel for CUDA tensors (``blocks`` of 256
    threads, default a full card), the plain version for CPU tensors.
    ``X`` float32 [n, row_floats] contiguous with row_floats in
    ROW_FLOATS, ``idx`` int32 in ``[0, n)``."""
    dev = X.device
    blocks = _blocks(dev) if blocks is None else int(blocks)
    if X.dim() != 2 or X.shape[1] not in ROW_FLOATS:
        raise ValueError(f"X must be [n, w] with w in {ROW_FLOATS}")
    if on_cpu(X, idx):
        return gather_rows_plain(X, idx, blocks * THREADS)
    check_operand("X", X, torch.float32)
    check_operand("idx", idx, torch.int32)
    if idx.dim() != 1:
        raise ValueError("idx must be a vector")
    out = torch.empty(blocks * THREADS * 4, dtype=torch.float32, device=dev)
    with device_context(dev):
        rc = _lib().gather_rows_f32(X.data_ptr(), idx.data_ptr(),
                                    idx.shape[0], X.shape[1], blocks,
                                    out.data_ptr(), raw_stream(dev))
    raise_on_launch(KERNEL_SOURCE, rc, "gather_rows")
    LAUNCHES["gather_rows"] += 1
    return out


def rows_gather_bound_ms(nnz: int, row_bytes: int, rate_gbps: float,
                         stream_bytes: int, peak_gbps: float) -> float:
    """The least time of an SpMM whose nnz X-row requests of
    ``row_bytes`` come from L2 at ``rate_gbps``, plus ``stream_bytes`` (A,
    X and Y once) at the HBM peak."""
    return (nnz * row_bytes / rate_gbps + stream_bytes / peak_gbps) / 1e6


def measure_rows(col_indices, num_cols: int, row_floats=(8, 32), seed=0,
                 device=None) -> dict:
    """Per row width: ms per launch reading one X row per index, at the
    matrix's ``col_indices`` in their order and at as many random indices
    over the same ``num_cols`` rows, and each case's rate in GB/s of rows
    (its index and output streams taken off at the HBM peak).  Needs the
    card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        raise RuntimeError("the gather rate is measured on the card")
    peak = peak_hbm_bandwidth(dev)
    blocks = _blocks(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    cols = torch.as_tensor(col_indices).to(dev, torch.int32)
    count = cols.shape[0]
    rand = torch.randint(0, num_cols, (count,), generator=gen, device=dev,
                         dtype=torch.int32)
    stream_bytes = count * 4 + blocks * THREADS * 16
    result = {}
    for w in row_floats:
        X = torch.rand(num_cols, w, generator=gen, device=dev)
        rec = {"row_bytes": 4 * w, "count": count}
        for name, idx in (("matrix", cols), ("random", rand)):
            ms = _event_ms(lambda: gather_rows(X, idx, blocks))
            s = ms * 1e-3 - stream_bytes / (peak * 1e9)
            rec[f"{name}_ms"] = ms
            rec[f"{name}_rate_gbps"] = count * 4 * w / s / 1e9
        result[str(w)] = rec
        del X
    return result


def warp_sectors(col_indices, dtype="float32") -> int:
    """Distinct 32-byte sectors of x among each 32 consecutive nonzeros
    (one warp request of the tile kernel's gather), summed over every
    request: the sectors the gather moves when no request finds another's
    in L1."""
    groups = col_indices.shape[0] // WARP
    return round(gather_sectors_per_nonzero(col_indices, dtype, samples=None)
                 * groups * WARP)


def gather_bound_ms(sectors: int, stream_bytes: int, rate_gbps: float,
                    peak_gbps: float) -> float:
    """The least time of a gather of ``sectors`` sectors at the measured
    L2 sector rate, plus ``stream_bytes`` at the HBM peak."""
    return (sectors * SECTOR_BYTES / rate_gbps
            + stream_bytes / peak_gbps) / 1e6


def _event_ms(fn, iters=10, reps=3):
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


def measure(sizes=SIZES, count=COUNT, seed=0, device=None) -> dict:
    """Per x length: ms per launch with random and with coalesced indices
    (``count`` reads), the random case's sector rate in GB/s of sectors
    (its index and output streams taken off at the HBM peak) and reads
    per ns.  Needs the card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        raise RuntimeError("the gather rate is measured on the card")
    peak = peak_hbm_bandwidth(dev)
    blocks = _blocks(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    stream_bytes = count * 4 + blocks * THREADS * 4
    result = {}
    for n in sizes:
        x = torch.rand(n, generator=gen, device=dev)
        rand_idx = torch.randint(0, n, (count,), generator=gen, device=dev,
                                 dtype=torch.int32)
        coal_idx = (torch.arange(count, device=dev) % n).to(torch.int32)
        rand_ms = _event_ms(lambda: gather_sum(x, rand_idx, blocks))
        coal_ms = _event_ms(lambda: gather_sum(x, coal_idx, blocks))
        gather_s = rand_ms * 1e-3 - stream_bytes / (peak * 1e9)
        result[str(n)] = {
            "x_bytes": n * 4, "count": count, "random_ms": rand_ms,
            "coalesced_ms": coal_ms,
            "reads_per_ns": count / (rand_ms * 1e6),
            "sector_rate_gbps": count * SECTOR_BYTES / gather_s / 1e9,
        }
        del x, rand_idx, coal_idx
    return result


def main(argv=None):
    info = device_info()
    print(json.dumps({"device": info["device_kind"],
                      "nvidia_smi": info["nvidia_smi"],
                      "sizes": measure()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
