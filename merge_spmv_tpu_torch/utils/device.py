"""Device resolution, dtype names and the published-peak table.

Counterpart of merge_spmv_tpu/utils/device.py.  The reference computes its
GPU peak GB/s from bus width x memory clock (utils.h:451-515); here the
published per-card HBM bandwidth is keyed on ``torch.cuda.get_device_name``
and is the denominator of every "% of peak" the port reports.  A card may
be set below its full power limit, so every measurement also records what
``nvidia-smi`` says of the card's name and power limit.
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch

__all__ = ["resolve_device", "torch_dtype", "dtype_name", "itemsize",
           "peak_hbm_bandwidth", "PEAK_HBM_GBPS", "PEAK_FP32_GFLOPS",
           "nvidia_smi_name_power", "nvidia_smi_query", "device_info",
           "measure_stream_bandwidth"]

# Published peak HBM bandwidth, GB/s, matched as lower-case substrings of
# the CUDA device name in this order ("NVIDIA H100 80GB HBM3" is the SXM
# part, "NVIDIA H100 PCIe" the PCIe part).
PEAK_HBM_GBPS = (
    ("h100 pcie", 2000.0),
    ("h100", 3350.0),
)

# Published dense fp32 rate outside the tensor cores (H100 SXM data sheet).
PEAK_FP32_GFLOPS = 67_000.0

_TORCH_DTYPES = {
    "float32": torch.float32,
    "float64": torch.float64,
    "bfloat16": torch.bfloat16,
}

_ITEMSIZE = {"float32": 4, "float64": 8, "bfloat16": 2}


def dtype_name(dtype) -> str:
    """Canonical name ("float32", "float64", "bfloat16") of a torch dtype,
    a numpy dtype or a string."""
    if isinstance(dtype, torch.dtype):
        for name, dt in _TORCH_DTYPES.items():
            if dt == dtype:
                return name
        raise ValueError(f"unsupported dtype {dtype}")
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    if name not in _TORCH_DTYPES:
        raise ValueError(f"unsupported dtype {dtype!r}")
    return name


def torch_dtype(dtype) -> torch.dtype:
    return _TORCH_DTYPES[dtype_name(dtype)]


def itemsize(dtype) -> int:
    return _ITEMSIZE[dtype_name(dtype)]


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  Raises when CUDA is asked for and absent:
    an entry point never drops to the CPU unless the caller says so."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path")
    return dev


def peak_hbm_bandwidth(device=None) -> float:
    """Published HBM GB/s of the card behind ``device`` (default cuda:0)."""
    name = torch.cuda.get_device_name(resolve_device(device)).lower()
    for key, gbps in PEAK_HBM_GBPS:
        if key in name:
            return gbps
    raise ValueError(f"no published HBM bandwidth for {name!r}")


def measure_stream_bandwidth(mbytes: int = 256, iters: int = 64,
                             reps: int = 5, device=None) -> float:
    """Measured STREAM-triad bandwidth (GB/s) of the card behind
    ``device`` (default cuda:0): ``x = x*s + y`` over two ``mbytes``
    float32 arrays, one kernel per step (2 reads + 1 write of 4 bytes per
    element).  An ``iters``-long and a 1-long chain, each captured as a
    CUDA graph and replayed between CUDA events, minimum over ``reps``;
    the difference over ``iters - 1`` is one step.  Counterpart of
    merge_spmv_tpu/utils/device.py:53-86.  Raises without a card: the
    roofline denominator is never taken from the host."""
    from merge_spmv_tpu_torch.utils.timers import _runner, _timed

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("measure_stream_bandwidth needs a CUDA device")
    n = mbytes * 1024 * 1024 // 4
    x = torch.ones(n, dtype=torch.float32, device=dev)
    y = torch.full((n,), 0.5, dtype=torch.float32, device=dev)

    def chain(k):
        def body():
            for _ in range(k):
                torch.add(y, x, alpha=0.99999, out=x)
        return body

    with torch.cuda.device(dev):
        chain(2)()
        torch.cuda.synchronize()
        run_n, run_1 = _runner(chain(iters), True), _runner(chain(1), True)
        big = min(_timed(run_n) for _ in range(reps))
        small = min(_timed(run_1) for _ in range(reps))
    step_s = max(big - small, 1e-9) / (iters - 1) / 1e3
    return 3 * n * 4 / step_s / 1e9


def nvidia_smi_query(fields: str) -> str:
    """``nvidia-smi --query-gpu=<fields> --format=csv,noheader,nounits``
    for the first card, as the tool prints it."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}",
         "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def nvidia_smi_name_power() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` for the first card, as
    the tool prints it (e.g. "NVIDIA H100 80GB HBM3, 700.00 W")."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def device_info(device=None) -> dict:
    """Card name, count, published peak and nvidia-smi's name and power
    limit for ``device`` (default cuda:0)."""
    dev = resolve_device(device)
    return {
        "device_kind": torch.cuda.get_device_name(dev),
        "num_devices": torch.cuda.device_count(),
        "peak_hbm_gbps": peak_hbm_bandwidth(dev),
        "nvidia_smi": nvidia_smi_name_power(),
    }
