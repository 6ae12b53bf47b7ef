"""Measured per-op-class throughput ceilings of the card (probe P1).

Counterpart of tools/vpu_ceiling.py, the TPU probe whose Pallas kernel runs
one class of vector operation at a time with enough independent chains
that the rate, not the latency, is measured.  The CUDA kernel
(csrc/sm_ceiling.cu) computes the same function on every SM:

    table = tile(x[0:8], (table_rows // 8, 1)) * 1e-9
    accs  = chains x zeros(8, 128)
    for t in range(grid): accs = body(t, table, accs)   # unroll ops/chain
    out   = sum(accs)

with the five bodies ``fma``, ``select``, ``gather``, ``dynfetch`` and
``statfetch`` (vpu_ceiling.py:88-159).  ``probe_plain`` is the same
function in PyTorch; ``probe`` runs the kernel for a CUDA tensor and the
plain version for a CPU tensor.  The TPU probe's (4096, 128) table is
2 MiB, more than a block's shared memory, so the card's default table has
``TABLE_ROWS = 256`` rows (128 KB); the other sizes are the TPU probe's.

    python -m merge_spmv_tpu_torch.tools.sm_ceiling [fma,select,...]

prints one JSON line: per class the ms per launch, operations per second
for the whole card and per SM per clock at the SM clock nvidia-smi reports
during the run, beside the bound.  It writes no file.
"""

from __future__ import annotations

import collections
import ctypes
import json
import re
import shutil
import subprocess
import sys

import torch

from merge_spmv_tpu_torch.utils.cuda_build import (_library_path,
                                                   build_library,
                                                   check_operand,
                                                   load_library, on_cpu,
                                                   raise_on_launch)
from merge_spmv_tpu_torch.utils.device import (PEAK_FP32_GFLOPS, device_info,
                                               nvidia_smi_query)

__all__ = ["CLASSES", "OPS_PER_ELEMENT", "GRID", "UNROLL", "CHAINS",
           "TABLE_ROWS", "LAUNCHES", "reset_launches", "probe", "probe_plain",
           "probe_launch", "probe_blocks", "operations", "measure",
           "issue_bounds_ms", "SASS_PER_STEP", "sass_loop_counts",
           "KERNEL_SOURCE"]

KERNEL_SOURCE = "sm_ceiling"
CLASSES = ("fma", "select", "gather", "dynfetch", "statfetch")
# operations per element per chain step, as vpu_ceiling.py counts them
# (gather: the gather and the add that keeps the chain live)
OPS_PER_ELEMENT = {"fma": 1, "select": 1, "gather": 2, "dynfetch": 1,
                   "statfetch": 1}
# Warp-shuffle lanes per SM per clock on compute capability 9.0 (the CUDA
# C++ Programming Guide's table of arithmetic instruction throughput, row
# "warp shuffle"); the gather kernel shuffles each element once.
SHUFFLE_LANES_PER_CLOCK = 32
# Instruction-issue bounds.  An SM issues one warp instruction per clock
# from each of its 4 schedulers (128 lane-instructions per clock); the
# integer pipe that runs ISETP, FSEL and LOP3 takes 64 lanes per clock (the
# CUDA C++ Programming Guide's throughput of 32-bit integer compare and
# logic on compute capability 9.0).  SASS_PER_STEP counts, for a class, the
# instructions of one pass of its unrolled timed loop in
# sm_ceiling_kernel<CLS, 8> (cuobjdump -sass of the sm_90a build, CUDA
# 12.8), the integer-pipe ones among them, and the elements the pass
# updates per thread.  select: 187 instructions (125 ISETP, 32 FSEL,
# 4 LOP3, 12 UIADD3, 11 ULOP3, 1 S2R, 1 VIADD, 1 BRA) for 4 steps x 8
# chains x 4 slots = 128 elements; the compiler folds the 4 steps'
# compares into ISETP.EQ.OR chains and issues one FSEL per chain and slot.
ISSUE_LANES_PER_CLOCK = 128
INT_PIPE_LANES_PER_CLOCK = 64
SASS_PER_STEP = {"select": {"instructions": 187, "int_pipe": 161,
                            "elements": 128}}
INT_PIPE_OPS = ("ISETP", "FSEL", "LOP3")
_SASS_INSN = re.compile(
    r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")
GRID = 4096
UNROLL = 64
CHAINS = 8
TABLE_ROWS = 256
SUPPORTED_CHAINS = (1, 2, 4, 8)
MAX_TABLE_ROWS = 448          # 448 * 512 B fits a block's 227 KB
MIN_TABLE_ROWS = 24           # the row index steps by 11 modulo rows - 8
LAUNCHES_TIMED = 3

LAUNCHES = {c: 0 for c in CLASSES}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib():
    lib = load_library(KERNEL_SOURCE)
    if not getattr(lib, "_typed", False):
        i, p = ctypes.c_int, ctypes.c_void_p
        lib.sm_ceiling_blocks_per_sm.argtypes = [i, i, i]
        lib.sm_ceiling_blocks_per_sm.restype = i
        lib.sm_ceiling_launch.argtypes = [i, i, p, i, i, i, i, p, p]
        lib.sm_ceiling_launch.restype = i
        lib._typed = True
    return lib


def _check_sizes(cls, grid, unroll, chains, table_rows):
    if cls not in CLASSES:
        raise ValueError(f"unknown probe class {cls!r}; one of {CLASSES}")
    if grid < 1 or unroll < 1:
        raise ValueError("grid and unroll must be positive")
    if chains not in SUPPORTED_CHAINS:
        raise ValueError(f"chains must be one of {SUPPORTED_CHAINS}")
    if (table_rows % 8 or not
            MIN_TABLE_ROWS <= table_rows <= MAX_TABLE_ROWS):
        raise ValueError(f"table_rows must be a multiple of 8 in "
                         f"[{MIN_TABLE_ROWS}, {MAX_TABLE_ROWS}]")


def probe_plain(cls, x, grid=GRID, unroll=UNROLL, chains=CHAINS,
                table_rows=TABLE_ROWS):
    """The probe's function in PyTorch, the chains advanced together:
    ``(8, 128)`` float32 from ``x`` (8, 128) float32."""
    _check_sizes(cls, grid, unroll, chains, table_rows)
    dev = x.device
    table = x[0:8].float().repeat(table_rows // 8, 1) * 1e-9
    accs = torch.zeros(chains, 8, 128, dtype=torch.float32, device=dev)
    col = torch.arange(128, device=dev)
    c = torch.arange(chains, device=dev)
    u = torch.arange(unroll, device=dev)[:, None]
    if cls == "select":
        want = (u + c) & 127                         # + t, per step
    elif cls == "statfetch":
        rows = (u * 11 + c * 7) % (table_rows - 8)   # (unroll, chains)
    for t in range(grid):
        if cls == "fma":
            b = table[0:8] + 1.0
            for _ in range(unroll):
                accs = accs * 0.999999 + b
        elif cls == "select":
            b = table[0:8]
            hit = (col == ((want + t) & 127)[..., None, None])
            for k in range(unroll):
                accs = torch.where(hit[k], b, accs)
        elif cls == "gather":
            idx = (col * 7 + t) & 127
            for _ in range(unroll):
                accs = (accs + 1.0)[:, :, idx]
        else:
            if cls == "dynfetch":
                rows = (t * 37 + u * 11 + c) % (table_rows - 8)
            for k in range(unroll):
                accs = accs + table[rows[k]][:, None, :]
    out = accs[0]
    for k in range(1, chains):
        out = out + accs[k]
    return out


def probe_blocks(cls, chains=CHAINS, table_rows=TABLE_ROWS, device=None):
    """Blocks that fill every SM of the card: the occupancy per SM times
    the SM count."""
    _check_sizes(cls, 1, 1, chains, table_rows)
    dev = torch.device("cuda" if device is None else device)
    with torch.cuda.device(dev):
        per_sm = _lib().sm_ceiling_blocks_per_sm(CLASSES.index(cls), chains,
                                                 table_rows)
    if per_sm < 1:
        raise RuntimeError(f"no block of the {cls} probe fits an SM "
                           f"(occupancy query returned {per_sm})")
    return per_sm * torch.cuda.get_device_properties(dev).multi_processor_count


def probe_launch(cls, x, grid=GRID, unroll=UNROLL, chains=CHAINS,
                 table_rows=TABLE_ROWS, blocks=None):
    """One launch of the kernel on a CUDA ``x``: every block's (8, 128)
    result, (blocks, 8, 128).  Does not synchronise."""
    _check_sizes(cls, grid, unroll, chains, table_rows)
    check_operand("x", x, torch.float32, (8, 128))
    if blocks is None:
        blocks = probe_blocks(cls, chains, table_rows, x.device)
    out = torch.empty(blocks, 8, 128, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _lib().sm_ceiling_launch(CLASSES.index(cls), chains,
                                      x.data_ptr(), grid, unroll, table_rows,
                                      blocks, out.data_ptr(), stream)
    raise_on_launch(KERNEL_SOURCE, rc, f"sm_ceiling {cls}")
    LAUNCHES[cls] += 1
    return out


def probe(cls, x, grid=GRID, unroll=UNROLL, chains=CHAINS,
          table_rows=TABLE_ROWS, blocks=None):
    """The probe's (8, 128) result: the kernel for a CUDA tensor, checked
    that every block gave the same bits; the plain version for a CPU
    tensor."""
    if on_cpu(x):
        return probe_plain(cls, x, grid, unroll, chains, table_rows)
    out = probe_launch(cls, x, grid, unroll, chains, table_rows, blocks)
    if not bool((out == out[:1]).all()):
        raise RuntimeError(f"the blocks of the {cls} probe disagree")
    return out[0]


def operations(cls, grid=GRID, unroll=UNROLL, chains=CHAINS, blocks=1):
    """Element operations one launch performs (the TPU probe's regop count
    times the 1024 elements of a regop, times the blocks)."""
    return (blocks * grid * unroll * chains * OPS_PER_ELEMENT[cls] * 1024)


def sass_loop_counts(cls, chains=CHAINS) -> dict:
    """Instructions of the timed loop of ``sm_ceiling_kernel<cls, chains>``
    as compiled: ``cuobjdump -sass`` of the built library, the innermost
    backward-branch loop with the most instructions, its instruction count,
    its INT_PIPE_OPS count and its opcode histogram.  Needs the CUDA
    toolkit (the card's machine)."""
    build_library(KERNEL_SOURCE)
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(_library_path(KERNEL_SOURCE))],
                          check=True, capture_output=True, text=True,
                          timeout=300).stdout
    tag = f"sm_ceiling_kernelILi{CLASSES.index(cls)}ELi{chains}EE"
    body = text.split("Function : ")
    body = next(b for b in body[1:] if b.split(None, 1)[0].endswith(
        tag + "EvPKfiiiPf"))
    insns = [(int(a, 16), op.split(".")[0], rest)
             for a, op, rest in _SASS_INSN.findall(body)]
    loops = []
    for addr, op, rest in insns:
        target = re.search(r"0x([0-9a-f]+)", rest)
        if op == "BRA" and target and int(target.group(1), 16) < addr:
            loops.append((int(target.group(1), 16), addr))
    inner = [lp for lp in loops if not any(
        o != lp and lp[0] <= o[0] and o[1] <= lp[1] for o in loops)]
    start, end = max(inner, key=lambda lp: lp[1] - lp[0])
    ops = [op for addr, op, _ in insns if start <= addr <= end]
    return {"instructions": len(ops),
            "int_pipe": sum(op in INT_PIPE_OPS for op in ops),
            "opcodes": dict(collections.Counter(ops).most_common())}


def issue_bounds_ms(cls, ops, sms, clock_mhz) -> dict:
    """The class's instruction-issue bounds for ``ops`` element operations
    on ``sms`` SMs at ``clock_mhz``: ``issue_bound_ms`` (every instruction
    of the timed loop at ISSUE_LANES_PER_CLOCK) and ``int_pipe_bound_ms``
    (its integer-pipe instructions at INT_PIPE_LANES_PER_CLOCK); empty for
    a class whose SASS is not counted."""
    sass = SASS_PER_STEP.get(cls)
    if sass is None:
        return {}
    sm_clocks_per_ms = sms * clock_mhz * 1e3
    per_elem = ops / sass["elements"]
    return {"issue_bound_ms": per_elem * sass["instructions"]
            / (ISSUE_LANES_PER_CLOCK * sm_clocks_per_ms),
            "int_pipe_bound_ms": per_elem * sass["int_pipe"]
            / (INT_PIPE_LANES_PER_CLOCK * sm_clocks_per_ms)}


def measure(classes=CLASSES, x=None) -> dict:
    """Rates on the card at the full size (GRID, UNROLL, CHAINS,
    TABLE_ROWS), for ``x`` (default ones) on the card.  Per class: ms per
    launch (CUDA events around LAUNCHES_TIMED launches), operations per
    second for the whole card, and per SM per clock at the SM clock that
    nvidia-smi reads while the launches run.  ``bound_ms`` counts one
    operation per FFMA lane per clock; beside it ``smem_bound_ms`` (the
    fetch classes) and ``shuffle_bound_ms`` (gather) count the unit those
    classes meet, at the same clock; ``issue_bound_ms`` and
    ``int_pipe_bound_ms`` (select) count its instructions as compiled."""
    if x is None:
        x = torch.ones(8, 128, dtype=torch.float32, device="cuda")
    dev = x.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    result = {}
    for cls in classes:
        blocks = probe_blocks(cls, device=dev)
        probe(cls, x, 1, 1, blocks=blocks)     # load, warm
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(LAUNCHES_TIMED):
            probe_launch(cls, x, blocks=blocks)
        end.record()
        clock_mhz = float(nvidia_smi_query("clocks.sm"))   # while it runs
        end.synchronize()
        ms = start.elapsed_time(end) / LAUNCHES_TIMED
        ops = operations(cls, blocks=blocks)
        rate = ops / (ms * 1e-3)
        # the data sheet's fp32 rate counts an FMA as two operations;
        # one lane-operation per clock is half of it
        lane_rate = PEAK_FP32_GFLOPS * 1e9 / 2
        bound_ms = ops / lane_rate * 1e3
        result[cls] = {
            "ms_per_launch": ms, "blocks": blocks,
            "ops_per_launch": ops, "ops_per_s": rate,
            "sm_clock_mhz": clock_mhz,
            "ops_per_sm_per_clock": rate / (sms * clock_mhz * 1e6),
            "bound_ms": bound_ms, "bound_by": "operations",
        }
        if cls in ("dynfetch", "statfetch"):
            # 32 banks x 4 B per clock per SM; each operation reads 4 B
            result[cls]["smem_bound_ms"] = (
                ops * 4 / (sms * 128 * clock_mhz * 1e6) * 1e3)
        result[cls].update(issue_bounds_ms(cls, ops, sms, clock_mhz))
        if cls == "gather":
            lanes = ops // OPS_PER_ELEMENT["gather"]   # lane-shuffles
            result[cls]["shuffle_bound_ms"] = (
                lanes / (sms * SHUFFLE_LANES_PER_CLOCK * clock_mhz * 1e6)
                * 1e3)
    return result


def main(argv=None):
    argv = sys.argv if argv is None else argv
    classes = argv[1].split(",") if len(argv) > 1 else CLASSES
    info = device_info()
    out = {"grid": GRID, "unroll": UNROLL, "chains": CHAINS,
           "table_rows": TABLE_ROWS, "device": info["device_kind"],
           "nvidia_smi": info["nvidia_smi"],
           "classes": measure(classes)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
