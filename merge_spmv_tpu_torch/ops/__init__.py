"""Device compute path.

* merge_path.py — the 2D merge-path diagonal search, host + device
  (reference: cpu_spmv.cpp:223-245, cub/thread/thread_search.cuh:53-84).
* plan.py — plan contract: tile counts, the Hopper tile policy, backend.
* csrmv_torch.py — segment-sum formulation; the "torch" backend and oracle.
* csrmv_cuda.py — the merge-path CUDA kernels (csrc/merge_csrmv.cu): the
  tile kernel with the carry fix-up as its tail (op(x)'s one launch), the
  two apart, and their plain PyTorch versions.
* csrmv.py — public API dispatch (reference: DeviceSpmv::CsrMV,
  cub/device/device_spmv.cuh:129-164).
* operator.py — SpmvOperator: device-resident matrix + plan + tiles.
* split.py — the banded-stack, compact-row and hot/cold split operators
  (one or two merge-kernel launches plus torch epilogues), their host
  helpers and the device-side stack builder.
* suggest.py — the structure router: suggest_backend / build_suggested.
* autotune.py — the tile-size autotuner with its own cache file.
* dia_cuda.py — the DIA matvec CUDA kernel (csrc/dia_matvec.cu) and its
  plain PyTorch version.
* dia.py — DiaSpmvOperator: dense diagonals + leftover merge operator.
"""

from merge_spmv_tpu_torch.ops.merge_path import (merge_path_search,
                                                 merge_tile_coordinates)
from merge_spmv_tpu_torch.ops.plan import SpmvPlan, make_plan
from merge_spmv_tpu_torch.ops.csrmv import csrmv, csrmm
from merge_spmv_tpu_torch.ops.operator import SpmvOperator, build_operator
from merge_spmv_tpu_torch.ops.dia import DiaSpmvOperator, build_dia_operator
from merge_spmv_tpu_torch.ops.split import (HotColdSpmvOperator,
                                            SplitSpmvOperator,
                                            build_hotcold_operator,
                                            build_split_operator,
                                            build_split_operator_device)
from merge_spmv_tpu_torch.ops.suggest import build_suggested, suggest_backend

__all__ = ["merge_path_search", "merge_tile_coordinates",
           "SpmvPlan", "make_plan", "csrmv", "csrmm",
           "SpmvOperator", "build_operator", "DiaSpmvOperator",
           "build_dia_operator", "SplitSpmvOperator", "HotColdSpmvOperator",
           "build_split_operator", "build_split_operator_device",
           "build_hotcold_operator", "suggest_backend", "build_suggested"]
