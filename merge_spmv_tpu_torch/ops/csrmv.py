"""Public CsrMV / CsrMM API (reference: DeviceSpmv::CsrMV,
cub/device/device_spmv.cuh:129-164).

Two-phase contract (SURVEY.md §3.3): build a `SpmvPlan` once with
`make_plan(...)`, then call `csrmv(plan, ...)` many times.  PyTorch runs
eagerly, so there is no compiled-function cache; `SpmvOperator`
(ops/operator.py) is the form that also keeps the tile search from one
call to the next.

Backends: "cuda" runs the merge-path kernels (ops/csrmv_cuda.py; their
plain versions for CPU tensors), "torch" the segment-sum formulation
(ops/csrmv_torch.py), on CPU tensors only: it raises on CUDA tensors.
The full ``y = alpha*A*x + beta*y_in`` epilogue is supported on both.  bfloat16 computes in float32 and casts back; float64
runs the kernel natively.
"""

from __future__ import annotations

import torch

from merge_spmv_tpu_torch.ops import csrmv_torch as _torch
from merge_spmv_tpu_torch.ops.csrmv_cuda import merge_csrmv
from merge_spmv_tpu_torch.ops.merge_path import merge_tile_coordinates
from merge_spmv_tpu_torch.ops.plan import SpmvPlan, make_plan
from merge_spmv_tpu_torch.utils.device import torch_dtype

__all__ = ["csrmv", "csrmm", "csrmv_fn", "make_plan", "SpmvPlan",
           "compute_dtype", "check_vector_operands", "check_matrix_operands"]


def compute_dtype(plan_dtype) -> torch.dtype:
    """The kernel's arithmetic type: bfloat16 computes in float32."""
    dt = torch_dtype(plan_dtype)
    return torch.float32 if dt == torch.bfloat16 else dt


def check_vector_operands(plan: SpmvPlan, x, y_in=None):
    """x must be [num_cols] and y_in [num_rows]: the kernel gathers
    ``x[col]`` and writes ``y[row]`` unchecked."""
    if tuple(x.shape) != (plan.num_cols,):
        raise ValueError(f"x must have shape ({plan.num_cols},), "
                         f"got {tuple(x.shape)}")
    if y_in is not None and tuple(y_in.shape) != (plan.num_rows,):
        raise ValueError(f"y_in must have shape ({plan.num_rows},), "
                         f"got {tuple(y_in.shape)}")


def check_matrix_operands(plan: SpmvPlan, X, Y_in=None):
    """X must be [num_cols, k] and Y_in [num_rows, k]."""
    if X.dim() != 2 or X.shape[0] != plan.num_cols:
        raise ValueError(f"X must have shape ({plan.num_cols}, k), "
                         f"got {tuple(X.shape)}")
    if Y_in is not None and tuple(Y_in.shape) != (plan.num_rows, X.shape[1]):
        raise ValueError(f"Y_in must have shape ({plan.num_rows}, "
                         f"{X.shape[1]}), got {tuple(Y_in.shape)}")


def _check_plain_route(*tensors):
    """The "torch" backend is the plain version: it never runs on the
    card, where the "cuda" backend's kernels run."""
    if any(t is not None and t.is_cuda for t in tensors):
        raise ValueError("the 'torch' backend runs on CPU tensors only; "
                         "build the plan for the CUDA device to run the "
                         "kernels")


def _csrmv_merge(plan: SpmvPlan, values, row_end_offsets, col_indices, x,
                 y_in, alpha, beta, tiles=None, tickets=None):
    """The merge-path route, with the plan's dtype policy applied;
    ``tickets`` is the fused kernel's counter (ops/csrmv_cuda.py)."""
    check_vector_operands(plan, x, y_in)
    out_dt = torch_dtype(plan.dtype)
    cdt = compute_dtype(plan.dtype)
    if tiles is None:
        tiles = merge_tile_coordinates(row_end_offsets, plan.num_nonzeros,
                                       plan.tile_items)
    y = merge_csrmv(values.to(cdt).contiguous(), col_indices,
                    row_end_offsets, x.to(cdt).contiguous(), *tiles,
                    plan.tile_items,
                    None if y_in is None else y_in.to(cdt).contiguous(),
                    alpha, beta, tickets=tickets, policy=plan.policy)
    return y.to(out_dt)


def csrmv(plan: SpmvPlan, values, row_end_offsets, col_indices, x,
          y_in=None, alpha=1.0, beta=0.0, interpret: bool = False,
          meta=None):
    """y = alpha * A @ x + beta * y_in.

    Parameters mirror DeviceSpmv::CsrMV (device_spmv.cuh:129-164), with
    `row_end_offsets` = row_offsets[1:] (merge list A).  ``interpret`` and
    ``meta`` (the TPU gather plan) are accepted for signature parity with
    merge_spmv_tpu and have no effect.
    """
    if plan.backend == "cuda":
        return _csrmv_merge(plan, values, row_end_offsets, col_indices, x,
                            y_in, alpha, beta)
    _check_plain_route(values, row_end_offsets, col_indices, x, y_in)
    check_vector_operands(plan, x, y_in)
    out_dt = torch_dtype(plan.dtype)
    return _torch.csrmv_torch(values.to(out_dt), row_end_offsets,
                              col_indices, x.to(out_dt), y_in=y_in,
                              alpha=alpha, beta=beta)


def csrmv_fn(plan: SpmvPlan, interpret: bool = False, has_meta: bool = False):
    """Return ``fn(values, row_end_offsets, col_indices, x, alpha, beta,
    y_in=None, meta=None)`` for benchmarking loops."""

    def fn(v, re, ci, x, a=1.0, b=0.0, y_in=None, meta=None):
        return csrmv(plan, v, re, ci, x, y_in=y_in, alpha=a, beta=b)
    return fn


def csrmm(plan: SpmvPlan, values, row_end_offsets, col_indices, X,
          Y_in=None, alpha=1.0, beta=0.0, interpret: bool = False,
          meta=None):
    """Y = alpha * A @ X + beta * Y_in  (SpMM; X is [num_cols, k]).

    The "cuda" backend runs the merge kernels once per column of X, as
    csrmm_column_loop (csrmv_pallas.py:1376-1406) does, with the tile
    search done once for all columns."""
    check_matrix_operands(plan, X, Y_in)
    if plan.backend == "cuda":
        tiles = merge_tile_coordinates(row_end_offsets, plan.num_nonzeros,
                                       plan.tile_items)
        return torch.stack([
            _csrmv_merge(plan, values, row_end_offsets, col_indices, X[:, k],
                         None if Y_in is None else Y_in[:, k], alpha, beta,
                         tiles)
            for k in range(X.shape[1])], dim=1)
    _check_plain_route(values, row_end_offsets, col_indices, X, Y_in)
    out_dt = torch_dtype(plan.dtype)
    return _torch.csrmm_torch(values.to(out_dt), row_end_offsets,
                              col_indices, X.to(out_dt), Y_in=Y_in,
                              alpha=alpha, beta=beta)
