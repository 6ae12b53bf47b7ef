"""Iterative solvers and spectral models over the port's operators
(models/solvers.py)."""

from merge_spmv_tpu_torch.models.solvers import (SolveInfo, bicgstab,
                                                 conjugate_gradient, fastrp,
                                                 jacobi, pagerank,
                                                 power_iteration)

__all__ = ["conjugate_gradient", "bicgstab", "jacobi", "power_iteration",
           "pagerank", "fastrp", "SolveInfo"]
