"""merge_spmv_tpu_torch — the merge-path sparse linear-algebra framework on
PyTorch and CUDA for one NVIDIA H100.

The port of merge_spmv_tpu (JAX / Pallas on a TPU), module for module:

* formats/ — COO/CSR containers, Matrix Market ingest (NumPy, and the
  C++ parser, COO->CSR sort and writer of csrc/market_io.cpp through
  native_io, built by g++ at first use), generators, graph statistics and
  the sequential gold SpMV (on the host),
* ops/ — the merge-path search, the plan, the segment-sum oracle
  (csrmv_torch), the CUDA merge kernels and their plain versions
  (csrmv_cuda, csrc/merge_csrmv.cu), the public csrmv/csrmm API and the
  SpmvOperator, the transition operator D^-1 A of a graph and
  PageRank's column-stochastic A^T D^-1 (operator); the DIA split
  operator (dia) with its CUDA kernel (dia_cuda, csrc/dia_matvec.cu);
  the banded and hot/cold split operators (split), the structure router
  (suggest) and the tile autotuner (autotune),
* models/ — the solvers (CG, BiCGSTAB, Jacobi, power iteration, PageRank,
  FastRP) and HPCG's multigrid preconditioner (multigrid:
  ``build_multigrid``), with their kernels on the card,
* bench/ and cli.py — the verify-then-time benchmark driver and its CLI,
  and the large-matrix generators (bench/matrices.py),
* tools/ — the op-class throughput probe (sm_ceiling, csrc/sm_ceiling.cu)
  and the corpus sweep (make_corpus, make_corpus_stats, eval_corpus,
  corpus_stats: the paper's Fig. 9 statistics),
* utils/ — the ULP comparator, host RNG helpers, device table, kernel and
  host-library builds, the warm heap (hostmem) and timers on the card.

Entry points run on the card unless the caller passes ``device="cpu"``.
Nothing here imports jax or merge_spmv_tpu, and importing the package
compiles nothing: the kernels are built by nvcc at first launch, the host
library by g++ at first use.
"""

from merge_spmv_tpu_torch.formats.coo import CooMatrix
from merge_spmv_tpu_torch.formats.csr import CsrMatrix
from merge_spmv_tpu_torch.formats.stats import GraphStats
from merge_spmv_tpu_torch.ops.plan import SpmvPlan, make_plan
from merge_spmv_tpu_torch.ops.csrmv import csrmv, csrmm
from merge_spmv_tpu_torch.ops.operator import (SpmvOperator, build_operator,
                                               pagerank_operator,
                                               transition_operator)
from merge_spmv_tpu_torch.ops.dia import DiaSpmvOperator, build_dia_operator
from merge_spmv_tpu_torch.ops.split import (build_hotcold_operator,
                                            build_split_operator,
                                            build_split_operator_device)
from merge_spmv_tpu_torch.ops.suggest import build_suggested, suggest_backend
from merge_spmv_tpu_torch.ops.merge_path import (merge_path_search,
                                                 merge_tile_coordinates)
from merge_spmv_tpu_torch.models.multigrid import build_multigrid

__version__ = "0.1.0"

__all__ = [
    "CooMatrix",
    "CsrMatrix",
    "GraphStats",
    "SpmvPlan",
    "SpmvOperator",
    "build_operator",
    "transition_operator",
    "pagerank_operator",
    "DiaSpmvOperator",
    "build_dia_operator",
    "build_hotcold_operator",
    "build_split_operator",
    "build_split_operator_device",
    "build_suggested",
    "suggest_backend",
    "make_plan",
    "csrmv",
    "csrmm",
    "merge_path_search",
    "merge_tile_coordinates",
    "build_multigrid",
]
