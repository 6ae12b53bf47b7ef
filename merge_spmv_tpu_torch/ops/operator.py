"""SpmvOperator — the user-facing handle bundling a device-resident CSR
matrix with its execution plan and tile coordinates.

Counterpart of merge_spmv_tpu/ops/operator.py.  The reference's lifecycle
is query/allocate/run (SURVEY.md §3.3): build once (plan, copy to the
device, tile search), then every ``op(x)`` launches the fused merge
kernel directly, once per call (ops/csrmv_cuda.py).

    op = build_operator(csr, dtype="float32")      # on the card
    y = op(x)                                      # y = A @ x
    y = op(x, y_in=y0, alpha=2.0, beta=1.0)
    Y = op.mm(X)                                   # SpMM, one K1m launch
    P = transition_operator(adjacency_csr)         # D^-1 A, rows by degree
    P = pagerank_operator(link_csr)                # A^T D^-1, columns

The operator always runs the merge-path decomposition: the CUDA kernels for
a matrix on the card, their plain PyTorch versions for a matrix on the CPU
(``device="cpu"``, the tests' route).
"""

from __future__ import annotations

from typing import Optional

import torch

from merge_spmv_tpu_torch.ops.csrmv import (_csrmm_merge, _csrmv_merge,
                                            check_matrix_operands,
                                            check_vector_operands,
                                            compute_dtype)
from merge_spmv_tpu_torch.ops.csrmv_cuda import (bind_merge_csrmv,
                                                 ticket_counter)
from merge_spmv_tpu_torch.ops.csrmv_torch import row_ids_from_offsets
from merge_spmv_tpu_torch.ops.merge_path import merge_tile_coordinates
from merge_spmv_tpu_torch.ops.plan import SpmvPlan, make_plan
from merge_spmv_tpu_torch.utils.device import resolve_device, torch_dtype
from merge_spmv_tpu_torch.utils.tracing import (BUILD_PLAN, BUILD_PREPARE,
                                                BUILD_STOCHASTIC,
                                                BUILD_TRANSITION, OP_CALL,
                                                OP_MM, span)

__all__ = ["SpmvOperator", "build_operator", "transition_operator",
           "pagerank_operator", "assemble_operator", "row_abs_sums",
           "row_stochastic", "column_stochastic"]


def row_abs_sums(values, row_end_offsets, num_rows: int):
    """Per-row sum of |values| in float64, on the values' device."""
    rows = row_ids_from_offsets(row_end_offsets, values.shape[0])
    sums = torch.zeros(num_rows, dtype=torch.float64, device=values.device)
    return sums.index_add_(0, rows, values.abs().double())


def row_stochastic(values, row_end_offsets, num_rows: int):
    """The values of D^-1 A in float64: each divided by its row's sum of
    values, summed in float64.  An empty row stays empty; a row whose
    values sum to 0 has no D^-1 and raises."""
    rows = row_ids_from_offsets(row_end_offsets, values.shape[0])
    values = values.double()
    sums = torch.zeros(num_rows, dtype=torch.float64, device=values.device)
    sums.index_add_(0, rows, values)
    per_nonzero = sums[rows]
    if bool((per_nonzero == 0).any()):
        raise ValueError("a row with stored values sums to 0: D^-1 A is "
                         "undefined there")
    return values / per_nonzero


def column_stochastic(values, row_end_offsets, col_indices, num_rows: int,
                      num_cols: int):
    """The CSR of P = A^T D^-1 on the arrays' device: (values in float64,
    row end offsets, column indices) of the transpose of D^-1 A
    (``row_stochastic``), so that column u of P is row u of A over its
    sum.  A stable sort of the nonzeros by column keeps each row of P in
    A's row order; an empty row of A leaves its column of P empty."""
    scaled = row_stochastic(values, row_end_offsets, num_rows)
    order = torch.sort(col_indices, stable=True).indices
    scaled = scaled[order]
    rows = row_ids_from_offsets(row_end_offsets, values.shape[0])[order]
    del order
    counts = torch.bincount(col_indices.long(), minlength=num_cols)
    ends = torch.cumsum(counts, 0).to(torch.int32)
    return scaled, ends, rows.to(torch.int32)


class SpmvOperator:
    """Device-resident CSR SpMV/SpMM operator (two-phase contract, phase 2).

    ``values`` are held in the compute dtype (float32 for a bfloat16 plan,
    after rounding to bfloat16, as the JAX operator upcasts its bf16
    values); ``tile_rows``/``tile_nnz`` are the merge-tile coordinates,
    searched once.  ``abs_row_sum_max`` is ``max_r sum_j |A[r, j]|`` over
    the stored values, computed once at build: the timers scale a chain of
    calls by its inverse.  ``tickets`` is the fused kernel's counter, the
    operator's own (None on the CPU): its calls must be stream-ordered,
    while separate operators may run on separate streams at once.
    """

    def __init__(self, plan: SpmvPlan, values, row_end_offsets, col_indices,
                 tile_rows, tile_nnz, ignored: Optional[dict] = None):
        self.plan = plan
        self.values = values
        self.row_end_offsets = row_end_offsets
        self.col_indices = col_indices
        self.tile_rows = tile_rows
        self.tile_nnz = tile_nnz
        self.ignored = dict(ignored or {})
        self.device = values.device
        self.setup_s: dict = {}
        self.abs_row_sum_max = 0.0
        self.tickets = ticket_counter(self.device)

    @property
    def shape(self):
        return (self.plan.num_rows, self.plan.num_cols)

    @property
    def dtype(self) -> str:
        """The name of the dtype op(x) returns (the plan's)."""
        return self.plan.dtype

    def _vec(self, v):
        return None if v is None else torch.as_tensor(v, device=self.device)

    def __call__(self, x, y_in=None, alpha=1.0, beta=0.0,
                 interpret: bool = False):
        """y = alpha * A @ x + beta * y_in, one launch.  ``interpret``
        (the TPU package's Pallas interpret mode) is accepted and
        ignored."""
        with span(OP_CALL):
            return _csrmv_merge(self.plan, self.values,
                                self.row_end_offsets, self.col_indices,
                                self._vec(x), self._vec(y_in), alpha, beta,
                                (self.tile_rows, self.tile_nnz),
                                self.tickets)

    def bind(self, x):
        """y = A @ x with its checks and launch set up once: returns
        (launch, y), and each ``launch(stream=None)`` writes A @ x, for the
        values x holds then, into the same y, in one launch of op(x)'s
        kernel (on the given raw stream, else the current one; the plain
        version on the CPU).  x must be a contiguous [num_cols]
        vector of the compute dtype, alive and in place while launch is
        used; the launches count on this operator's tickets, so they and
        its calls must be stream-ordered."""
        x = self._vec(x)
        check_vector_operands(self.plan, x)
        return bind_merge_csrmv(self.values, self.col_indices,
                                self.row_end_offsets, x, self.tile_rows,
                                self.tile_nnz, self.plan.tile_items,
                                tickets=self.tickets,
                                policy=self.plan.policy)

    def mm(self, X, Y_in=None, alpha=1.0, beta=0.0, interpret: bool = False,
           method: str = "auto"):
        """SpMM, Y = alpha * A @ X + beta * Y_in for X [num_cols, k].

        ``method="auto"`` runs the measured-fastest general path, as in the
        JAX package; on this card that is one launch of the multi-RHS merge
        kernel K1m for all k columns (ops/csrmv_cuda.py::merge_csrmm; k = 1
        is op(x)): with X row-major a nonzero's X row is one coalesced
        request, so the gather amortises over k, which it did not on the
        TPU (there "auto" is csrmm_column_loop, csrmv_pallas.py:1376-1406).
        ``"column"`` runs that loop: op(x) once per column.  ``"wide"``
        (the JAX package's retired multi-RHS Pallas kernel) raises, as
        there; ``interpret`` is accepted and ignored, in the JAX package's
        position."""
        with span(OP_MM):
            return self._mm(X, Y_in, alpha, beta, method)

    def _mm(self, X, Y_in, alpha, beta, method: str):
        if method == "wide":
            raise ValueError(
                "method='wide' is retired: the multi-RHS kernel measured "
                "~0.3x the per-column loop on the TPU (BENCH_SPMM.json).  "
                "Use method='auto' (one K1m launch) or 'column'.")
        if method not in ("auto", "column"):
            raise ValueError(f"unknown method {method!r}")
        X = self._vec(X)
        Y_in = self._vec(Y_in)
        check_matrix_operands(self.plan, X, Y_in)
        if method == "column":
            return torch.stack([
                self(X[:, k], None if Y_in is None else Y_in[:, k], alpha,
                     beta)
                for k in range(X.shape[1])], dim=1)
        return _csrmm_merge(self.plan, self.values, self.row_end_offsets,
                            self.col_indices, X, Y_in, alpha, beta,
                            (self.tile_rows, self.tile_nnz), self.tickets)

    def describe(self) -> str:
        knobs = ", ".join(f"{k}={v!r}" for k, v in self.ignored.items())
        return (f"{self.plan.describe()} [ignored TPU knobs: {knobs}; "
                "accepted for signature parity with merge_spmv_tpu, no "
                "effect here]")


def assemble_operator(plan: SpmvPlan, values, row_end_offsets, col_indices,
                      ignored: Optional[dict] = None) -> SpmvOperator:
    """The operator over CSR arrays already on its device: the values in
    the plan's compute dtype, the tile search and the row norm (which
    waits for the arrays).  build_operator's second half, and the device
    split builder's (ops/split.py), which makes its stack on the card."""
    values = values.to(compute_dtype(plan.dtype))
    tile_rows, tile_nnz = merge_tile_coordinates(
        row_end_offsets, plan.num_nonzeros, plan.tile_items)
    sums = row_abs_sums(values, row_end_offsets, plan.num_rows)
    op = SpmvOperator(plan, values, row_end_offsets, col_indices, tile_rows,
                      tile_nnz, ignored=ignored)
    op.abs_row_sum_max = float(sums.max()) if sums.numel() else 0.0
    return op


def build_operator(csr, dtype="float32", backend: str = "auto",
                   tile_items: Optional[int] = None,
                   autotune: bool = False,
                   runtime_skip: Optional[bool] = None,
                   gather_group: int = 1,
                   gather_cluster=None,
                   device=None) -> SpmvOperator:
    """Build the operator from a host CsrMatrix (formats/csr.py).

    ``device=None`` means the card, and raises when there is none;
    ``device="cpu"`` runs the kernels' plain versions.  ``backend`` must
    agree with the device ("cuda" on the card, "torch" on the CPU).
    ``autotune=True`` with ``tile_items=None`` takes the tile size that
    card (timed once per class, then cached; the plan's choice on the
    CPU).  The plan takes the gather policy from the columns
    (ops/plan.py::gather_policy).  ``runtime_skip``, ``gather_group`` and
    ``gather_cluster`` are
    the TPU package's tuning knobs: accepted and ignored, and
    ``describe()`` says so.
    """
    dev = resolve_device(device)
    if autotune and tile_items is None:
        from merge_spmv_tpu_torch.ops.autotune import autotune_tile_items
        tile_items = autotune_tile_items(csr, dtype=dtype, device=dev)
    ignored = {"runtime_skip": runtime_skip, "gather_group": gather_group,
               "gather_cluster": gather_cluster}
    return _build(csr, dtype, backend, tile_items, dev, ignored)


def transition_operator(csr, dtype="float32", backend: str = "auto",
                        tile_items: Optional[int] = None,
                        device=None) -> SpmvOperator:
    """The operator of the transition matrix P = D^-1 A of the adjacency
    CSR ``csr``: each stored value divided by its row's sum of values
    (``row_stochastic``; in float64, then rounded to ``dtype``), so that
    P @ X is the mean of X over each row's neighbours, weighted by the
    values.  An empty row (an isolated vertex) stays empty.  Then the
    plan and prepare of ``build_operator``, with the scaling timed into
    ``op.setup_s["transition"]`` (inside ``"prepare"``).  ``device`` as
    in ``build_operator``."""
    return _build(csr, dtype, backend, tile_items, resolve_device(device),
                  {}, transition=True)


def pagerank_operator(csr, dtype="float32", backend: str = "auto",
                      tile_items: Optional[int] = None,
                      device=None) -> SpmvOperator:
    """The operator of PageRank's transition matrix P = A^T D^-1 of the
    link graph's CSR ``csr`` (row u holds u's out-links, square), the
    column-stochastic operator ``models/solvers.py::pagerank`` takes:
    P[v, u] = a_uv / (row u's sum of values), so that for a 0/1 graph
    P @ pr spreads each vertex's rank evenly over its out-links.  A
    vertex with no out-link (dangling) leaves its column empty.  The
    values are copied to the device in float64, scaled and transposed
    there (``column_stochastic``, timed into ``op.setup_s["stochastic"]``
    inside ``"prepare"``), then rounded to ``dtype``; the plan is made on
    P's pattern, after the transpose, so ``"prepare"`` is the sum of its
    halves before and after it.  For a symmetric graph P = A D^-1.
    ``backend``, ``tile_items`` and ``device`` as in ``build_operator``."""
    if csr.num_rows != csr.num_cols:
        raise ValueError(f"a link graph is square, got {csr.num_rows} x "
                         f"{csr.num_cols}")
    dev = resolve_device(device)
    setup_s = {}
    with span(BUILD_PREPARE, into=setup_s, key="prepare"):
        arrays = csr.to_device(dtype=torch.float64, device=dev)
        with span(BUILD_STOCHASTIC, into=setup_s, key="stochastic"):
            values, rowends, cols = column_stochastic(
                *arrays, csr.num_rows, csr.num_cols)
        del arrays
    with span(BUILD_PLAN, into=setup_s, key="plan"):
        plan = make_plan(csr.num_rows, csr.num_cols, csr.num_nonzeros,
                         dtype=dtype, tile_items=tile_items, backend=backend,
                         col_indices=cols, device=dev)
    with span(BUILD_PREPARE, into=setup_s, key="prepare"):
        op = assemble_operator(plan, values.to(torch_dtype(plan.dtype)),
                               rowends, cols)
    op.setup_s = {k: round(v, 3) for k, v in setup_s.items()}
    return op


def _build(csr, dtype, backend, tile_items, dev, ignored,
           transition: bool = False) -> SpmvOperator:
    # setup-cost attribution (gpu_spmv.cu:114-134 reports conversion setup
    # apart from run time): plan = policy; prepare = copy to the device +
    # the tile search + the row norm (+ the transition's scaling)
    setup_s = {}
    with span(BUILD_PLAN, into=setup_s, key="plan"):
        plan = make_plan(csr.num_rows, csr.num_cols, csr.num_nonzeros,
                         dtype=dtype, tile_items=tile_items, backend=backend,
                         col_indices=csr.col_indices, device=dev)
    with span(BUILD_PREPARE, into=setup_s, key="prepare"):
        values, rowends, cols = csr.to_device(
            dtype=torch.float64 if transition else torch_dtype(plan.dtype),
            device=dev)
        if transition:
            with span(BUILD_TRANSITION, into=setup_s, key="transition"):
                values = row_stochastic(values, rowends, plan.num_rows).to(
                    torch_dtype(plan.dtype))
        op = assemble_operator(plan, values, rowends, cols, ignored=ignored)
    op.setup_s = {k: round(v, 3) for k, v in setup_s.items()}
    return op
