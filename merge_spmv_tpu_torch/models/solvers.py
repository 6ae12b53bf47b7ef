"""Iterative solvers and spectral models over any operator of the port.

Counterpart of merge_spmv_tpu/models/solvers.py: the same functions, with
the same signatures and recurrences, over any operator with ``shape``,
``dtype``, ``device`` and ``op(x, y_in, alpha, beta)``: the merge
operator, DIA, the split and hot/cold operators.

    op = build_operator(csr)
    x, info = conjugate_gradient(op, b, tol=1e-6)
    lam, v, info = power_iteration(op, v0)
    pr, info = pagerank(pagerank_operator(link_csr))
    emb, info = fastrp(transition_operator(adjacency_csr), r)

The JAX package runs each loop as ``lax.while_loop`` on the device.
PyTorch has no loop that stays on the device, so here:

* every iteration is masked by a device-side ``active`` flag (the
  while-loop's condition, evaluated at the top of the iteration): once it
  is false the state stops changing, bit for bit;
* the host reads that flag once per block of ``check_every`` iterations;
* on the card the first block runs eagerly (it warms the kernels'
  libraries and the allocator); while the card runs it, the host records
  one block as a CUDA graph, and every later block replays it.  No
  iteration waits on the host.

The iteration count and the result are therefore those of an
iteration-by-iteration loop, whatever ``check_every`` is.  Vector updates
and dot products are plain torch ops in the operand dtype, as they are XLA
ops outside the Pallas kernel in the JAX package; the SpMVs are the
operator's kernels.  CG's step on the card in float32 or float64 is the
operator's product and three fused kernels (models/cg_cuda.py): four
launches a step in place of ~25.  With ``preconditioner="multigrid"`` a
CG step also runs one V-cycle (models/multigrid.py) and two more fused
kernels.

All solvers return (solution, info); ``info.iterations`` and
``info.residual`` are the JAX package's, ``info.host_reads`` counts the
flag reads and ``info.step_ms`` is the device time per masked iteration
over the graph replays (CUDA events around each replay; None when no block
was replayed).

Each phase of a solve is a named span (utils/tracing.py): the solve, its
prologue, each eager block, the capture (its entry, recording and exit),
each replay, each flag read and the graph's release.  An operator sees
them by running the solve under ``torch.profiler`` (host events on the
clock of the card's kernels) or under
``torch.autograd.profiler.emit_nvtx`` for Nsight Systems; with no
profiler a span costs one flag check.
"""

from __future__ import annotations

import functools
import sys
import threading
import warnings
from typing import NamedTuple, Optional

import torch

from merge_spmv_tpu_torch.models import cg_cuda, fastrp_cuda
from merge_spmv_tpu_torch.utils.device import torch_dtype
from merge_spmv_tpu_torch.utils.tracing import (CAPTURE, CAPTURE_ENTER,
                                                CAPTURE_EXIT, CAPTURE_RECORD,
                                                EAGER_BLOCK, FLAG_READ,
                                                NORMALIZE, PROLOGUE, RELEASE,
                                                REPLAY, SOLVE, span)

__all__ = ["conjugate_gradient", "bicgstab", "jacobi", "power_iteration",
           "pagerank", "fastrp", "SolveInfo", "CAPTURES", "NORMALIZES"]

# captures of a block as a CUDA graph: drawn from the device's kept pool
# ("pooled") or through torch.cuda.graph's flush ("fresh", the pool being
# held by another solve); "hidden": ended while the card still ran the
# work before them
CAPTURES = {"pooled": 0, "fresh": 0, "hidden": 0}
# FastRP's normalise-and-accumulate steps, by the path each took: the
# kernel of models/fastrp_cuda.py ("fused") or its torch ops ("torch")
NORMALIZES = {"fused": 0, "torch": 0}


class SolveInfo(NamedTuple):
    iterations: torch.Tensor        # int32, 0-dim
    residual: torch.Tensor          # final ||r|| or method-specific
    host_reads: int = 0             # reads of the active flag
    step_ms: Optional[float] = None  # device ms per masked iteration


def _norm(v):
    return torch.sqrt(torch.sum(v * v))


def _vector(op, v):
    return torch.as_tensor(v, device=op.device)


def _commit(active, *pairs):
    """state <- new where active, else unchanged, in place."""
    for state, new in pairs:
        state.copy_(torch.where(active, new, state))


def _solver(solve):
    """``solve`` inside the solve span."""
    @functools.wraps(solve)
    def spanned(*args, **kwargs):
        with span(SOLVE):
            return solve(*args, **kwargs)
    return spanned


class _Pool:
    """One device's kept capture pool: a side stream, a graph pool id, an
    empty graph that holds the id's device and pinned-host pools open
    between the solves' graphs (destroying the last graph of a pool
    closes it, and torch refuses to capture into a closed pool again),
    and a lock that one solve holds from its capture to its graph's
    release, so no two live graphs share the pool's blocks."""

    def __init__(self, device: torch.device):
        with torch.cuda.device(device):
            self.stream = torch.cuda.Stream()
            self.id = torch.cuda.graph_pool_handle()
            self.keeper = torch.cuda.CUDAGraph()
            with torch.cuda.stream(self.stream), warnings.catch_warnings():
                warnings.filterwarnings("ignore", "The CUDA Graph is empty")
                self.keeper.capture_begin(pool=self.id,
                                          capture_error_mode="thread_local")
                self.keeper.capture_end()
        self.lock = threading.Lock()


_POOLS: dict = {}
# one capture at a time in the process (a pool's keeper included):
# torch.cuda.graph's entry synchronises the card and flushes the caches,
# which a capture under way on another thread must not meet
_CAPTURING = threading.Lock()


def _pool(device: torch.device) -> _Pool:
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    with _CAPTURING:
        if index not in _POOLS:
            _POOLS[index] = _Pool(torch.device("cuda", index))
        return _POOLS[index]


class _Pooled:
    """torch.cuda.graph's entry and exit without its synchronise and
    cache flush: the pool's side stream, then ``capture_begin`` into the
    kept pool."""

    def __init__(self, graph, pool: _Pool):
        self.graph, self.pool = graph, pool

    def __enter__(self):
        self.stream = torch.cuda.stream(self.pool.stream)
        self.stream.__enter__()
        try:
            self.graph.capture_begin(pool=self.pool.id,
                                     capture_error_mode="thread_local")
        except BaseException:
            self.stream.__exit__(*sys.exc_info())
            raise

    def __exit__(self, *exc):
        try:
            self.graph.capture_end()
        finally:
            self.stream.__exit__(*exc)


def _capture(block, device: torch.device):
    """One CUDA graph of ``block()``, its entry, recording and exit in
    spans of their own.  Returns (graph, pool): the device's kept pool
    when the graph drew from it, which the caller holds until the graph
    is destroyed and then unlocks; None when another solve held the pool
    and the capture took torch.cuda.graph's own entry (a synchronise and
    the allocator's flush) and a fresh pool.  Counts the capture in
    ``CAPTURES``: pooled or fresh, and hidden when the card was still
    running the work enqueued before the capture as it ended."""
    captured = torch.cuda.CUDAGraph()
    pool = _pool(device)
    if not pool.lock.acquire(blocking=False):
        pool = None
    try:
        with span(CAPTURE), _CAPTURING:
            with span(CAPTURE_ENTER):
                before = torch.cuda.Event()
                before.record()
                capture = (torch.cuda.graph(captured,
                                            capture_error_mode="thread_local")
                           if pool is None else _Pooled(captured, pool))
                capture.__enter__()
            try:
                with span(CAPTURE_RECORD):
                    block()
            except BaseException:
                with span(CAPTURE_EXIT):
                    capture.__exit__(*sys.exc_info())
                raise
            with span(CAPTURE_EXIT):
                capture.__exit__(None, None, None)
            CAPTURES["fresh" if pool is None else "pooled"] += 1
            if not before.query():
                CAPTURES["hidden"] += 1
    except BaseException:
        if pool is not None:
            pool.lock.release()
        raise
    return captured, pool


def _iterate(step, active, device, maxiter: int, check_every: int,
             graph: Optional[bool]):
    """Run ``step()`` (one masked iteration, in place) in blocks of
    ``check_every`` until ``active()`` reads false on the host, once per
    block.  ``graph`` (default: on the card) replays the blocks after the
    first as one CUDA graph, recorded while the card runs the first.
    Returns (host reads, device ms per replayed iteration or None)."""
    if check_every < 1:
        raise ValueError(f"check_every must be >= 1, got {check_every}")
    if graph is None:
        graph = device.type == "cuda"
    if graph and device.type != "cuda":
        raise ValueError("graph replay needs a CUDA device")

    def block():
        for _ in range(check_every):
            step()

    # the step masks itself once k reaches maxiter, so this many blocks
    # always end inactive
    max_blocks = -(-max(int(maxiter), 0) // check_every)
    captured, pool, events, reads = None, None, [], 0
    try:
        for b in range(max_blocks):
            if b == 0 or not graph:
                with span(EAGER_BLOCK):
                    block()
                if graph and b == 0 and max_blocks >= 2:
                    captured, pool = _capture(block, device)
            else:
                with span(REPLAY):
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    captured.replay()
                    end.record()
                events.append((start, end))
            reads += 1
            with span(FLAG_READ):
                done = not bool(active())
            if done:
                break
        with span(RELEASE):
            step_ms = None
            if events:
                step_ms = (sum(s.elapsed_time(e) for s, e in events)
                           / (len(events) * check_every))
            # the graph's destructor (its exec) runs here, inside the span
            captured = events = None
    finally:
        # on an error too, the graph goes before its pool serves another
        captured = None
        if pool is not None:
            pool.lock.release()
    return reads, step_ms


@_solver
def conjugate_gradient(op, b, x0=None, tol: float = 1e-6,
                       maxiter: int = 1000, check_every: int = 16,
                       graph: Optional[bool] = None,
                       preconditioner: Optional[str] = None):
    """CG for symmetric positive-definite A (e.g. grid Laplacians).

    Standard Hestenes-Stiefel recurrence; one op(x) per iteration.  On a
    CUDA device in float32 or float64 the step's vector work is the fused
    kernels of models/cg_cuda.py; elsewhere torch ops.

    ``preconditioner="multigrid"`` runs HPCG's preconditioned CG over an
    operator of models/multigrid.py::build_multigrid: z = M r (one
    V-cycle) in the prologue and after each step's update, alpha = r.z /
    p.Ap, beta = (r.z)_new / (r.z)_old, p = z + beta p.  The stopping
    test and ``info.residual`` stay on ||r||.
    """
    if preconditioner not in (None, "multigrid"):
        raise ValueError(f"unknown preconditioner {preconditioner!r}")
    pre = preconditioner is not None
    if pre and not hasattr(op, "precondition"):
        raise ValueError("preconditioner='multigrid' takes an operator of "
                         "build_multigrid")
    with span(PROLOGUE):
        b = _vector(op, b)
        x = torch.zeros_like(b) if x0 is None else _vector(op, x0).clone()
        r = b - op(x)
        z = rz = None
        if pre:
            z = op.precondition(r, torch.empty_like(r))
            p = z.clone()
            rz = torch.sum(r * z)
        else:
            p = r.clone()
        rs = torch.sum(r * r)
        tol2 = torch.tensor(tol, dtype=b.dtype, device=b.device) ** 2 \
            * torch.sum(b * b)
        k = torch.zeros((), dtype=torch.int32, device=b.device)
        fused = (cg_cuda.FusedCgStep(x, r, p, rs, tol2, k, maxiter, z, rz)
                 if cg_cuda.takes(b.device, b.dtype) else None)

    def active():
        return (rs > tol2) & (k < maxiter)

    def precondition():
        op.precondition(r, z)

    def step():
        if fused is None and pre:
            pcg_torch_step(op, x, r, p, z, rs, rz, tol2, k, maxiter)
        elif fused is None:
            cg_torch_step(op, x, r, p, rs, tol2, k, maxiter)
        elif pre:
            fused.step(op(p), precondition)
        else:
            fused.step(op(p))

    reads, step_ms = _iterate(step, active, b.device, maxiter, check_every,
                              graph)
    return x, SolveInfo(k, torch.sqrt(rs), reads, step_ms)


def cg_torch_step(op, x, r, p, rs, tol2, k, maxiter: int):
    """One masked CG step in torch ops, in place: the step everywhere the
    fused one is not taken, and its plain version."""
    act = (rs > tol2) & (k < maxiter)
    ap = op(p)
    alpha = rs / torch.sum(p * ap)
    x_n = x + alpha * p
    r_n = r - alpha * ap
    rs_n = torch.sum(r_n * r_n)
    p_n = r_n + (rs_n / rs) * p
    _commit(act, (x, x_n), (r, r_n), (p, p_n), (rs, rs_n))
    k.add_(act.to(k.dtype))


def pcg_torch_step(op, x, r, p, z, rs, rz, tol2, k, maxiter: int):
    """One masked preconditioned CG step in torch ops, in place, z = M r
    by ``op.precondition`` into the scratch z: the step everywhere the
    fused one is not taken, and its plain version."""
    act = (rs > tol2) & (k < maxiter)
    ap = op(p)
    alpha = rz / torch.sum(p * ap)
    x_n = x + alpha * p
    r_n = r - alpha * ap
    rs_n = torch.sum(r_n * r_n)
    z_n = op.precondition(r_n, z)
    rz_n = torch.sum(r_n * z_n)
    p_n = z_n + (rz_n / rz) * p
    _commit(act, (x, x_n), (r, r_n), (p, p_n), (rs, rs_n), (rz, rz_n))
    k.add_(act.to(k.dtype))


@_solver
def bicgstab(op, b, x0=None, tol: float = 1e-6, maxiter: int = 1000,
             check_every: int = 16, graph: Optional[bool] = None):
    """BiCGSTAB for general (nonsymmetric) A: two op(x) per iteration."""
    with span(PROLOGUE):
        b = _vector(op, b)
        x = torch.zeros_like(b) if x0 is None else _vector(op, x0).clone()
        r = b - op(x)
        r_hat = r.clone()
        one = torch.ones((), dtype=b.dtype, device=b.device)
        rho, alpha, omega = one.clone(), one.clone(), one.clone()
        v, p = torch.zeros_like(b), torch.zeros_like(b)
        tol2 = torch.tensor(tol, dtype=b.dtype, device=b.device) ** 2 \
            * torch.sum(b * b)
        k = torch.zeros((), dtype=torch.int32, device=b.device)

    def active():
        return (torch.sum(r * r) > tol2) & (k < maxiter)

    def step():
        act = active()
        rho_n = torch.sum(r_hat * r)
        beta = (rho_n / rho) * (alpha / omega)
        p_n = r + beta * (p - omega * v)
        v_n = op(p_n)
        alpha_n = rho_n / torch.sum(r_hat * v_n)
        s = r - alpha_n * v_n
        t = op(s)
        omega_n = torch.sum(t * s) / torch.sum(t * t)
        x_n = x + alpha_n * p_n + omega_n * s
        r_n = s - omega_n * t
        _commit(act, (x, x_n), (r, r_n), (rho, rho_n), (alpha, alpha_n),
                (omega, omega_n), (v, v_n), (p, p_n))
        k.add_(act.to(k.dtype))

    reads, step_ms = _iterate(step, active, b.device, maxiter, check_every,
                              graph)
    return x, SolveInfo(k, _norm(r), reads, step_ms)


@_solver
def jacobi(op, diag, b, x0=None, tol: float = 1e-6, maxiter: int = 1000,
           check_every: int = 16, graph: Optional[bool] = None):
    """Jacobi iteration x <- x + D^-1 (b - A x); ``diag`` is A's diagonal."""
    with span(PROLOGUE):
        b = _vector(op, b)
        inv_d = 1.0 / _vector(op, diag)
        x = torch.zeros_like(b) if x0 is None else _vector(op, x0).clone()
        tol2 = torch.tensor(tol, dtype=b.dtype, device=b.device) ** 2 \
            * torch.sum(b * b)
        rs = torch.full((), float("inf"), dtype=b.dtype, device=b.device)
        k = torch.zeros((), dtype=torch.int32, device=b.device)

    def active():
        return (rs > tol2) & (k < maxiter)

    def step():
        act = active()
        r = b - op(x)
        x_n = x + inv_d * r
        _commit(act, (x, x_n), (rs, torch.sum(r * r)))
        k.add_(act.to(k.dtype))

    reads, step_ms = _iterate(step, active, b.device, maxiter, check_every,
                              graph)
    return x, SolveInfo(k, torch.sqrt(rs), reads, step_ms)


@_solver
def power_iteration(op, v0=None, tol: float = 1e-6, maxiter: int = 1000,
                    seed: int = 0, check_every: int = 16,
                    graph: Optional[bool] = None):
    """Dominant eigenpair of A by normalized power iteration.

    Returns (eigenvalue, eigenvector, info).  Without ``v0`` the start is
    standard normal from a ``torch.Generator`` seeded with ``seed`` (not
    the JAX package's PRNGKey stream).
    """
    with span(PROLOGUE):
        n = op.shape[1]
        dtype = torch_dtype(op.dtype)
        if v0 is None:
            gen = torch.Generator(device="cpu").manual_seed(seed)
            v = torch.randn(n, generator=gen, dtype=torch.float32).to(
                device=op.device, dtype=dtype)
        else:
            v = _vector(op, v0)
        v = v / _norm(v)
        lam = torch.zeros((), dtype=dtype, device=v.device)
        diff = torch.full((), float("inf"), dtype=dtype, device=v.device)
        k = torch.zeros((), dtype=torch.int32, device=v.device)

    def active():
        return (diff > tol) & (k < maxiter)

    def step():
        act = active()
        w = op(v)
        lam_n = torch.sum(v * w)
        w_norm = _norm(w)
        v_n = w / torch.where(w_norm > 0, w_norm, 1.0)
        _commit(act, (v, v_n), (diff, torch.abs(lam_n - lam)),
                (lam, lam_n))
        k.add_(act.to(k.dtype))

    reads, step_ms = _iterate(step, active, v.device, maxiter, check_every,
                              graph)
    return lam, v, SolveInfo(k, diff, reads, step_ms)


@_solver
def pagerank(op, damping: float = 0.85, tol: float = 1e-8,
             maxiter: int = 200, check_every: int = 16,
             graph: Optional[bool] = None):
    """PageRank over a column-stochastic transition operator.

    ``op`` must apply P (out-degree-normalized adjacency transpose,
    ops/operator.py::pagerank_operator):
    pr <- damping * P pr + (1 - damping)/n.  Dangling mass is redistributed
    uniformly so the total stays 1.
    """
    with span(PROLOGUE):
        n = op.shape[0]
        dtype = torch_dtype(op.dtype)
        pr = torch.full((n,), 1.0 / n, dtype=dtype, device=op.device)
        teleport = torch.tensor((1.0 - damping) / n, dtype=dtype,
                                device=op.device)
        diff = torch.full((), float("inf"), dtype=dtype, device=op.device)
        k = torch.zeros((), dtype=torch.int32, device=op.device)

    def active():
        return (diff > tol) & (k < maxiter)

    def step():
        act = active()
        spread = op(pr)
        dangling = (1.0 - torch.sum(spread)) / n     # mass lost to sinks
        new = damping * (spread + dangling) + teleport
        _commit(act, (diff, torch.sum(torch.abs(new - pr))), (pr, new))
        k.add_(act.to(k.dtype))

    reads, step_ms = _iterate(step, active, pr.device, maxiter, check_every,
                              graph)
    return pr, SolveInfo(k, diff, reads, step_ms)


@_solver
def fastrp(op, r, iteration_weights=(0.0, 1.0, 1.0)):
    """FastRP node embeddings (Chen et al., "Fast and Accurate Network
    Embeddings via Very Sparse Random Projection", CIKM 2019, Algorithm
    1), as Neo4j Graph Data Science's ``gds.fastRP`` computes them:

        N_1 = P R,  N_i = P n(N_{i-1}),  E = sum_i w_i n(N_i)

    ``op`` applies the transition matrix P = D^-1 A
    (ops/operator.py::transition_operator), ``r`` [num_cols, d] is the
    random projection, ``w`` the ``iteration_weights`` (one product
    each) and n the L2 normalisation of each row (a row of norm 0 stays
    0).  The normalisation strength is 0, so R is not scaled by degree.
    Since n takes out any positive scale of a row, n(P X) = n(A X): the
    D^-1 only keeps each product's rows at the size of a mean.

    Each product is ``op.mm`` (K1m on the card, in blocks of 64 columns);
    each normalise-and-accumulate runs in place in a span of its own
    (models/fastrp_cuda.py: one kernel launch on the card, which reads the
    product once, the torch ops on the CPU; counted in ``NORMALIZES``),
    so a call holds about three [num_rows, d] blocks: the normalised
    input, the product and E.  The last product's n(N) is not stored,
    since nothing reads it, and with a last weight of 0 its step is not
    made.  E is made where the first nonzero weight meets it.  Nothing waits for the card:
    ``info.iterations`` is the count of products on the host,
    ``info.residual`` is 0 (FastRP has none), ``host_reads`` 0 and
    ``step_ms`` None.
    """
    with span(PROLOGUE):
        weights = [float(w) for w in iteration_weights]
        if not weights:
            raise ValueError("iteration_weights must not be empty")
        x = _vector(op, r)
        emb = None
    for i, w in enumerate(weights):
        n = op.mm(x)
        store_n = i + 1 < len(weights)
        if store_n or w != 0.0:
            with span(NORMALIZE):
                fused = fastrp_cuda.takes(n.device)
                step = (fastrp_cuda.row_normalize if fused
                        else fastrp_cuda.row_normalize_plain)
                emb = step(n, emb, w, store_n=store_n)
                NORMALIZES["fused" if fused else "torch"] += 1
        x = n
    if emb is None:
        emb = torch.zeros_like(x)
    return emb, SolveInfo(torch.tensor(len(weights), dtype=torch.int32),
                          torch.zeros(()), 0, None)
