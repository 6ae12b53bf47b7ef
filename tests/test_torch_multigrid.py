"""HPCG's multigrid preconditioner (merge_spmv_tpu_torch/models/
multigrid.py) and ``conjugate_gradient(..., preconditioner="multigrid")``
against the plain reference (models/hpcg_reference.py, its own hierarchy),
at small grids on the CPU: the hierarchy, the colouring, one colour step,
one sweep, one V-cycle and PCG; what build_multigrid refuses; CG's bits
without a preconditioner.  The tests marked ``cuda`` run the same path on
the card (graph against eager, the colour step's one launch against its
plain route, the kernels' launch counts) and skip without one:

    python -m pytest --noconftest tests/test_torch_multigrid.py -m cuda -q

Tolerances.  Program and reference compute the same arithmetic but sum
each row's <= 27 products in another order (the merge-path decomposition
against index_add_), so a row's product differs by up to about 27 unit
roundoffs of the row's |A| |x| <= 52 max|x|, and an update by that over
26: ~54 u max|x|.  A colour step and a sweep are held to 64 u of max|x|;
a V-cycle, which chains ~100 such steps through the levels, and PCG's
iterates (each the solution of a well-conditioned system through those
V-cycles) to 2^10 u relative to the reference's max.  u is the dtype's
unit roundoff: 2^-53 in float64, 2^-24 in float32.  float32 PCG at 50
iterations runs with tol = 1e-5, so that it stops at convergence: run on
at tol = 0 its recurrence underflows to 0 / 0 in program and reference
alike.  PCG at 50 iterations runs on the 8^3 grid.

The card's colour step (one launch: the colour's product and update)
against its plain route (the colour operator's K1 product, then
symgs_update_plain) on the same x and r: the two sum a row's <= 27
products in other orders, so a row of x differs by up to 2 gamma_27 of
(|A_c| |x|)_i / a_ii and a few roundings of the update, ~62 unit
roundoffs of s_i = (|A_c| |x| + |r|)_i / a_ii at worst; rounding errors
of that many terms grow like their square root, and the kernel is held
to COLOUR_ULPS = 16 of s_i in every row (chip_smoke.py's bound).

The V-cycle is thousands of small torch ops; the file's tests run with
one intra-op thread, so that idle threads spinning after an op do not
compete with them on a loaded CPU (the setting is restored after).
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from merge_spmv_tpu_torch import build_multigrid
from merge_spmv_tpu_torch.formats.csr import CsrMatrix
from merge_spmv_tpu_torch.models import cg_cuda
from merge_spmv_tpu_torch.models import hpcg_reference as R
from merge_spmv_tpu_torch.models import multigrid as MG
from merge_spmv_tpu_torch.models import multigrid_cuda
from merge_spmv_tpu_torch.models import solvers as S
from merge_spmv_tpu_torch.ops.operator import build_operator
from merge_spmv_tpu_torch.utils import cuda_build
from merge_spmv_tpu_torch.utils import tracing as T

GRIDS = [(8, 8, 8), (16, 8, 8)]
DTYPES = [torch.float64, torch.float32]
COLOUR_ULPS = 16
_BUILT: dict = {}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _name(dtype):
    return str(dtype).split(".")[1]


def _unit(dtype):
    return torch.finfo(dtype).eps / 2


def _mg(dims, dtype, device="cpu"):
    """(multigrid operator, reference hierarchy) of the grid, built once a
    test session."""
    key = (dims, dtype, str(device))
    if key not in _BUILT:
        _BUILT[key] = (build_multigrid(MG.stencil27(*dims),
                                       dtype=_name(dtype), device=device),
                       R.hierarchy(dims, dtype))
    return _BUILT[key]


def _uniform(n, dtype, seed):
    return torch.from_numpy(
        np.random.RandomState(seed).uniform(-1, 1, n)).to(dtype)


def _close(got, want, units, dtype, scale=None):
    """max |got - want| within ``units`` unit roundoffs of ``scale``
    (default max |want|)."""
    got, want = got.double().cpu(), want.double().cpu()
    scale = float(want.abs().max()) if scale is None else scale
    return float((got - want).abs().max()) <= units * _unit(dtype) * scale


# ---------------------------------------------------------------------- #
# The hierarchy and the colouring
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("dims", GRIDS)
def test_levels_f2c_and_coarse_matrices_are_hpcgs(dims):
    """Every level's matrix is HPCG's stencil on the halved grid, entry
    for entry (the reference's own construction), and f2c takes coarse
    (i, j, k) to fine (2i, 2j, 2k)."""
    op, ref = _mg(dims, torch.float64)
    assert [lv.dims for lv in op.levels] == [lv.dims for lv in ref]
    for level, want in zip(op.levels, ref):
        got = level.op
        counts = torch.bincount(want.rows, minlength=want.n)
        assert torch.equal(got.row_end_offsets.long(), torch.cumsum(counts, 0))
        assert torch.equal(got.col_indices.long(), want.cols)
        assert torch.equal(got.values, want.vals)
        if want.f2c is None:
            assert level.f2c is None
            continue
        assert torch.equal(level.f2c.long(), want.f2c)
    nx, ny, _ = dims
    f2c = op.levels[0].f2c.long()
    cx, cy = nx // 2, ny // 2
    assert int(f2c[1]) == 2 and int(f2c[cx]) == 2 * nx
    assert int(f2c[cx * cy]) == 2 * nx * ny


@pytest.mark.parametrize("dims", GRIDS)
def test_no_two_rows_of_one_colour_share_a_nonzero(dims):
    """In each colour's operator a row's columns of its own colour are the
    row itself: a colour's products read no x that its update writes,
    but its own.  The colours cover every row once."""
    op, _ = _mg(dims, torch.float64)
    for level in op.levels:
        colour = torch.from_numpy(MG.colours(*level.dims).astype(np.int64))
        seen = torch.zeros(colour.shape[0], dtype=torch.int64)
        for c, part in enumerate(level.colours):
            if part is None:
                assert not bool((colour == c).any())
                continue
            rows = part.rows.long()
            seen[rows] += 1
            assert bool((colour[rows] == c).all())
            sub = part.op
            lengths = torch.diff(sub.row_end_offsets.long(),
                                 prepend=torch.zeros(1, dtype=torch.long))
            row_of = rows.repeat_interleave(lengths)
            cols = sub.col_indices.long()
            same = colour[cols] == c
            assert torch.equal(cols[same], row_of[same])
            assert torch.equal(part.diag, torch.full_like(part.diag, 26.0))
        assert bool((seen == 1).all())


# ---------------------------------------------------------------------- #
# The V-cycle's parts and PCG against the reference
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dims", GRIDS)
def test_one_colour_step_equals_the_reference(dims, dtype):
    op, ref = _mg(dims, dtype)
    n = ref[0].n
    r = _uniform(n, dtype, 1)
    for c in MG.FORWARD:
        x = _uniform(n, dtype, 2 + c)
        want = R.colour_step(ref[0], c, r, x.clone())
        got = x.clone()
        op.bind(0, r, got).colours[c]()
        assert _close(got, want, 64, dtype, scale=1.0), c
        untouched = torch.ones(n, dtype=torch.bool)
        untouched[ref[0].colour_rows[c]] = False
        assert torch.equal(got[untouched], x[untouched])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dims", GRIDS)
def test_one_symgs_sweep_equals_the_reference(dims, dtype):
    op, ref = _mg(dims, dtype)
    for lv, level in enumerate(ref):
        r = _uniform(level.n, dtype, 10 + lv)
        want = R.symgs(level, r, torch.zeros_like(r))
        got = torch.zeros_like(r)
        for launch, _ in op.bind(lv, r, got).sweep:
            launch()
        assert _close(got, want, 64, dtype, scale=1.0), lv


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dims", GRIDS)
def test_one_vcycle_equals_the_reference(dims, dtype):
    op, ref = _mg(dims, dtype)
    r = _uniform(ref[0].n, dtype, 20)
    z = torch.full_like(r, float("nan"))     # the V-cycle starts at 0
    got = op.precondition(r, z)
    assert got is z
    assert _close(got, R.vcycle(ref, r), 2 ** 10, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dims,maxiter", [
    (dims, m) for dims in GRIDS for m in (1, 2, 3)] + [(GRIDS[0], 50)],
    ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_pcg_equals_the_reference(dims, dtype, maxiter):
    """x after ``maxiter`` iterations, the iteration count and ||r||."""
    op, ref = _mg(dims, dtype)
    b = _uniform(ref[0].n, dtype, 30)
    tol = 1e-5 if (dtype == torch.float32 and maxiter == 50) else 0.0
    x, info = S.conjugate_gradient(op, b, tol=tol, maxiter=maxiter,
                                   check_every=maxiter,
                                   preconditioner="multigrid")
    want, iterates, rnorm = R.pcg(dims, b, maxiter, dtype, ref, tol=tol)
    assert int(info.iterations) == len(iterates)
    assert len(iterates) == maxiter or tol > 0
    assert _close(x, want, 2 ** 10, dtype)
    assert _close(info.residual.reshape(1),
                  torch.tensor([rnorm], dtype=torch.float64), 2 ** 10,
                  dtype, scale=float(torch.linalg.vector_norm(b.double())))


def test_coarse_levels_correct_the_fine_one(monkeypatch):
    """f2c injects from colour 0, which the sweep does not update last
    (forward 7 to 0, backward 0 to 7), so the coarse correction is real:
    without the prolongation z moves by more than 1% of its size (2% on
    this grid, whose coarse levels are 8 x 4 x 4 and smaller).
    Ending a sweep on colour 0 leaves the injected residual 0 to
    rounding, and the coarse levels would correct nothing."""
    op, _ = _mg((16, 8, 8), torch.float64)
    colour = MG.colours(16, 8, 8)
    assert set(colour[op.levels[0].f2c.numpy()]) == {0}
    assert MG.FORWARD == (7, 6, 5, 4, 3, 2, 1, 0)
    assert MG.BACKWARD == MG.FORWARD[::-1]
    r = _uniform(op.shape[0], torch.float64, 32)
    z = op.precondition(r, torch.empty_like(r)).clone()

    def rebuilt():      # the V-cycle is bound at build
        return build_multigrid(MG.stencil27(16, 8, 8), dtype="float64",
                               device="cpu")
    monkeypatch.setattr(multigrid_cuda, "bind_prolong",
                        lambda x, xc, f2c: (lambda stream=None: None))
    alone = rebuilt().precondition(r, torch.empty_like(r))
    assert float((z - alone).abs().max()) > 0.01 * float(z.abs().max())
    monkeypatch.setattr(MG, "FORWARD", tuple(range(8)))
    monkeypatch.setattr(MG, "BACKWARD", tuple(range(7, -1, -1)))
    ended_on_0 = rebuilt()
    ended_on_0.precondition(r, torch.empty_like(r))
    assert float(ended_on_0.levels[1].x.abs().max()) < 1e-12


def test_pcg_reduces_the_residual_faster_than_cg():
    """The preconditioner does work: after 3 iterations PCG's ||r|| is well
    below unpreconditioned CG's on the same b."""
    op, _ = _mg((16, 8, 8), torch.float64)
    b = _uniform(op.shape[0], torch.float64, 31)
    _, pcg = S.conjugate_gradient(op, b, tol=0.0, maxiter=3, check_every=3,
                                  preconditioner="multigrid")
    _, cg = S.conjugate_gradient(op, b, tol=0.0, maxiter=3, check_every=3)
    assert float(pcg.residual) < 0.2 * float(cg.residual)


# ---------------------------------------------------------------------- #
# The entry, the solver's signature and the CPU path's counters
# ---------------------------------------------------------------------- #

def _changed(csr, what):
    vals, cols = csr.values.copy(), csr.col_indices.copy()
    if what == "value":
        vals[5] = -2.0
    elif what == "column":   # inside row 100, so row 0 reads the grid
        at = int(csr.row_offsets[100])
        cols[at + 1], cols[at + 2] = cols[at + 2], cols[at + 1]
    return CsrMatrix(csr.num_rows, csr.num_cols, csr.row_offsets, cols, vals)


@pytest.mark.parametrize("case,match", [
    ("grid 12^3", "divide by 8"),
    ("grid 8 x 8 x 4", "divide by 8"),
    ("a value changed", "not HPCG's"),
    ("two columns swapped", "not HPCG's"),
    ("a 2-D Laplacian", "not HPCG's"),
    ("not square", "not HPCG's"),
])
def test_build_multigrid_refuses_what_is_not_hpcgs_stencil(case, match):
    if case == "grid 12^3":
        csr = MG.stencil27(12, 12, 12)
    elif case == "grid 8 x 8 x 4":
        csr = MG.stencil27(8, 8, 4)
    elif case == "a value changed":
        csr = _changed(MG.stencil27(8, 8, 8), "value")
    elif case == "two columns swapped":
        csr = _changed(MG.stencil27(8, 8, 8), "column")
    elif case == "a 2-D Laplacian":
        from merge_spmv_tpu_torch.formats.coo import CooMatrix
        csr = CsrMatrix.from_coo(CooMatrix.grid2d(16))
    else:
        full = MG.stencil27(8, 8, 8)
        csr = CsrMatrix(full.num_rows, full.num_cols + 1, full.row_offsets,
                        full.col_indices, full.values)
    with pytest.raises(ValueError, match=match):
        build_multigrid(csr, dtype="float64", device="cpu")


def test_build_multigrid_refuses_other_dtypes():
    with pytest.raises(ValueError, match="float32 or float64"):
        build_multigrid(MG.stencil27(8, 8, 8), dtype="bfloat16",
                        device="cpu")


def test_a_bound_product_is_the_call_on_what_x_holds_then():
    """SpmvOperator.bind: each launch writes A @ x for x's values at that
    launch into the same y, op(x)'s bits."""
    csr = MG.stencil27(8, 8, 8)
    fine = build_operator(csr, dtype="float64", device="cpu")
    x = _uniform(csr.num_rows, torch.float64, 41)
    launch, y = fine.bind(x)
    launch()
    assert torch.equal(y, fine(x))
    x.copy_(_uniform(csr.num_rows, torch.float64, 42))
    launch()
    assert torch.equal(y, fine(x))
    with pytest.raises(ValueError, match="x must have shape"):
        fine.bind(x[:-1])


def test_the_fine_level_is_bound_again_for_new_vectors():
    """precondition takes any r and z of the fine level's shape, dtype and
    device: level 0 is bound once, at build, to its own r and x, which
    r is copied into and z out of, so new vectors (and r as z) need no
    new binding; r is left as it was; anything else is refused."""
    op, ref = _mg((8, 8, 8), torch.float64)
    first = op._bound[0]
    r1, r2 = (_uniform(op.shape[0], torch.float64, s) for s in (43, 44))
    z = torch.empty_like(r1)
    assert _close(op.precondition(r1, z), R.vcycle(ref, r1), 2 ** 10,
                  torch.float64)
    kept = r2.clone()
    assert _close(op.precondition(r2, torch.empty_like(r2)),
                  R.vcycle(ref, r2), 2 ** 10, torch.float64)
    assert torch.equal(r2, kept)
    assert _close(op.precondition(r2, r2), R.vcycle(ref, kept), 2 ** 10,
                  torch.float64)
    assert op._bound[0] is first
    with pytest.raises(ValueError, match="z must be"):
        op.precondition(r1, torch.empty(op.shape[0] - 1, dtype=r1.dtype))
    with pytest.raises(ValueError, match="r must be"):
        op.precondition(r1.float(), z)


def test_its_products_are_the_fine_operators_and_setup_is_timed():
    csr = MG.stencil27(8, 8, 8)
    op = build_multigrid(csr, dtype="float64", device="cpu")
    fine = build_operator(csr, dtype="float64", device="cpu")
    x = _uniform(csr.num_rows, torch.float64, 40)
    X = torch.stack([x, 2 * x], 1)
    assert torch.equal(op(x), fine(x))
    assert torch.equal(op(x, x, 2.0, 0.5), fine(x, x, 2.0, 0.5))
    assert torch.equal(op.mm(X), fine.mm(X))
    assert op.shape == fine.shape and op.dtype == "float64"
    assert list(op.setup_s) == ["plan", "prepare", "multigrid"]
    assert all(v >= 0.0 and round(v, 3) == v for v in op.setup_s.values())


def _frozen_cg(op, b, maxiter):
    """CG's torch step as it stood before the preconditioner, one
    iteration at a time: the bits the unpreconditioned path keeps."""
    x = torch.zeros_like(b)
    r = b - op(x)
    p = r.clone()
    rs = torch.sum(r * r)
    for _ in range(maxiter):
        ap = op(p)
        alpha = rs / torch.sum(p * ap)
        x = x + alpha * p
        r = r - alpha * ap
        rs_n = torch.sum(r * r)
        p = r + (rs_n / rs) * p
        rs = rs_n
    return x, rs


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["multigrid", "merge"])
def test_unpreconditioned_cg_keeps_its_bits(kind, dtype):
    csr = MG.stencil27(8, 8, 8)
    op = (_mg((8, 8, 8), dtype)[0] if kind == "multigrid" else
          build_operator(csr, dtype=_name(dtype), device="cpu"))
    b = _uniform(csr.num_rows, dtype, 50)
    x_want, rs_want = _frozen_cg(op, b, 12)
    for every in (1, 16):
        x, info = S.conjugate_gradient(op, b, tol=0.0, maxiter=12,
                                       check_every=every)
        assert int(info.iterations) == 12
        assert torch.equal(x, x_want)
        assert torch.equal(info.residual, torch.sqrt(rs_want))


def test_preconditioner_is_checked():
    op, _ = _mg((8, 8, 8), torch.float64)
    b = torch.ones(op.shape[0], dtype=torch.float64)
    with pytest.raises(ValueError, match="unknown preconditioner"):
        S.conjugate_gradient(op, b, preconditioner="jacobi")
    plain = build_operator(MG.stencil27(8, 8, 8), dtype="float64",
                           device="cpu")
    with pytest.raises(ValueError, match="build_multigrid"):
        S.conjugate_gradient(plain, b, preconditioner="multigrid")


def test_fused_step_takes_z_and_rz_together():
    x, r, p, z = (torch.zeros(8) for _ in range(4))
    rs, tol2, rz = (torch.ones(()) for _ in range(3))
    k = torch.zeros((), dtype=torch.int32)
    with pytest.raises(ValueError, match="both z and rz"):
        cg_cuda.FusedCgStep(x, r, p, rs, tol2, k, 10, z=z)
    with pytest.raises(ValueError, match="CUDA device"):
        cg_cuda.FusedCgStep(x, r, p, rs, tol2, k, 10, z=z, rz=rz)


def test_cpu_path_loads_no_library_and_counts_no_launch():
    MG.reset_launches()
    multigrid_cuda.reset_launches()
    op, _ = _mg((8, 8, 8), torch.float64)
    S.conjugate_gradient(op, torch.ones(op.shape[0], dtype=torch.float64),
                         maxiter=2, check_every=2, preconditioner="multigrid")
    assert MG.LAUNCHES == {}
    assert set(multigrid_cuda.LAUNCHES.values()) == {0}
    assert set(cg_cuda.PCG_LAUNCHES.values()) == {0}
    assert multigrid_cuda.KERNEL_SOURCE not in cuda_build._LOADED


def test_plain_vector_kernels_compute_their_formulas():
    r = _uniform(10, torch.float64, 60)
    axf = _uniform(10, torch.float64, 61)
    f2c = torch.tensor([0, 3, 7], dtype=torch.int32)
    rc, xc = torch.empty(3, dtype=torch.float64), torch.ones(3).double()
    multigrid_cuda.bind_restrict(rc, xc, r, axf, f2c)()
    assert torch.equal(rc, r[[0, 3, 7]] - axf[[0, 3, 7]])
    assert torch.equal(xc, torch.zeros(3, dtype=torch.float64))
    x = _uniform(10, torch.float64, 62)
    want = x.clone()
    want[[0, 3, 7]] += rc
    multigrid_cuda.bind_prolong(x, rc, f2c)()
    assert torch.equal(x, want)
    # a colour step over rows 0, 3 and 7 (a gathered copy, all columns)
    sub = CsrMatrix(3, 10, np.array([0, 2, 3, 6]),
                    np.array([0, 5, 3, 1, 7, 9]),
                    np.array([26.0, -1.0, 26.0, -1.0, 26.0, -1.0]))
    colour = build_operator(sub, dtype="float64", device="cpu")
    diag = torch.full((3,), 26.0, dtype=torch.float64)
    want = x.clone()
    want[[0, 3, 7]] += (r[[0, 3, 7]] - colour(x)) / diag
    multigrid_cuda.bind_colour_step(x, r, colour, f2c, diag)()
    assert torch.equal(x, want)
    with pytest.raises(ValueError, match="op must be 3 x 9"):
        multigrid_cuda.bind_colour_step(x[:9], r[:9], colour, f2c, diag)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dims", GRIDS)
def test_bound_colour_step_on_the_cpu_is_the_two_step_plain_route(dims,
                                                                   dtype):
    """On CPU tensors a colour step's launcher is the colour operator's
    product, then symgs_update_plain: their bits, at every level and
    colour."""
    op, _ = _mg(dims, dtype)
    for lv, level in enumerate(op.levels):
        n = level.op.shape[0]
        r = _uniform(n, dtype, 80 + lv)
        for c, colour in enumerate(level.colours):
            if colour is None:      # a coarse grid of side 1
                continue
            x = _uniform(n, dtype, 90 + 8 * lv + c)
            got, want = x.clone(), x.clone()
            multigrid_cuda.bind_colour_step(got, r, colour.op, colour.rows,
                                            colour.diag)()
            multigrid_cuda.symgs_update_plain(want, r, colour.op(x),
                                              colour.rows, colour.diag)
            assert torch.equal(got, want), (lv, c)


def test_a_sweep_is_one_colour_launcher_a_colour():
    """A level's bound sweep: one launcher, of kind "colour", for each of
    the forward and backward passes' colours that the level has, in their
    order (8 x 4 x 4 and coarser levels of 16 x 8 x 8 lack some)."""
    op, _ = _mg((16, 8, 8), torch.float64)
    for lv, level in enumerate(op.levels):
        work = op._bound[lv]
        order = [c for c in MG.FORWARD + MG.BACKWARD
                 if level.colours[c] is not None]
        assert len(order) == (16 if lv < 3 else 4)
        assert [kind for _, kind in work.sweep] == ["colour"] * len(order)
        assert [launch for launch, _ in work.sweep] == [
            work.colours[c] for c in order]


def test_spans_mark_each_vcycle_and_its_levels():
    """Under the profiler: a precondition span a V-cycle the host
    enqueues (the prologue's and one a step), each holding one span of
    level 0, which holds level 1's, and so on; the build's span."""
    csr = MG.stencil27(8, 8, 8)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        op = build_multigrid(csr, dtype="float64", device="cpu")
        S.conjugate_gradient(op, torch.ones(csr.num_rows).double(),
                             tol=0.0, maxiter=1, check_every=1,
                             preconditioner="multigrid", graph=False)
    spans = [(e.name, e.time_range.start, e.time_range.end)
             for e in prof.events() if e.name.startswith("merge_spmv.")]

    def named(name):
        return [s for s in spans if s[0] == name]

    def inside(inner, outer):
        return outer[1] <= inner[1] and inner[2] <= outer[2]

    assert len(named(T.BUILD_MULTIGRID)) == 2
    cycles = named(T.PRECONDITION)
    assert len(cycles) == 2
    for lv, name in enumerate(T.MG_LEVELS):
        assert len(named(name)) == 2
        outer = cycles if lv == 0 else named(T.MG_LEVELS[lv - 1])
        assert all(any(inside(s, o) for o in outer) for s in named(name))


# ---------------------------------------------------------------------- #
# On the card
# ---------------------------------------------------------------------- #

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc to build the kernels)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_card_pcg_graph_equals_eager_and_takes_the_kernels(card, dtype):
    """PCG on the card: the graph path's x, residual and count bit-equal
    the eager path's, the same again on a second call; the colour steps
    (one launch each, no colour product or update apart), residuals,
    restrictions and prolongations of every level, and the fused PCG
    kernels, were launched."""
    from merge_spmv_tpu_torch.ops import csrmv_cuda
    op = _mg((32, 32, 16), dtype, card)[0]
    b = _uniform(op.shape[0], dtype, 70).to(card)
    MG.reset_launches()
    multigrid_cuda.reset_launches()
    cg_cuda.reset_launches()
    runs = [S.conjugate_gradient(op, b, tol=0.0, maxiter=50, check_every=16,
                                 preconditioner="multigrid", graph=g)
            for g in (False, True, True)]
    torch.cuda.synchronize()
    x0, i0 = runs[0]
    for x, info in runs[1:]:
        assert int(info.iterations) == int(i0.iterations) == 50
        assert torch.equal(x, x0) and torch.equal(info.residual, i0.residual)
    assert runs[1][1].step_ms is not None
    for lv in range(3):
        for kind in ("colour", "residual", "restrict", "prolong"):
            assert MG.LAUNCHES[(lv, kind)] > 0, (lv, kind)
    assert MG.LAUNCHES[(3, "colour")] > 0
    for lv in range(4):     # the colour step is one launch: no K1 product
        for kind in ("product", "update"):
            assert MG.LAUNCHES.get((lv, kind), 0) == 0, (lv, kind)
    assert MG.LAUNCHES[(0, "colour")] == multigrid_cuda.LAUNCHES[
        "symgs_colour"] - sum(MG.LAUNCHES[(lv, "colour")] for lv in (1, 2, 3))
    assert min(cg_cuda.PCG_LAUNCHES.values()) > 0
    assert csrmv_cuda.LAUNCHES["merge_tile_fused"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_card_segments_are_graphs_that_equal_their_launchers(card, dtype):
    """On the card every level's segments are CUDA graphs, and a V-cycle
    through them (precondition) gives the bits of the same launchers run
    one by one; the graphs leave the kernels' counters to the segments."""
    op = _mg((32, 32, 16), dtype, card)[0]
    assert all(work.pre.graph is not None and
               (work.post is None or work.post.graph is not None)
               for work in op._bound)
    r = _uniform(op.shape[0], dtype, 74).to(card)
    multigrid_cuda.reset_launches()
    z = op.precondition(r, torch.empty_like(r))
    assert multigrid_cuda.LAUNCHES["mg_restrict"] == len(op.levels) - 1

    def one_by_one(lv):
        work = op._bound[lv]
        for launch, _ in work.pre.steps:
            launch()
        if work.post is not None:
            one_by_one(lv + 1)
            for launch, _ in work.post.steps:
                launch()
    op.levels[0].r.copy_(r)
    op.levels[0].x.fill_(float("nan"))
    one_by_one(0)
    torch.cuda.synchronize()
    assert torch.equal(op.levels[0].x, z)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_card_bound_product_is_the_call_bit_for_bit(card, dtype):
    """SpmvOperator.bind on the card: each launch, on the current stream
    or a given one, writes op(x)'s bits for what x holds then."""
    op = _mg((32, 32, 16), dtype, card)[0]
    colour = op.levels[0].colours[3].op
    x = _uniform(op.shape[0], dtype, 73).to(card)
    launch, y = colour.bind(x)
    launch()
    torch.cuda.synchronize()
    assert torch.equal(y, colour(x))
    x.mul_(-0.5)
    launch(torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert torch.equal(y, colour(x))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_card_vcycle_and_pcg_match_the_cpu_and_the_reference(card, dtype):
    """The V-cycle on the card against the same V-cycle on the CPU (plain
    versions) and the reference; PCG at 3 iterations against the
    reference; tolerances as on the CPU."""
    dims = (32, 32, 16)
    op = _mg(dims, dtype, card)[0]
    cpu, ref = _mg(dims, dtype)
    r = _uniform(op.shape[0], dtype, 71)
    z = op.precondition(r.to(card), torch.empty_like(r, device=card))
    want = R.vcycle(ref, r)
    assert _close(z, cpu.precondition(r, torch.empty_like(r)), 2 ** 10,
                  dtype)
    assert _close(z, want, 2 ** 10, dtype)
    x, info = S.conjugate_gradient(op, r.to(card), tol=0.0, maxiter=3,
                                   preconditioner="multigrid")
    x_ref, _, _ = R.pcg(dims, r, 3, dtype, ref)
    assert int(info.iterations) == 3
    assert _close(x, x_ref, 2 ** 10, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_card_unpreconditioned_cg_keeps_four_launches_a_step(card, dtype):
    """Without a preconditioner a CG step on the card is still K1 and the
    three CG kernels: 4 launches a step, none of PCG's or the V-cycle's."""
    from merge_spmv_tpu_torch.ops import csrmv_cuda
    op = _mg((32, 32, 16), dtype, card)[0]
    b = _uniform(op.shape[0], dtype, 72).to(card)
    S.conjugate_gradient(op, b, tol=0.0, maxiter=5, graph=False)
    MG.reset_launches()
    multigrid_cuda.reset_launches()
    cg_cuda.reset_launches()
    csrmv_cuda.reset_launches()
    _, info = S.conjugate_gradient(op, b, tol=0.0, maxiter=32,
                                   check_every=16, graph=False)
    torch.cuda.synchronize()
    steps = info.host_reads * 16
    launched = csrmv_cuda.LAUNCHES["merge_tile_fused"] - 1 + sum(
        cg_cuda.LAUNCHES.values())
    assert launched == 4 * steps
    assert set(cg_cuda.PCG_LAUNCHES.values()) == {0}
    assert MG.LAUNCHES == {} and set(multigrid_cuda.LAUNCHES.values()) == {0}


def _colour_scale(colour, x, r):
    """(|A_c| |x| + |r|)_i / a_ii over the colour's rows, in float64."""
    sub = colour.op
    lengths = torch.diff(sub.row_end_offsets.long(),
                         prepend=sub.row_end_offsets.new_zeros(1).long())
    of = torch.repeat_interleave(
        torch.arange(lengths.numel(), device=x.device), lengths)
    ax = torch.zeros(lengths.numel(), dtype=torch.float64,
                     device=x.device).index_add_(
        0, of, (sub.values.abs() * x[sub.col_indices.long()].abs()).double())
    return (ax + r[colour.rows.long()].abs().double()) / \
        colour.diag.abs().double()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_card_colour_step_is_its_plain_route_within_its_bound(card, dtype):
    """Every level's every colour: one launch of the colour step against
    the plain two-step route (the colour operator's K1 product, then
    symgs_update_plain) on the same x and r, each row of x within
    COLOUR_ULPS unit roundoffs of (|A_c| |x| + |r|)_i / a_ii; x unchanged
    off the colour's rows."""
    op = _mg((32, 32, 16), dtype, card)[0]
    worst = 0.0
    for lv, level in enumerate(op.levels):
        n = level.op.shape[0]
        r = _uniform(n, dtype, 100 + lv).to(card)
        for c, colour in enumerate(level.colours):
            x = _uniform(n, dtype, 110 + 8 * lv + c).to(card)
            got, want = x.clone(), x.clone()
            multigrid_cuda.bind_colour_step(got, r, colour.op, colour.rows,
                                            colour.diag)()
            multigrid_cuda.symgs_update_plain(want, r, colour.op(x),
                                              colour.rows, colour.diag)
            rows = colour.rows.long()
            off = torch.ones(n, dtype=torch.bool, device=card)
            off[rows] = False
            assert torch.equal(got[off], x[off]), (lv, c)
            diff = (got[rows] - want[rows]).abs().double()
            ulps = diff / (_unit(dtype) * _colour_scale(colour, x, r))
            worst = max(worst, float(ulps.max()))
            assert float(ulps.max()) <= COLOUR_ULPS, (lv, c, float(ulps.max()))
    assert worst > 0.0 or dtype == torch.float64     # orders do differ


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_card_two_vcycles_from_one_r_give_the_same_bits(card, dtype):
    op = _mg((32, 32, 16), dtype, card)[0]
    r = _uniform(op.shape[0], dtype, 120).to(card)
    z1 = op.precondition(r, torch.empty_like(r)).clone()
    z2 = op.precondition(r, torch.empty_like(r))
    torch.cuda.synchronize()
    assert torch.equal(z1, z2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_card_vcycle_counts_one_launch_a_colour_step(card, dtype):
    """A V-cycle on the 4 levels of 32 x 32 x 16, each with 8 colours:
    112 colour steps (32 on levels 0-2, 16 on level 3), each one
    symgs_update launch; no colour product or update apart; 3 K1
    launches, the residual products."""
    from merge_spmv_tpu_torch.ops import csrmv_cuda
    op = _mg((32, 32, 16), dtype, card)[0]
    r = _uniform(op.shape[0], dtype, 121).to(card)
    MG.reset_launches()
    multigrid_cuda.reset_launches()
    csrmv_cuda.reset_launches()
    op.precondition(r, torch.empty_like(r))
    torch.cuda.synchronize()
    assert {lv: MG.LAUNCHES[(lv, "colour")] for lv in range(4)} == {
        0: 32, 1: 32, 2: 32, 3: 16}
    assert not any(kind in ("product", "update") for _, kind in MG.LAUNCHES)
    assert multigrid_cuda.LAUNCHES == {"symgs_colour": 112, "mg_restrict": 3,
                                       "mg_prolong": 3}
    assert {lv: MG.LAUNCHES[(lv, "residual")] for lv in range(3)} == {
        0: 1, 1: 1, 2: 1}
    assert csrmv_cuda.LAUNCHES["merge_tile_fused"] == 3
