"""The two HPCG cells added with the program's multigrid preconditioner,
at a tiny size on the CPU: whole runs of ``hpcg_104_mg.pcg`` and
``hpcg_104.spmv``; the benchmark's reference V-cycle
(``reference_hpcg.py``) against a dense NumPy one; the control (the
reference in float32 in the program's place) and four faults planted in
the program's V-cycle, each of which must come out not correct under the
committed limits; the byte models and the device-order readers of
``roofline_mg.py``."""

import itertools
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from spmv_bench import control, reference_hpcg, roofline_mg, run, system
from spmv_bench.generators import stencil27

SEED = 2 ** 31 + 2626


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The V-cycle is thousands of small torch ops: one intra-op thread,
    so that idle threads spinning after an op do not compete with them on
    a loaded CPU (the setting is restored after)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
GRID = {"nx": 16, "ny": 8, "nz": 8, "diagonal": 26.0, "off_diagonal": -1.0}


def levels_of(params: dict, count: int = 4) -> list:
    """HPCG's levels over the grid of ``params``, fine first."""
    dims = [params[k] for k in ("nx", "ny", "nz")]
    return [[d >> lv for d in dims] for lv in range(count)]


MG = {"generator": "stencil27", "dtype": "float64",
      "entry": "build_multigrid", "params": GRID, "levels": levels_of(GRID)}
STENCIL = dict(MG, entry="build_operator")


def pcg_traffic(**change):
    traffic = run.find_cell(run.load_benchmark(), "hpcg_104_mg.pcg")[2]
    traffic.update(solver_args=dict(traffic["solver_args"], maxiter=6,
                                    check_every=4),
                   warm_sets=1, sample_below=4, **change)
    return traffic


def tiny_pcg(sut, trace=False):
    traffic = pcg_traffic(**({"trace_after_s": 0.0, "trace_sets": 1}
                             if trace else {}))
    return run.run_cell("hpcg_104_mg.pcg", SEED, 0.3, trace, "cpu", sut,
                        time.perf_counter(), config=MG, traffic=traffic)


def test_sound_pcg_run_is_correct():
    result = tiny_pcg(system.Program())
    assert result["correct"] and result["failed"] == 0
    assert set(result["checks"]) == {"solution_err", "precond_err",
                                     "iteration_gap"}
    assert result["checks"]["precond_err"]["value"] < 1e-12
    assert set(result["metrics"]) == {"solve_p50_ms", "setup_s"}


def test_traced_pcg_run_reads_the_program_spans():
    result = tiny_pcg(system.Program(), trace=True)
    assert result["correct"]
    metrics = result["metrics"]
    assert metrics["setup_multigrid_s"]["value"] > 0
    assert metrics["mg_vcycle_host_us.pcg"]["value"] > 0
    # the fine operator's set-up and the solver's generic readers
    assert {"setup_plan_s", "setup_prepare_s", "cg_flag_read_ms.pcg",
            "cg_eager_ms.pcg"} <= set(metrics)


@pytest.mark.parametrize("trace", [False, True])
def test_sound_stencil_spmv_run_is_correct(trace):
    traffic = run.find_cell(run.load_benchmark(), "hpcg_104.spmv")[2]
    if trace:
        traffic.update(trace_after_s=0.0, trace_calls=4)
    result = run.run_cell("hpcg_104.spmv", SEED, 0.3, trace, "cpu",
                          system.Program(), time.perf_counter(),
                          config=STENCIL, traffic=traffic)
    assert result["correct"] and result["attempted"] >= 1
    assert set(result["checks"]) == {"product_err"}
    if trace:
        assert {"setup_plan_s", "setup_prepare_s"} <= set(result["metrics"])
    else:
        assert set(result["metrics"]) == {"spmv_gflops", "setup_s"}


class PcgControl(control.Control):
    """The control for PCG: the benchmark's reference, in the next
    precision below the configuration's, in the program's place."""

    def solve(self, solver, op, b, tol=0.0, maxiter=50, **_):
        levels = reference_hpcg.hierarchy(op.csr, MG, op.lower)
        iterates = reference_hpcg.pcg(levels, b, maxiter, op.lower)
        return iterates[-1], len(iterates), 0, None


def test_control_is_not_correct():
    result = tiny_pcg(PcgControl())
    assert not result["correct"]
    assert result["checks"]["precond_err"]["value"] > 1e-8


def _vcycle_without_post_smoothing(self, lv, stream):
    work = self._bound[lv]
    work.pre.run(stream)
    if work.post is None:
        return
    self._vcycle(lv + 1, stream)
    prolong, _ = work.post.steps[0]     # the prolongation, no sweep after
    prolong(stream)


class Float32Program(system.Program):
    """The program built and solving in float32 under a float64
    configuration."""

    def build(self, host_csr, config, device):
        return super().build(host_csr, dict(config, dtype="float32"), device)

    def solve(self, solver, op, b, **kwargs):
        return super().solve(solver, op, b.float(), **kwargs)


@pytest.mark.parametrize("fault", ["no post-smoothing",
                                   "backward sweep in forward order",
                                   "no prolongation", "float32"])
def test_each_planted_fault_is_not_correct(fault, monkeypatch):
    from merge_spmv_tpu_torch.models import multigrid, multigrid_cuda
    sut = system.Program()
    if fault == "no post-smoothing":
        monkeypatch.setattr(multigrid.MultigridOperator, "_vcycle",
                            _vcycle_without_post_smoothing)
    elif fault == "backward sweep in forward order":
        monkeypatch.setattr(multigrid, "BACKWARD", multigrid.FORWARD)
    elif fault == "no prolongation":
        monkeypatch.setattr(multigrid_cuda, "bind_prolong",
                            lambda x, xc, f2c: (lambda stream=None: None))
    else:
        sut = Float32Program()
    result = tiny_pcg(sut)
    assert not result["correct"], (fault, result["checks"])


# ---------------------------------------------------------------------- #
# The reference against a dense V-cycle
# ---------------------------------------------------------------------- #

def _dense_level(dims):
    csr = stencil27.generate(dict(GRID, nx=dims[0], ny=dims[1],
                                  nz=dims[2]), 0, "cpu")
    n = csr["num_rows"]
    a = np.zeros((n, n))
    rows = np.repeat(np.arange(n), np.diff(csr["row_offsets"].numpy()))
    a[rows, csr["col_indices"].numpy()] = csr["values"].numpy()
    return a


def _dense_vcycle(dims, r, lv=0, levels=4):
    """HPCG's V-cycle written out densely: colour by colour (7 to 0, then
    0 to 7), each row of a colour updated from the x the colour started
    with."""
    nx, ny, nz = dims
    a = _dense_level(dims)
    idx = np.arange(nx * ny * nz)
    colour = idx % nx % 2 + 2 * (idx // nx % ny % 2) + \
        4 * (idx // (nx * ny) % 2)

    def sweep(x):
        for c in itertools.chain(reversed(range(8)), range(8)):
            rows = np.flatnonzero(colour == c)
            x[rows] = x[rows] + (r[rows] - a[rows] @ x) / np.diag(a)[rows]
        return x

    x = sweep(np.zeros(len(r)))
    if lv + 1 < levels:
        cx, cy, cz = nx // 2, ny // 2, nz // 2
        i = np.arange(cx * cy * cz)
        f2c = 2 * (i // (cx * cy)) * ny * nx + 2 * (i // cx % cy) * nx + \
            2 * (i % cx)
        rc = r[f2c] - (a @ x)[f2c]
        x[f2c] += _dense_vcycle((cx, cy, cz), rc, lv + 1, levels)
        x = sweep(x)
    return x


def test_reference_vcycle_equals_a_dense_one():
    params = dict(GRID, nx=8, ny=8, nz=8)
    csr = stencil27.generate(params, 0, "cpu")
    levels = reference_hpcg.hierarchy(
        csr, {"params": params, "levels": levels_of(params)})
    r = torch.from_numpy(np.random.RandomState(3).uniform(-1, 1, 512))
    got = reference_hpcg.vcycle(levels, r, torch.float64)
    want = _dense_vcycle((8, 8, 8), r.numpy())
    assert np.abs(got.numpy() - want).max() <= 1e-13 * np.abs(want).max()


def test_reference_pcg_iterates_solve_the_system():
    params = dict(GRID, nx=8, ny=8, nz=8)
    csr = stencil27.generate(params, 0, "cpu")
    levels = reference_hpcg.hierarchy(
        csr, {"params": params, "levels": levels_of(params)})
    b = torch.from_numpy(np.random.RandomState(4).uniform(-1, 1, 512))
    iterates = reference_hpcg.pcg(levels, b, 12)
    a = _dense_level((8, 8, 8))
    res = [np.linalg.norm(b.numpy() - a @ x.numpy()) for x in iterates]
    assert len(iterates) == 12 and res[-1] < 1e-10 * res[0]


# ---------------------------------------------------------------------- #
# The byte models and the readers' device order
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("dims", [(8, 8, 8), (16, 8, 8), (13, 13, 13)])
def test_colour_counts_add_up_to_the_stencil(dims):
    csr = stencil27.generate(dict(GRID, nx=dims[0], ny=dims[1],
                                  nz=dims[2]), 0, "cpu")
    counts = [roofline_mg.colour_counts(dims, c) for c in range(8)]
    assert sum(c[0] for c in counts) == csr["num_rows"]
    assert sum(c[1] for c in counts) == csr["values"].numel()
    nx, ny, _ = dims
    idx = torch.arange(csr["num_rows"])
    colour = idx % nx % 2 + 2 * (idx // nx % ny % 2) + \
        4 * (idx // (nx * ny) % 2)
    lengths = csr["row_offsets"][1:] - csr["row_offsets"][:-1]
    of = torch.repeat_interleave(colour, lengths)
    for c, (_, _, cols) in enumerate(counts):
        assert cols == csr["col_indices"][of == c].unique().numel()


@pytest.mark.parametrize("levels", [
    [[16, 8, 8], [8, 4, 4], [4, 2, 2], [3, 1, 1]],   # not a half
    [[8, 8, 8], [4, 4, 4]],                          # not the grid
    [[16, 8, 8], [8, 4, 4], [4, 2, 2], [2, 1, 1], [1, 0, 0]],  # odd
    []])
def test_reference_refuses_levels_that_do_not_halve_the_grid(levels):
    with pytest.raises(ValueError, match="halved"):
        reference_hpcg.grids({"params": GRID, "levels": levels})


def test_byte_models_take_the_configured_levels():
    three = dict(MG, levels=levels_of(GRID, 3))
    assert len(roofline_mg.level_dims(MG)) == 4
    assert roofline_mg.restrict_bytes(three, "float64") < \
        roofline_mg.restrict_bytes(MG, "float64")
    # level 2 is the coarsest of three: its colours visited twice
    assert roofline_mg.symgs_bytes(three, "float64") < \
        roofline_mg.symgs_bytes(MG, "float64")


def _trace(names):
    """A Trace of back-to-back activities of 1 ms each."""
    from spmv_bench.trace import Trace
    return Trace(start=0.0, end=len(names) * 1e-3,
                 device=[(n, i * 1e-3, (i + 1) * 1e-3)
                         for i, n in enumerate(names)])


def test_device_order_places_the_vcycle_kernels():
    k1, up = roofline_mg.PRODUCT, roofline_mg.UPDATE
    rs, pr = roofline_mg.RESTRICT, roofline_mg.PROLONG
    # level 0: a colour step, the residual, restrict; level 1: a colour
    # step, the residual, restrict; level 2: a colour step; back up
    names = ["fill", k1, up, k1, rs, k1, up, k1, rs, k1, up, pr, k1, up,
             pr, k1, up, k1, "cg_pap"]
    trace = _trace(names)
    assert roofline_mg.colour_step_seconds(trace) == pytest.approx(10e-3)
    fine, coarse = roofline_mg.vcycle_split(trace)
    assert coarse == pytest.approx(9e-3)   # from level 1's k1 to its pr
    assert fine == pytest.approx(7e-3)     # the fill and CG's k1 not counted


def test_roofline_shares_read_nothing_without_the_kernels():
    run_ = SimpleNamespace(trace=_trace(["merge_tile_kernel"] * 3),
                           loop=SimpleNamespace(traced_vcycles=0),
                           cell=SimpleNamespace(config=MG,
                                                problem={"dtype":
                                                         "float64"}),
                           device_name="NVIDIA H100 80GB HBM3",
                           spans={})
    for name in ("symgs_roofline.pcg", "mg_restrict_roofline.pcg",
                 "mg_prolong_roofline.pcg", "mg_coarse_pct.pcg",
                 "mg_vcycle_host_us.pcg", "setup_multigrid_s"):
        assert run.reader(name).read(run_) is None, name
