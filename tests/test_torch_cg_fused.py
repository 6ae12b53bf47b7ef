"""CG's fused step (merge_spmv_tpu_torch/models/cg_cuda.py) on the CPU:
which solves take it, the wrapper's operand checks, the grid, and the
torch step that every other solve keeps, bit for bit.  The kernels
themselves run only on the card (tests/test_torch_cuda.py)."""

import re

import numpy as np
import pytest
import torch

from merge_spmv_tpu_torch.formats.coo import CooMatrix
from merge_spmv_tpu_torch.formats.csr import CsrMatrix
from merge_spmv_tpu_torch.models import cg_cuda
from merge_spmv_tpu_torch.models import solvers as TS
from merge_spmv_tpu_torch.ops.dia import build_dia_operator
from merge_spmv_tpu_torch.ops.operator import build_operator
from merge_spmv_tpu_torch.utils import cuda_build
from merge_spmv_tpu_torch.utils.cuda_build import CSRC_DIR


def _laplacian(width=8, dtype=np.float32):
    """L = D - A + I of the width x width grid."""
    coo = CooMatrix.grid2d(width)
    n = coo.num_rows
    deg = np.bincount(coo.rows, minlength=n).astype(np.float64)
    rows = np.r_[coo.rows, np.arange(n)]
    cols = np.r_[coo.cols, np.arange(n)]
    vals = np.r_[-np.ones(coo.rows.size), deg + 1.0]
    return CsrMatrix.from_coo(CooMatrix(n, n, rows, cols, vals)).astype(
        dtype)


def _torch_cg(op, b, tol, maxiter):
    """The torch step as it stands in conjugate_gradient, one iteration at
    a time and no block: the CPU path's bits."""
    b = torch.as_tensor(b)
    x = torch.zeros_like(b)
    r = b - op(x)
    p = r.clone()
    rs = torch.sum(r * r)
    tol2 = torch.tensor(tol, dtype=b.dtype) ** 2 * torch.sum(b * b)
    k = torch.zeros((), dtype=torch.int32)
    while bool((rs > tol2) & (k < maxiter)):
        ap = op(p)
        alpha = rs / torch.sum(p * ap)
        x = x + alpha * p
        r_n = r - alpha * ap
        rs_n = torch.sum(r_n * r_n)
        p = r_n + (rs_n / rs) * p
        r, rs = r_n, rs_n
        k += 1
    return x, k, rs


@pytest.fixture
def no_fused(monkeypatch):
    """The fused step raises if anything constructs it."""
    def refuse(*args, **kwargs):
        raise AssertionError("the fused CG step was reached")
    monkeypatch.setattr(cg_cuda, "FusedCgStep", refuse)


@pytest.mark.parametrize("device,dtype,want", [
    ("cuda", torch.float32, True),
    ("cuda", torch.float64, True),
    ("cuda:1", torch.float64, True),
    ("cuda", torch.bfloat16, False),
    ("cuda", torch.float16, False),
    ("cpu", torch.float32, False),
    ("cpu", torch.float64, False),
])
def test_which_steps_are_fused(device, dtype, want):
    assert cg_cuda.takes(torch.device(device), dtype) is want


@pytest.mark.parametrize("kind", ["merge", "dia"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_cpu_cg_keeps_the_torch_step_bit_for_bit(no_fused, kind, dtype):
    """On the CPU conjugate_gradient never reaches the fused step, and its
    result is the torch step's, bit for bit, whatever the block size."""
    lap = _laplacian(dtype=dtype)
    build = build_operator if kind == "merge" else build_dia_operator
    op = build(lap, dtype=np.dtype(dtype).name, device="cpu")
    b = np.random.RandomState(3).uniform(-1, 1, lap.num_rows).astype(dtype)
    x_want, k_want, rs_want = _torch_cg(op, b, 1e-6, 200)
    for every in (1, 16):
        x, info = TS.conjugate_gradient(op, b, tol=1e-6, maxiter=200,
                                        check_every=every)
        assert int(info.iterations) == int(k_want) > 3
        assert torch.equal(x, x_want)
        assert torch.equal(info.residual, torch.sqrt(rs_want))


def test_other_solvers_on_the_cpu_never_reach_it(no_fused):
    lap = _laplacian()
    op = build_operator(lap, device="cpu")
    b = np.random.RandomState(4).uniform(-1, 1, lap.num_rows).astype(
        np.float32)
    diag = torch.from_numpy(np.full(lap.num_rows, 5.0, np.float32))
    assert int(TS.bicgstab(op, b, tol=1e-6, maxiter=50)[1].iterations) > 0
    assert int(TS.jacobi(op, diag, b, tol=1e-6, maxiter=50)[1].iterations) > 0
    assert int(TS.power_iteration(op, v0=b, maxiter=20)[2].iterations) > 0
    assert int(TS.pagerank(op, maxiter=20)[1].iterations) > 0


def test_no_library_is_loaded_by_import_or_cpu_solves():
    lap = _laplacian()
    op = build_operator(lap, device="cpu")
    TS.conjugate_gradient(op, np.ones(lap.num_rows, np.float32), maxiter=5)
    assert cg_cuda.KERNEL_SOURCE not in cuda_build._LOADED
    assert cg_cuda.LAUNCHES == {"cg_pap": 0, "cg_update": 0,
                                "cg_direction": 0}


def _state(n=40, dtype=torch.float32):
    x, r, p = (torch.zeros(n, dtype=dtype) for _ in range(3))
    rs = torch.ones((), dtype=dtype)
    tol2 = torch.zeros((), dtype=dtype)
    k = torch.zeros((), dtype=torch.int32)
    return {"x": x, "r": r, "p": p, "rs": rs, "tol2": tol2, "k": k}


@pytest.mark.parametrize("fault,error,match", [
    ("x float16", TypeError, "float32 or float64"),
    ("r float64", TypeError, "r must be"),
    ("rs float64", TypeError, "rs must be"),
    ("k int64", TypeError, "k must be"),
    ("p shorter", ValueError, "p must have shape"),
    ("tol2 not 0-dim", ValueError, "tol2 must have shape"),
    ("x 2-dim", ValueError, "x must have shape"),
    ("r strided", ValueError, "r must be contiguous"),
    ("on the cpu", ValueError, "CUDA device"),
    ("on the meta device", ValueError, "unsupported device"),
    ("on two devices", ValueError, "several devices"),
])
def test_wrapper_refuses_what_the_kernels_do_not_take(fault, error, match):
    s = _state()
    if fault == "x float16":
        s = {k: v.half() if v.is_floating_point() else v
             for k, v in s.items()}
    elif fault == "r float64":
        s["r"] = s["r"].double()
    elif fault == "rs float64":
        s["rs"] = s["rs"].double()
    elif fault == "k int64":
        s["k"] = s["k"].long()
    elif fault == "p shorter":
        s["p"] = s["p"][:-1].clone()
    elif fault == "tol2 not 0-dim":
        s["tol2"] = s["tol2"].reshape(1)
    elif fault == "x 2-dim":
        s["x"] = s["x"].reshape(8, 5)
    elif fault == "r strided":
        s["r"] = torch.zeros(80)[::2]
    elif fault == "on the meta device":
        s = {k: v.to("meta") for k, v in s.items()}
    elif fault == "on two devices":
        s["k"] = s["k"].to("meta")
    with pytest.raises(error, match=match):
        cg_cuda.FusedCgStep(maxiter=10, **s)


@pytest.mark.parametrize("n,want", [
    (0, 1), (1, 1), (256, 1), (257, 2), (1000, 4),
    (256 * 1024, 1024), (1124864, 1024), (2 ** 40, 1024),
])
def test_grid_depends_on_n_alone(n, want):
    assert cg_cuda.grid_blocks(n) == want


def test_the_wrapper_and_the_source_agree_on_the_grid():
    text = (CSRC_DIR / f"{cg_cuda.KERNEL_SOURCE}.cu").read_text()
    figure = {name: int(value) for name, value in re.findall(
        r"constexpr int (k\w+) = (\d+);", text)}
    assert figure["kThreads"] == cg_cuda.THREADS
    assert figure["kMaxBlocks"] == cg_cuda.MAX_BLOCKS
    assert figure["kPartials"] == cg_cuda.HEAD
