"""The port's benchmark driver and CLI, held against the JAX package's
(tests/test_cli.py) with ``--cpu``: the kernels' plain versions.

The two cases of tests/test_cli.py that check the TPU plan's route choice
(``:78`` merge resolving through ``backend="auto"``, ``:100`` fp64 routing
to ``pallas_ds``) have no counterpart: the port's plan has one route per
device.  In their place: the argument parser gives the dict
``spmv_cli.parse_args`` gives, ``build_matrix`` gives the JAX driver's CSR
arrays for every generator, and every backend verifies with the alpha/beta
epilogue.
"""

import contextlib
import io
import os
import tempfile

import numpy as np
import pytest

import spmv_cli
from merge_spmv_tpu.bench.driver import build_matrix as jbuild_matrix
from merge_spmv_tpu_torch import cli
from merge_spmv_tpu_torch.bench.driver import build_matrix, run_benchmark
from merge_spmv_tpu_torch.formats.coo import CooMatrix


def _run(args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        results = run_benchmark(dict(args, device="cpu"))
    return results, out.getvalue()


def test_driver_grid2d_quiet_csv():
    results, text = _run({"grid2d": 30, "fp32": True, "quiet": True,
                          "backends": ["scipy", "xla"], "i": 5})
    assert "scipy" in results and "xla" in results
    assert results["xla"]["verified"]
    # CSV fragments: stats then per-backend numbers, comma separated
    assert text.count(",") > 10 and "PASS" not in text


def test_driver_rectangular_matrix():
    coo = CooMatrix.random_powerlaw(150, 120, 900, seed=3)
    with tempfile.NamedTemporaryFile(suffix=".mtx", delete=False) as f:
        path = f.name
    coo.to_market(path)
    try:
        results, _ = _run({"mtx": path, "fp32": True, "quiet": True,
                           "backends": ["xla", "merge", "dia"], "i": 5})
    finally:
        os.unlink(path)
    for backend in ("xla", "merge", "dia"):
        assert results[backend]["verified"], backend
        assert results[backend]["avg_ms"] > 0


def test_driver_wheel_verbose():
    results, text = _run({"wheel": 200, "fp32": True,
                          "backends": ["scipy"], "i": 5})
    assert "PASS" in text and "gflops" in text
    assert "device: cpu" in text
    assert results["scipy"]["verified"]


@pytest.mark.parametrize("argv", [
    ["--grid3d=12", "--fp64", "--backends=xla,merge", "--alpha=2.5",
     "--beta=-0.5", "--quiet"],
    ["--mtx=a.mtx", "--tile-items=1024", "--gather-group=4",
     "--gather-cluster", "--autotune", "--split=3", "--i=7", "--seed=2"],
    ["--wheel=100", "--i", "--v", "--v2", "--backends=dia"],
])
def test_cli_arg_parsing_matches_spmv_cli(argv):
    want = spmv_cli.parse_args(["prog", *argv])
    assert cli.parse_args(["prog", *argv]) == want
    got = cli.parse_args(["prog", *argv, "--cpu"])
    assert got.pop("device") == "cpu"
    assert got == want


def test_cli_arg_parsing():
    args = cli.parse_args(["prog", "--grid3d=12", "--fp64",
                           "--backends=xla,merge", "--alpha=2.5",
                           "--beta=-0.5", "--quiet", "--cpu"])
    assert args["grid3d"] == 12 and args["fp32"] is False
    assert args["backends"] == ["xla", "merge"]
    assert args["alpha"] == 2.5 and args["beta"] == -0.5
    assert args["quiet"] is True and args["device"] == "cpu"
    assert "cpu" not in args


@pytest.mark.parametrize("args", [
    {"grid2d": 12}, {"grid3d": 5}, {"wheel": 40}, {"dense": 1 << 18},
    {"powerlaw": 300, "seed": 4}, {"uniform": 200, "seed": 1},
], ids=["grid2d", "grid3d", "wheel", "dense", "powerlaw", "uniform"])
def test_build_matrix_matches_jax(args):
    with contextlib.redirect_stdout(io.StringIO()):
        j, t = jbuild_matrix(dict(args)), build_matrix(dict(args))
    assert (t.num_rows, t.num_cols) == (j.num_rows, j.num_cols)
    np.testing.assert_array_equal(t.row_offsets, j.row_offsets)
    np.testing.assert_array_equal(t.col_indices, j.col_indices)
    np.testing.assert_array_equal(t.values, j.values)


@pytest.mark.parametrize("fp32", [True, False], ids=["fp32", "fp64"])
def test_driver_beta_epilogue(fp32):
    # --alpha/--beta drive y = alpha*A*x + beta*y_in end to end through
    # every backend the port has
    backends = ["scipy", "torch", "xla", "merge", "dia"]
    results, _ = _run({"grid2d": 20, "fp32": fp32, "quiet": True,
                       "backends": backends, "i": 3, "alpha": 1.5,
                       "beta": -0.5})
    for backend in backends:
        assert results[backend]["verified"], backend


def test_cli_main_runs_dia_and_merge(capsys):
    assert cli.main(["prog", "--grid2d=24", "--cpu", "--i=2",
                     "--backends=merge,dia"]) == 0
    text = capsys.readouterr().out
    assert text.count("PASS") == 2 and "DiaSpmvOperator(4 diagonals" in text


def test_cli_dia_backend_runs():
    """--backends=dia drives the diagonal split end to end; grid2d is
    pure stencil so the whole multiply is the DIA kernel's path."""
    results, text = _run({"grid2d": 60, "fp32": True, "quiet": True,
                          "backends": ["dia"], "i": 3})
    assert results["dia"]["verified"]


@pytest.mark.parametrize("backend", ["split", "hotcold"])
def test_cli_split_backends_raise(backend):
    """The split backends raise on a tile size a stack cannot take (not a
    multiple of 1024; hot/cold stacks nothing and takes it), and otherwise
    verify on the JAX package's test_cli split/hotcold inputs."""
    args = {"uniform": 600, "fp32": True, "quiet": True,
            "backends": [backend], "split": 3, "i": 3}
    if backend == "split":
        with pytest.raises(ValueError, match="multiple of 1024"):
            _run(dict(args, tile_items=1536))
    else:
        args = {"powerlaw": 4000, "fp32": True, "quiet": True,
                "backends": [backend], "i": 3, "tile_items": 1536}
    results, _ = _run(args)
    assert results[backend]["verified"]


@pytest.mark.parametrize("split", [3, None])
def test_cli_split_backend_runs(split):
    """--backends=split drives the stacked banded operator end to end:
    --split=3 quantile bands, or the geometric (8, 32) edges."""
    results, text = _run({"grid2d": 60, "fp32": True, "backends": ["split"],
                          "split": split, "i": 3})
    assert results["split"]["verified"]
    assert "SplitSpmvOperator(" in text


def test_cli_hotcold_backend_runs():
    """--backends=hotcold drives the popularity split end to end; on the
    uniform powerlaw generator the hot set declines and one cold launch
    runs (tests/test_cli.py:129-136)."""
    results, text = _run({"powerlaw": 4000, "fp32": True,
                          "backends": ["hotcold"], "i": 3})
    assert results["hotcold"]["verified"]
    assert "no hot set" in text


def test_driver_defaults_to_the_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is reachable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_benchmark({"grid2d": 10, "backends": ["merge"], "i": 2})
