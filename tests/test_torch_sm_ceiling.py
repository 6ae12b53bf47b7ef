"""The op-class probe P1 held against the JAX package's.

tools/vpu_ceiling.py is loaded by path, unchanged, with its module
globals set small (GRID=3, UNROLL=2, CHAINS=2, TABLE_ROWS=64), and its
five Pallas kernels run under ``force_tpu_interpret_mode`` on the CPU.
The port's plain version (the function the CUDA kernel computes) must give
the same (8, 128) float32 result for every class.  Tolerance: bitwise
equality — both take the same float32 operations in the same order (the
chains' sum in chain order).  On the card the fma kernel contracts
multiply and add into one FFMA; tests/test_torch_cuda.py compares it with
the plain version at rtol 1e-5.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from merge_spmv_tpu_torch.tools import sm_ceiling as P

SMALL = {"GRID": 3, "UNROLL": 2, "CHAINS": 2, "TABLE_ROWS": 64}
TOOL = Path(__file__).resolve().parents[1] / "tools" / "vpu_ceiling.py"


@pytest.fixture(scope="module")
def jax_outputs():
    """{class: (output, ops per grid step)} of the TPU probe at SMALL."""
    spec = importlib.util.spec_from_file_location("vpu_ceiling_reference",
                                                  TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for k, v in SMALL.items():
        setattr(mod, k, v)
    x = np.random.RandomState(0).uniform(-1, 1, (8, 128)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        kernels = mod.build_kernels()
        out = {name: (np.asarray(fn(jnp.asarray(x))), n)
               for name, (fn, n) in kernels.items()}
    return x, out


@pytest.mark.parametrize("cls", P.CLASSES)
def test_probe_plain_matches_jax(jax_outputs, cls):
    x, out = jax_outputs
    want, ops_per_step = out[cls]
    P.reset_launches()
    got = P.probe(cls, torch.from_numpy(x), SMALL["GRID"], SMALL["UNROLL"],
                  SMALL["CHAINS"], SMALL["TABLE_ROWS"])
    assert P.LAUNCHES[cls] == 0      # CPU tensor: the plain version
    assert got.dtype == torch.float32 and tuple(got.shape) == (8, 128)
    np.testing.assert_array_equal(got.numpy(), want)
    # the operation count is the TPU probe's regops times 1024 elements
    assert P.operations(cls, SMALL["GRID"], SMALL["UNROLL"],
                        SMALL["CHAINS"]) == (SMALL["GRID"] * ops_per_step
                                             * 1024)


def test_classes_cover_the_tpu_probe(jax_outputs):
    assert set(jax_outputs[1]) == set(P.CLASSES)


def test_gather_shuffle_schedule():
    """The lane and slot schedule of the gather kernel (csrc/sm_ceiling.cu),
    replayed in numpy for every step modulo 128 and past it: lane l sends
    slot (m - s) & 3 in round s, its four values rotated by
    m = ((7 * reader + t) & 127) >> 5 in two stages, reader =
    23 (l - t) & 31; lane d reads lane (7 d + t) & 31 in every round.  The
    rounds give (g + 1)[(7 * col + t) & 127] with each lane read once."""
    rs = np.random.RandomState(1)
    lane = np.arange(32)
    for t in range(260):
        g = rs.uniform(-1, 1, 128).astype(np.float32)
        slots = g.reshape(4, 32)                  # slots[s, l]: col l + 32 s
        src = (7 * lane + t) & 31
        assert sorted(src) == list(range(32))
        reader = (23 * (lane - t)) & 31
        m = ((7 * reader + t) & 127) >> 5
        h = np.where(m & 1, slots[(np.arange(4) + 1) & 3], slots)
        r = np.where(m & 2, h[(np.arange(4) + 2) & 3], h)
        got = np.stack([r[(4 - s) & 3][src] for s in range(4)])
        want = g[(np.arange(128) * 7 + t) & 127].reshape(4, 32)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bad", [
    {"cls": "nope"}, {"chains": 3}, {"table_rows": 16},
    {"table_rows": 460}, {"table_rows": 100}, {"grid": 0},
])
def test_probe_refuses_what_the_kernel_does_not_take(bad):
    kw = dict(cls="fma", grid=2, unroll=2, chains=2, table_rows=64)
    kw.update(bad)
    cls = kw.pop("cls")
    with pytest.raises(ValueError):
        P.probe(cls, torch.ones(8, 128), **kw)


def test_select_issue_bounds():
    """The select class's issue bounds from its SASS count (187
    instructions, 161 on the integer pipe, per 128 elements): at 1 element
    operation per clock per lane the operation bound of one SM for N
    operations is N / 128 clocks; the issue bound is 187/128 of it and the
    integer-pipe bound 2 x 161/128 of it."""
    sms, mhz = 132, 1980.0
    ops = P.operations("select", blocks=sms * 8)
    op_ms = ops / (sms * 128 * mhz * 1e3)
    b = P.issue_bounds_ms("select", ops, sms, mhz)
    assert b["issue_bound_ms"] == pytest.approx(op_ms * 187 / 128, rel=1e-12)
    assert b["int_pipe_bound_ms"] == pytest.approx(op_ms * 2 * 161 / 128,
                                                   rel=1e-12)
    # the rate the integer pipe allows: 64 * 128 / 161 elements per SM
    # per clock
    assert ops / (b["int_pipe_bound_ms"] * sms * mhz * 1e3) == \
        pytest.approx(64 * 128 / 161, rel=1e-12)
    assert P.issue_bounds_ms("fma", ops, sms, mhz) == {}
