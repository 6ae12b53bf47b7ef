"""The port's multi-process CsrMV (merge_spmv_tpu_torch/parallel/) against
gold and against the JAX package's distributed CsrMV.

One gloo group of 2 CPU processes and one of 4
(merge_spmv_tpu_torch.parallel.mp_worker --cases) run every case of
tests/test_distributed.py inside them: the matrices, the halo-mode banded
matrix, alpha, and the prepared operator.  The cases are written once as
.npy files; each rank writes its y window back, and here the windows are
assembled by ``materialize_y`` and held, with the ULP check, against the
gold SpMV and against JAX's ``materialize_y(distributed_csrmv(mesh, part,
x))`` on the conftest's 8-device CPU mesh.  Each spawn has a 180 s
timeout, after which its exact PIDs are killed.  The last test is the
two-process worker run of tests/test_multiprocess.py.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from merge_spmv_tpu.formats.coo import CooMatrix
from merge_spmv_tpu.formats.csr import CsrMatrix
from merge_spmv_tpu.parallel.distributed import (
    distributed_csrmv as jax_distributed_csrmv,
    materialize_y as jax_materialize_y)
from merge_spmv_tpu.parallel.partition import partition_csr as jax_partition
from merge_spmv_tpu_torch.formats.csr import CsrMatrix as TCsr
from merge_spmv_tpu_torch.parallel.distributed import materialize_y
from merge_spmv_tpu_torch.parallel.partition import partition_csr
from merge_spmv_tpu_torch.utils.compare import assert_allclose_ulp

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 180


def _banded(n, half_bw, deg, seed):
    r = np.random.RandomState(seed)
    rows = np.repeat(np.arange(n, dtype=np.int64), deg)
    cols = np.clip(rows + r.randint(-half_bw, half_bw + 1, rows.size),
                   0, n - 1)
    return CooMatrix(n, n, rows, cols, r.uniform(0.1, 1, rows.size))


# name -> (COO generator, alpha, prepared, x of ones); the first five are
# tests/test_distributed.py:24-33, then its halo, alpha and prepared cases
CASES = {
    "grid2d": (lambda: CooMatrix.grid2d(15), 1.0, False, False),
    "wheel": (lambda: CooMatrix.wheel(500), 1.0, False, False),
    "powerlaw": (lambda: CooMatrix.random_powerlaw(400, 300, 3000, seed=2),
                 1.0, False, False),
    "empty_rows": (lambda: CooMatrix(350, 40, rows=[10, 300], cols=[0, 39],
                                     vals=[1.0, 2.0]), 1.0, False, False),
    "giant_row": (lambda: CooMatrix(9, 4000, rows=np.zeros(4000, np.int64),
                                    cols=np.arange(4000),
                                    vals=np.ones(4000)), 1.0, False, False),
    "halo_banded": (lambda: _banded(4096, 300, 4, 7), 1.0, False, False),
    "alpha": (lambda: CooMatrix.grid2d(15), 2.5, False, True),
    "prepared_banded": (lambda: CooMatrix.grid2d(40), 1.0, True, False),
    "prepared_powerlaw": (lambda: CooMatrix.random_powerlaw(
        300, 250, 2500, seed=5), 1.0, True, False),
    "prepared_wheel": (lambda: CooMatrix.wheel(900), 1.0, True, False),
}


def _case(name):
    gen, alpha, prepared, ones = CASES[name]
    csr = CsrMatrix.from_coo(gen())
    rs = np.random.RandomState(0)
    csr.values = rs.uniform(0.1, 1.0, csr.num_nonzeros)
    csr = csr.astype(np.float32)
    x = (np.ones(csr.num_cols, np.float32) if ones else
         rs.uniform(0.1, 1.0, csr.num_cols).astype(np.float32))
    return csr, x, alpha, prepared


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn(world, *extra):
    """``world`` worker processes on one gloo group; returns their
    outputs after all exited 0, killing their exact PIDs on a timeout."""
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "2"
    procs = [subprocess.Popen(
        [sys.executable, "-u", "-m", "merge_spmv_tpu_torch.parallel.mp_worker",
         str(r), str(world), str(port), "--device", "cpu", *extra],
        cwd=_REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]
    outs, timed_out = [], False
    for p in procs:
        try:
            out, _ = p.communicate(timeout=TIMEOUT_S)
            outs.append(out.decode(errors="replace"))
        except subprocess.TimeoutExpired:
            timed_out = True
            outs.append("<timeout>")
    if timed_out:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait(timeout=30)
        pytest.fail("workers timed out:\n" + "\n".join(outs))
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} failed:\n{outs[r]}"
    return outs


def _pass_report(out, rank, world):
    line = [ln for ln in out.splitlines() if ln.startswith("PASS ")]
    assert len(line) == 1, out
    head = f"PASS rank={rank} world={world} device=cpu "
    assert line[0].startswith(head), line[0]
    return json.loads(line[0][len(head):])


@pytest.fixture(scope="module", params=[2, 4])
def group_run(request, tmp_path_factory):
    """Every case through one spawned group of ``request.param`` ranks."""
    world = request.param
    root = tmp_path_factory.mktemp(f"cases{world}")
    for name in CASES:
        csr, x, alpha, prepared = _case(name)
        d = root / name
        d.mkdir()
        for arr, a in (("row_offsets", csr.row_offsets),
                       ("col_indices", csr.col_indices),
                       ("values", csr.values), ("x", x)):
            np.save(d / f"{arr}.npy", a)
        (d / "case.json").write_text(json.dumps(
            {"num_rows": csr.num_rows, "num_cols": csr.num_cols,
             "alpha": alpha, "prepared": prepared}))
    outs = _spawn(world, "--cases", str(root))
    reports = [_pass_report(out, r, world) for r, out in enumerate(outs)]
    return world, root, reports


@pytest.mark.parametrize("name", sorted(CASES))
def test_distributed_vs_gold_and_jax(group_run, name):
    world, root, reports = group_run
    csr, x, alpha, _ = _case(name)
    tcsr = TCsr.from_arrays(csr.num_rows, csr.num_cols, csr.row_offsets,
                            csr.col_indices, csr.values)
    part = partition_csr(tcsr, world, dtype=np.float32)
    windows = np.stack([np.load(root / name / f"y_{r}.npy")
                        for r in range(world)])
    assert windows.shape == (world, part.rows_max)
    assert windows.dtype == np.float32
    y = materialize_y(windows, part)
    gold = csr.spmv_gold(x, alpha=alpha)
    assert_allclose_ulp(y, gold, context=f"{name}/{world} vs gold")
    mesh = Mesh(np.array(jax.devices()[:world]), ("shards",))
    jpart = jax_partition(csr, world, dtype=np.float32)
    y_jax = jax_materialize_y(jax_distributed_csrmv(mesh, jpart, x,
                                                    alpha=alpha), jpart)
    assert_allclose_ulp(y, y_jax, context=f"{name}/{world} vs JAX")
    for r in range(world):
        assert reports[r][name]["x_mode"] == part.x_mode
    if name == "halo_banded":
        assert part.x_mode == "halo" and part.halo > 0


def test_two_process_worker():
    """tests/test_multiprocess.py on the port: two ranks, the JAX
    worker's matrix, each verifies its own window and prints PASS."""
    outs = _spawn(2)
    for r, out in enumerate(outs):
        report = _pass_report(out, r, 2)["powerlaw"]
        assert report["rows_checked"] > 0
