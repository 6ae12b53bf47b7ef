"""The port's multi-process CsrMV (merge_spmv_tpu_torch/parallel/) against
gold and against the JAX package's distributed CsrMV.

One gloo group of 2 CPU processes and one of 4
(merge_spmv_tpu_torch.parallel.mp_worker --cases) run every case of
tests/test_distributed.py inside them: the matrices, the halo-mode banded
matrix, alpha, and the prepared operator, which runs the split path
(interior K1, then the halo exchange, then the boundary items through
K1).  The split's own cases follow: a boundary item on a spanning row, a
share with no boundary item, a share whose items are all boundary, and
an x with an ``inf`` at the first and the last column of rank 1's block
(the lanes where a zeroed boundary entry with a clamped column would
give ``0 * inf``).  The cases are written once as .npy files; each rank
writes its y window back, and here the windows are assembled by
``materialize_y`` and held, with the ULP check, against the gold SpMV and
against JAX's ``materialize_y(distributed_csrmv(mesh, part, x))`` on the
conftest's 8-device CPU mesh; the prepared cases also against JAX's
``PreparedDistributedCsrmv(mesh, part)`` (its split path, the Pallas
kernel in interpret mode) within the backward-error bound.  Each spawn
has a 180 s timeout, after which its exact PIDs are killed.  The last
test is the two-process worker run of tests/test_multiprocess.py.

``prepare_distributed_csrmv``'s ``bvals`` / ``bcols`` / ``brows`` are
held element for element against the JAX package's at S = 2, 4 and 8
(NumPy only, no spawn).
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
    PreparedDistributedCsrmv as JaxPrepared,
    distributed_csrmv as jax_distributed_csrmv,
    materialize_y as jax_materialize_y,
    prepare_distributed_csrmv as jax_prepare)
from merge_spmv_tpu.parallel.partition import partition_csr as jax_partition
from merge_spmv_tpu_torch.formats.csr import CsrMatrix as TCsr
from merge_spmv_tpu_torch.parallel.distributed import (
    _local_share_csr, materialize_y, prepare_distributed_csrmv)
from merge_spmv_tpu_torch.parallel.partition import partition_csr
from merge_spmv_tpu_torch.utils.compare import (assert_allclose_ulp,
                                                compare_results)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 180


def _banded(n, half_bw, deg, seed, extra=None):
    r = np.random.RandomState(seed)
    rows = np.repeat(np.arange(n, dtype=np.int64), deg)
    cols = np.clip(rows + r.randint(-half_bw, half_bw + 1, rows.size),
                   0, n - 1)
    if extra is not None:
        rows = np.concatenate([rows, extra[0]])
        cols = np.concatenate([cols, extra[1]])
    return CooMatrix(n, n, rows, cols, r.uniform(0.1, 1, rows.size))


def _spanning_row():
    """The banded matrix with row 2048 holding 600 items over columns
    1900-2499: the share boundary falls inside it, and its head share
    reads columns past its own x block."""
    return _banded(4096, 300, 4, 7,
                   (np.full(600, 2048), np.arange(1900, 2500)))


def _lower_band():
    """Columns within 100 below the row: rank 0 reads its own block
    only, every later rank its left halo too."""
    r = np.random.RandomState(3)
    rows = np.repeat(np.arange(4096), 4)
    cols = np.clip(rows - r.randint(0, 100, rows.size), 0, 4095)
    return CooMatrix(4096, 4096, rows, cols, r.uniform(0.1, 1, rows.size))


def _swapped_halves():
    """Rows 0-2047 read columns 2048-2175, rows 2048-4095 columns
    1920-2047: at S = 2 every item of both shares is a boundary item."""
    r = np.random.RandomState(4)
    rows = np.repeat(np.arange(4096), 4)
    cols = np.where(rows < 2048, 2048 + r.randint(0, 128, rows.size),
                    1920 + r.randint(0, 128, rows.size))
    return CooMatrix(4096, 4096, rows, cols, r.uniform(0.1, 1, rows.size))


# name -> (COO generator, alpha, prepared, x): "uniform", "ones", or
# "inf_edges" (uniform, inf at the first and last column of rank 1's x
# block).  The first five are tests/test_distributed.py:24-33, then its
# halo, alpha and prepared cases, then the split's own.
CASES = {
    "grid2d": (lambda: CooMatrix.grid2d(15), 1.0, False, "uniform"),
    "wheel": (lambda: CooMatrix.wheel(500), 1.0, False, "uniform"),
    "powerlaw": (lambda: CooMatrix.random_powerlaw(400, 300, 3000, seed=2),
                 1.0, False, "uniform"),
    "empty_rows": (lambda: CooMatrix(350, 40, rows=[10, 300], cols=[0, 39],
                                     vals=[1.0, 2.0]), 1.0, False,
                   "uniform"),
    "giant_row": (lambda: CooMatrix(9, 4000, rows=np.zeros(4000, np.int64),
                                    cols=np.arange(4000),
                                    vals=np.ones(4000)), 1.0, False,
                  "uniform"),
    "halo_banded": (lambda: _banded(4096, 300, 4, 7), 1.0, False,
                    "uniform"),
    "alpha": (lambda: CooMatrix.grid2d(15), 2.5, False, "ones"),
    "prepared_banded": (lambda: CooMatrix.grid2d(40), 1.0, True, "uniform"),
    "prepared_powerlaw": (lambda: CooMatrix.random_powerlaw(
        300, 250, 2500, seed=5), 1.0, True, "uniform"),
    "prepared_wheel": (lambda: CooMatrix.wheel(900), 1.0, True, "uniform"),
    "split_spanning_row": (_spanning_row, 1.0, True, "uniform"),
    "split_no_boundary_share": (_lower_band, 1.0, True, "uniform"),
    "split_all_boundary": (_swapped_halves, 1.0, True, "uniform"),
    "split_alpha": (lambda: _banded(4096, 300, 4, 7), 2.5, True,
                    "uniform"),
    "split_inf_edges": (lambda: _banded(4096, 300, 4, 7), 1.0, True,
                        "inf_edges"),
}
PREPARED = sorted(n for n, c in CASES.items() if c[2])
# the JAX package's halo-mode matrices (its halo case, its prepared grid,
# the split's cases), for the arrays' test
HALO_CASES = ["halo_banded", "prepared_banded", "split_spanning_row",
              "split_no_boundary_share", "split_all_boundary"]


def _case(name, world):
    gen, alpha, prepared, xk = CASES[name]
    csr = CsrMatrix.from_coo(gen())
    rs = np.random.RandomState(0)
    csr.values = rs.uniform(0.1, 1.0, csr.num_nonzeros)
    csr = csr.astype(np.float32)
    x = (np.ones(csr.num_cols, np.float32) if xk == "ones" else
         rs.uniform(0.1, 1.0, csr.num_cols).astype(np.float32))
    if xk == "inf_edges":
        cpad = jax_partition(csr, world, dtype=np.float32).cpad
        x[cpad] = x[min(2 * cpad, csr.num_cols) - 1] = np.inf
    return csr, x, alpha, prepared


def _tcsr(csr):
    return TCsr.from_arrays(csr.num_rows, csr.num_cols, csr.row_offsets,
                            csr.col_indices, csr.values)


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
    """Every case through one spawned group of ``request.param`` ranks;
    the split's inf case also records its timeline (``evidence``)."""
    world = request.param
    root = tmp_path_factory.mktemp(f"cases{world}")
    for name in CASES:
        csr, x, alpha, prepared = _case(name, world)
        d = root / name
        d.mkdir()
        for arr, a in (("row_offsets", csr.row_offsets),
                       ("col_indices", csr.col_indices),
                       ("values", csr.values), ("x", x)):
            np.save(d / f"{arr}.npy", a)
        (d / "case.json").write_text(json.dumps(
            {"num_rows": csr.num_rows, "num_cols": csr.num_cols,
             "alpha": alpha, "prepared": prepared,
             "evidence": name == "split_inf_edges"}))
    outs = _spawn(world, "--cases", str(root))
    reports = [_pass_report(out, r, world) for r, out in enumerate(outs)]
    return world, root, reports


def _windows(root, name, world, part):
    windows = np.stack([np.load(root / name / f"y_{r}.npy")
                        for r in range(world)])
    assert windows.shape == (world, part.rows_max)
    assert windows.dtype == np.float32
    return materialize_y(windows, part)


def _same_nonfinite(y, want):
    return (np.array_equal(np.isnan(y), np.isnan(want))
            and np.array_equal(np.isposinf(y), np.isposinf(want))
            and np.array_equal(np.isneginf(y), np.isneginf(want)))


@pytest.mark.parametrize("name", sorted(CASES))
def test_distributed_vs_gold_and_jax(group_run, name):
    world, root, reports = group_run
    csr, x, alpha, _ = _case(name, world)
    part = partition_csr(_tcsr(csr), world, dtype=np.float32)
    y = _windows(root, name, world, part)
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
    if name == "split_inf_edges":
        assert np.isinf(gold).any()
        assert _same_nonfinite(y, gold) and _same_nonfinite(y, y_jax)


@pytest.mark.parametrize("name", PREPARED)
def test_split_path_vs_gold_and_jax_prepared(group_run, name):
    """The split path's windows against gold and JAX's
    ``PreparedDistributedCsrmv`` (its own split path), both within the
    backward-error bound; each rank's report shows its split.  In the
    inf case JAX's prepared path is no oracle: its Pallas kernel's
    distributed gather (interpret mode, as on the mesh) turns the inf
    into NaN over whole shares (2048 rows at S = 2), where gold and
    JAX's unprepared path give inf on the rows that read it, so there
    the non-finite positions are held against those two
    (``test_distributed_vs_gold_and_jax``)."""
    world, root, reports = group_run
    csr, x, alpha, _ = _case(name, world)
    part = partition_csr(_tcsr(csr), world, dtype=np.float32)
    y = _windows(root, name, world, part)
    bound = csr.spmv_abs_bound(x, alpha=alpha)
    assert compare_results(y, csr.spmv_gold(x, alpha=alpha), verbose=False,
                           abs_bound=bound) is None
    split = prepare_distributed_csrmv(part)
    for r in range(world):
        rep = reports[r][name]
        assert rep["boundary_items"] == split.boundary_count(r)
        assert rep["interior_nnz"] + rep["boundary_items"] == \
            rep["local_nnz"]
        assert rep["collectives_per_call"] == (part.x_mode == "halo") + 1
    if CASES[name][3] == "inf_edges":
        return
    mesh = Mesh(np.array(jax.devices()[:world]), ("shards",))
    jpart = jax_partition(csr, world, dtype=np.float32)
    y_jax = jax_materialize_y(JaxPrepared(mesh, jpart, alpha=alpha)(x),
                              jpart)
    assert compare_results(y, y_jax, verbose=False,
                           abs_bound=bound) is None


@pytest.mark.parametrize("name,world,want", [
    ("split_spanning_row", 2, "spanning"),
    ("split_spanning_row", 4, "spanning"),
    ("split_no_boundary_share", 2, "no_boundary"),
    ("split_no_boundary_share", 4, "no_boundary"),
    ("split_all_boundary", 2, "all_boundary"),
    ("split_inf_edges", 2, "inf_edges"),
    ("split_inf_edges", 4, "inf_edges")])
def test_split_cases_hit_their_lanes(name, world, want):
    """Each of the split's cases has, at that S, what it is there for."""
    csr, x, _, _ = _case(name, world)
    part = partition_csr(_tcsr(csr), world, dtype=np.float32)
    assert part.x_mode == "halo" and part.halo > 0
    split = prepare_distributed_csrmv(part)
    counts = [split.boundary_count(s) for s in range(world)]
    local = [int(part.meta[s, 3]) for s in range(world)]
    if want == "spanning":
        # a share whose spanning row (local row ``owned``) holds one
        hit = False
        for s in range(world):
            _, _, lr, _, owned, _ = part.meta[s]
            rows = np.searchsorted(part.rowends_local[s],
                                   split.boundary_ids[s], side="right")
            hit |= bool(owned < lr and np.any(rows == owned))
        assert hit
    elif want == "no_boundary":
        assert 0 in counts and max(counts) > 0
    elif want == "all_boundary":
        assert counts == local
    else:
        c0 = part.cpad
        assert np.isinf(x[c0]) and np.isinf(x[min(2 * c0, len(x)) - 1])
        assert np.isfinite(x).sum() == len(x) - 2


def test_worker_timeline_orders_the_split(group_run):
    """The inf case's timeline on each rank (host clock on the CPU): the
    interior K1 before the exchange's post, the boundary K1 after its
    completion, the carries last, where the unsplit call's K1 comes after
    the exchange; one call makes two collectives."""
    world, _, reports = group_run
    for r in range(world):
        rep = reports[r]["split_inf_edges"]
        ev = rep["evidence"]
        assert ev["clock"] == "host" and ev["overlap_scheduled"] is True
        # the control: the unsplit call's one K1 waits for the exchange
        assert ev["unsplit"]["overlap_scheduled"] is False
        for t in ev["calls"]:
            assert t["interior_start"] <= t["interior_end"] <= \
                t["exchange_post"] <= t["exchange_done"]
            if rep["boundary_items"]:
                assert t["exchange_done"] <= t["boundary_start"] <= \
                    t["boundary_end"] <= t["carry_done"]
        assert rep["collectives_per_call"] == 2


@pytest.mark.parametrize("name", HALO_CASES)
@pytest.mark.parametrize("S", [2, 4, 8])
def test_prepare_arrays_equal_jax(name, S):
    """``bvals``, ``bcols``, ``brows`` element for element (and absent
    together) against ``merge_spmv_tpu``'s prepare_distributed_csrmv."""
    csr, _, _, _ = _case(name, S)
    jpart = jax_partition(csr, S, dtype=np.float32)
    _, want = jax_prepare(jpart, "float32")
    got = prepare_distributed_csrmv(partition_csr(_tcsr(csr), S,
                                                  dtype=np.float32)).arrays
    for key in ("bvals", "bcols", "brows"):
        assert (want.get(key) is None) == (key not in got), key
        if key in got:
            assert got[key].dtype == want[key].dtype, key
            assert np.array_equal(got[key], want[key]), key


@pytest.mark.parametrize("name", HALO_CASES + ["prepared_powerlaw"])
@pytest.mark.parametrize("S", [2, 4])
def test_split_csrs_rebuild_the_share(name, S):
    """Each rank's interior CSR over its own block plus its boundary CSR
    over the [2H] halo is its share over the window [halo | block |
    halo], row by row, with alpha in the boundary values."""
    csr, x, _, _ = _case(name, S)
    part = partition_csr(_tcsr(csr), S, dtype=np.float32)
    split = prepare_distributed_csrmv(part)
    x64 = x.astype(np.float64)
    for s in range(S):
        share = _local_share_csr(part, s).astype(np.float64)
        inner = split.interior_csr(s).astype(np.float64)
        assert inner.num_nonzeros + split.boundary_count(s) == \
            share.num_nonzeros
        if part.x_mode != "halo":
            assert split.boundary_count(s) == 0
            assert np.array_equal(inner.spmv_gold(x64), share.spmv_gold(x64))
            continue
        H, cpad = part.halo, part.cpad
        window = np.zeros(cpad + 2 * H)
        lo = s * cpad - H
        for j in range(window.size):
            if 0 <= lo + j < len(x64):
                window[j] = x64[lo + j]
        halo = np.concatenate([window[:H], window[H + cpad:]])
        outer = split.boundary_csr(s, alpha=2.0).astype(np.float64)
        y = inner.spmv_gold(window[H:H + cpad]) + 0.5 * outer.spmv_gold(halo)
        np.testing.assert_allclose(y, share.spmv_gold(window), rtol=1e-12)


def test_two_process_worker():
    """tests/test_multiprocess.py on the port: two ranks, the JAX
    worker's matrix, each verifies its own window and prints PASS."""
    outs = _spawn(2)
    for r, out in enumerate(outs):
        report = _pass_report(out, r, 2)["powerlaw"]
        assert report["rows_checked"] > 0


def test_halo_overlap_evidence_tool_on_the_cpu():
    """merge_spmv_tpu_torch/tools/halo_overlap_evidence.py at a small
    size on the CPU: its banded generator is the JAX tool's inline draw
    (tools/halo_overlap_evidence.py:55-60, verbatim but for the size),
    every entry verified, every rank's timeline in the split's order, the
    A/B of split and unsplit calls recorded."""
    from merge_spmv_tpu_torch.tools import halo_overlap_evidence as HO

    r = np.random.RandomState(7)
    n, deg, bw = 4096, 6, 300
    rows = np.repeat(np.arange(n, dtype=np.int64), deg)
    cols = np.clip(rows + r.randint(-bw, bw + 1, rows.size), 0, n - 1)
    want = CsrMatrix.from_coo(CooMatrix(n, n, rows, cols,
                                        r.uniform(0.1, 1, rows.size)))
    got = HO.banded(n, deg, bw, 7)
    for k in ("row_offsets", "col_indices", "values"):
        assert np.array_equal(getattr(got, k), getattr(want, k)), k
    rec = HO.run([("banded", 2, got), ("grid3d12", 2, HO.grid3d(12))],
                 "cpu", calls=2)
    assert rec["platform"] == "cpu" and rec["device"] == "cpu"
    assert rec["verified"] and rec["overlap_scheduled"]
    for e in rec["entries"]:
        assert e["x_mode"] == "halo" and e["halo"] > 0
        assert e["split_over_unsplit"] == e["call_ms"] / e["unsplit_ms"]
        for rank in e["ranks"]:
            assert rank["collectives_per_call"] == 2
            assert rank["evidence"]["clock"] == "host"
            assert all(p["boundary_after_halo"]
                       for p in rank["evidence"]["per_call"])
