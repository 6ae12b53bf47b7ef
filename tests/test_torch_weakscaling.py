"""The port's weak-scaling tool (merge_spmv_tpu_torch/tools/
bench_multichip.py) held against the TPU package's.

* bench/matrices.py::weak_scaling_matrices against a verbatim copy of the
  JAX tool's inline draws (tools/bench_multichip.py:83-99 and 152-160,
  below; the tool itself needs an 8-device mesh at 2^17 rows a shard),
  at 2^10 rows a shard: every matrix and x bit for bit.
* The tool's CPU run at S = 1, 2, 4 gloo ranks (processes of
  parallel/mp_worker.py) at 2^10 rows a shard: every S verified against
  gold, the fixed-total-work and prepared calls included; every key of
  the TPU package's WEAKSCALING.json present; each S's x_mode and halo
  those of ``merge_spmv_tpu.parallel.partition.partition_csr`` on the
  same matrix; at S = 1 no rank's call makes a collective.
"""

import json
from pathlib import Path

import numpy as np
import pytest

from merge_spmv_tpu.formats.coo import CooMatrix
from merge_spmv_tpu.formats.csr import CsrMatrix
from merge_spmv_tpu.parallel.partition import partition_csr as jax_partition
from merge_spmv_tpu_torch.bench.matrices import (WEAK_SHARDS,
                                                 weak_scaling_matrices)
from merge_spmv_tpu_torch.tools import bench_multichip as MC

REPO = Path(__file__).resolve().parents[1]
ROWS_PER_SHARD = 1 << 10
SHARDS = (1, 2, 4)


def jax_weak_scaling(rows_per_shard):
    """tools/bench_multichip.py:83-99 and 152-160, verbatim but for the
    size, the device-count skip (every S is drawn on its 8-device mesh)
    and the loop body's mesh work; returns ({S: (csr, x)}, (csr_f, x_f))."""
    deg = 8
    rs = np.random.RandomState(0)

    results = {}
    for S in (1, 2, 4, 8):
        n = rows_per_shard * S
        rows = np.repeat(np.arange(n, dtype=np.int64), deg)
        cols = np.clip(rows + rs.randint(-2000, 2001, rows.size), 0, n - 1)
        csr = CsrMatrix.from_coo(CooMatrix(
            n, n, rows, cols, rs.uniform(0.1, 1.0, rows.size))
        ).astype(np.float32)
        x = rs.uniform(0.1, 1.0, n).astype(np.float32)
        results[S] = (csr, x)

    n_f = rows_per_shard * 8
    rows_f = np.repeat(np.arange(n_f, dtype=np.int64), deg)
    cols_f = np.clip(rows_f + rs.randint(-2000, 2001, rows_f.size),
                     0, n_f - 1)
    csr_f = CsrMatrix.from_coo(CooMatrix(
        n_f, n_f, rows_f, cols_f, rs.uniform(0.1, 1.0, rows_f.size))
    ).astype(np.float32)
    x_f = rs.uniform(0.1, 1.0, n_f).astype(np.float32)
    return results, (csr_f, x_f)


def _equal(a, b):
    return a.dtype == b.dtype and np.array_equal(a, b)


def _same_csr(got, want):
    return (got.num_rows == want.num_rows
            and all(_equal(getattr(got, k), getattr(want, k))
                    for k in ("row_offsets", "col_indices", "values")))


@pytest.fixture(scope="module")
def jax_mats():
    return jax_weak_scaling(ROWS_PER_SHARD)


@pytest.mark.parametrize("shards", [WEAK_SHARDS, SHARDS, (2,), ()])
def test_matrices_bit_equal_to_jax(jax_mats, shards):
    """Every S is drawn whichever are built: the fixed matrix is the
    same with none built."""
    want, (want_f, want_xf) = jax_mats
    got, (got_f, got_xf) = weak_scaling_matrices(ROWS_PER_SHARD,
                                                  shards=shards)
    assert sorted(got) == sorted(shards)
    for S in shards:
        assert _same_csr(got[S][0], want[S][0])
        assert _equal(got[S][1], want[S][1])
    assert _same_csr(got_f, want_f) and _equal(got_xf, want_xf)


@pytest.fixture(scope="module")
def cpu_run():
    return MC.run(ROWS_PER_SHARD, SHARDS, "cpu", calls=3)


def test_record_has_the_tpu_keys(cpu_run):
    with open(REPO / "WEAKSCALING.json") as f:
        tpu = json.load(f)
    assert set(tpu) <= set(cpu_run)
    for part in ("results", "fixed_total_work", "prepared_vs_unprepared"):
        sample = next(iter(tpu[part].values()))
        for S, entry in cpu_run[part].items():
            assert set(sample) <= set(entry), (part, S)
    assert sorted(cpu_run["results"]) == list(SHARDS)
    assert sorted(cpu_run["prepared_vs_unprepared"]) == [2, 4]
    assert cpu_run["platform"] == "cpu" and cpu_run["backend"] == "gloo"
    assert cpu_run["device"] == "cpu"
    assert cpu_run["rows_per_shard"] == ROWS_PER_SHARD


@pytest.mark.parametrize("S", SHARDS)
def test_every_shard_count_verified(cpu_run, S):
    r = cpu_run["results"][S]
    assert r["verified"] is True
    assert cpu_run["fixed_total_work"][S]["verified"] is True
    if S >= 2:
        assert cpu_run["prepared_vs_unprepared"][S]["verified"] is True
    assert len(r["ranks"]) == S
    assert all(rank["k1_launches"] == 0 for rank in r["ranks"])   # plain
    assert r["rows"] == ROWS_PER_SHARD * S and r["nnz"] == 8 * r["rows"]


@pytest.mark.parametrize("S", SHARDS)
def test_collectives_per_call(cpu_run, S):
    """One rank exchanges nothing, as the JAX package's ``halo_x`` and
    one-device ``psum_scatter`` do not: no halo exchange and no carries'
    reduce-scatter in its call.  S > 1 in halo mode makes both."""
    r = cpu_run["results"][S]
    for res in (r, cpu_run["fixed_total_work"][S]):
        want = 0 if S == 1 else 1 + (res["x_mode"] == "halo")
        assert all(rank["collectives_per_call"] == want
                   for rank in res["ranks"])
    assert r["collectives_per_call"] == (0 if S == 1 else
                                         1 + (r["x_mode"] == "halo"))
    if S == 1:
        assert "exchange_ms" not in r["ranks"][0]


@pytest.mark.parametrize("S", SHARDS)
def test_partition_modes_are_jax_partition(cpu_run, jax_mats, S):
    want, (want_f, _) = jax_mats
    part = jax_partition(want[S][0], S, dtype=np.float32)
    r = cpu_run["results"][S]
    assert (r["x_mode"], r["halo"]) == (part.x_mode, part.halo)
    part_f = jax_partition(want_f, S, dtype=np.float32)
    assert cpu_run["fixed_total_work"][S]["x_mode"] == part_f.x_mode


def test_efficiencies_are_the_jax_formulas(cpu_run):
    res, fixed = cpu_run["results"], cpu_run["fixed_total_work"]
    for S in SHARDS:
        assert cpu_run["efficiency_vs_S1"][S] == pytest.approx(
            res[S]["nnz_per_s_per_shard"] / res[1]["nnz_per_s_per_shard"])
        assert cpu_run["serialized_total_work_efficiency"][S] == \
            pytest.approx(S * res[1]["avg_ms"] / res[S]["avg_ms"])
        assert cpu_run["collective_overhead_efficiency"][S] == \
            pytest.approx(min(res[S]["local_only_ms"] / res[S]["avg_ms"],
                              1.0))
        assert cpu_run["fixed_total_work_efficiency"][S] == pytest.approx(
            fixed[1]["avg_ms"] / fixed[S]["avg_ms"])
