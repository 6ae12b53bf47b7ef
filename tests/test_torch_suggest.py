"""The port's structure router held against the JAX package's
(tests/test_suggest.py's four class fixtures): ``suggest_backend`` must
return the JAX record, key for key, and ``build_suggested`` must build the
named operator with the port's builders on ``device="cpu"``, forwarding
only the kwargs the builder takes.  Results are held against gold and the
JAX operator's output by ``compare_results(..., abs_bound=spmv_abs_bound)``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import merge_spmv_tpu.formats.coo as jcoo
import merge_spmv_tpu.formats.csr as jcsr
from merge_spmv_tpu.ops.suggest import build_suggested as jbuild_suggested
from merge_spmv_tpu.ops.suggest import suggest_backend as jsuggest_backend
from merge_spmv_tpu_torch.formats.csr import CsrMatrix
from merge_spmv_tpu_torch.ops.dia import DiaSpmvOperator
from merge_spmv_tpu_torch.ops.operator import SpmvOperator
from merge_spmv_tpu_torch.ops.split import (HotColdSpmvOperator,
                                            SplitSpmvOperator)
from merge_spmv_tpu_torch.ops.suggest import build_suggested, suggest_backend
from merge_spmv_tpu_torch.utils.compare import compare_results


def _csr(n, rows, cols, vals):
    return jcsr.CsrMatrix.from_coo(jcoo.CooMatrix(n, n, rows, cols, vals)
                                   ).astype(np.float32)


def _stencil():
    return jcsr.CsrMatrix.from_coo(jcoo.CooMatrix.grid3d(10)).astype(
        np.float32)


def _hub_columns(n=20000):
    rs = np.random.RandomState(7)
    deg = 8
    rows = np.repeat(np.arange(n, dtype=np.int64), deg)
    hub = rs.choice(n, 40, replace=False)
    is_hub = rs.random(rows.size) < 0.6
    cols = np.where(is_hub, hub[rs.randint(0, 40, rows.size)],
                    rs.randint(0, n, rows.size))
    return _csr(n, rows, cols, rs.uniform(-1, 1, rows.size))


def _wide_scatter(n=300_000, scale=60_000):
    rs = np.random.RandomState(3)
    deg = 4
    rows = np.repeat(np.arange(n, dtype=np.int64), deg)
    off = rs.laplace(0.0, scale, rows.size).astype(np.int64)
    return _csr(n, rows, (rows + off) % n, rs.uniform(-1, 1, rows.size))


def _local_uniform(n=50_000):
    rs = np.random.RandomState(5)
    deg = 8
    rows = np.repeat(np.arange(n, dtype=np.int64), deg)
    cols = np.clip(rows + rs.randint(-2048, 2049, rows.size), 0, n - 1)
    return _csr(n, rows, cols, rs.uniform(-1, 1, rows.size))


CLASSES = {"dia": _stencil, "hotcold": _hub_columns, "split": _wide_scatter,
           "merge": _local_uniform}
OPERATORS = {"dia": DiaSpmvOperator, "hotcold": HotColdSpmvOperator,
             "split": SplitSpmvOperator, "merge": SpmvOperator}


def _port(j):
    return CsrMatrix.from_arrays(j.num_rows, j.num_cols, j.row_offsets,
                                 j.col_indices, j.values)


@pytest.mark.parametrize("backend", list(CLASSES))
def test_suggest_backend_is_the_jax_record(backend):
    j = CLASSES[backend]()
    rec = suggest_backend(_port(j))
    assert rec["backend"] == backend
    assert rec == jsuggest_backend(j)


def test_suggest_stencil_is_dia():
    assert suggest_backend(_port(_stencil()))["backend"] == "dia"


def test_suggest_hub_columns_is_hotcold():
    assert suggest_backend(_port(_hub_columns()))["backend"] == "hotcold"


def test_suggest_wide_scatter_is_split():
    assert suggest_backend(_port(_wide_scatter()))["backend"] == "split"


def test_suggest_local_uniform_is_merge():
    assert suggest_backend(_port(_local_uniform()))["backend"] == "merge"


# the same classes at a size the plain versions run quickly
SMALL = {"dia": _stencil, "hotcold": _hub_columns,
         "split": lambda: _wide_scatter(60_000, 25_000),
         "merge": lambda: _local_uniform(10_000)}


@pytest.mark.parametrize("backend", list(SMALL))
def test_build_suggested_matches_gold(backend):
    j = SMALL[backend]()
    csr = _port(j)
    # tile_items reaches every builder; compact_rows only the split's
    op, rec = build_suggested(csr, dtype="float32", device="cpu",
                              tile_items=2048, compact_rows=False)
    jop, jrec = jbuild_suggested(j, dtype="float32", tile_items=2048,
                                 compact_rows=False)
    assert rec == jrec and rec["backend"] == backend
    assert type(op) is OPERATORS[backend]
    rs = np.random.RandomState(0)
    x = rs.uniform(-1, 1, csr.num_cols).astype(np.float32)
    y = op(torch.from_numpy(x)).numpy()
    gold = csr.spmv_gold(x)
    bound = csr.spmv_abs_bound(x)
    assert compare_results(y, gold, abs_bound=bound) is None
    assert compare_results(y, np.asarray(jop(jnp.asarray(x))),
                           abs_bound=bound) is None


def test_build_suggested_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is reachable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_suggested(_port(_stencil()))
