"""The port's tile autotuner (ops/autotune.py) beside the JAX package's
(tests/test_autotune.py): shape-class bucketing, the cache round trip (a
corrupt file reads as empty), the short circuit off the card (the plan's
default, nothing timed or stored), and ``build_operator(autotune=True,
device="cpu")``.  The port keys a class by the card's name where the JAX
tuner keys it by the TPU gather mode, and keeps its own cache file.
"""

import os

import numpy as np
import pytest
import torch

from merge_spmv_tpu.ops import autotune as jautotune
from merge_spmv_tpu_torch.formats.coo import CooMatrix
from merge_spmv_tpu_torch.formats.csr import CsrMatrix
from merge_spmv_tpu_torch.ops import autotune
from merge_spmv_tpu_torch.ops.operator import build_operator
from merge_spmv_tpu_torch.ops.plan import make_plan

H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture
def cache(tmp_path, monkeypatch):
    path = tmp_path / "tune.json"
    monkeypatch.setenv(autotune.CACHE_ENV, str(path))
    return path


def test_shape_class_buckets():
    a = autotune.shape_class(1_000_000, 6_000_000, H100, "float32")
    b = autotune.shape_class(1_040_000, 6_300_000, H100, "float32")
    c = autotune.shape_class(1_000_000, 6_000_000, "NVIDIA H200", "float32")
    d = autotune.shape_class(1_000_000, 60_000_000, H100, "float32")
    assert a == b            # same class: same policy
    assert a != c            # another card, another class
    assert a != d            # another degree, another class
    # the rows/degree buckets are the JAX tuner's
    assert a.split("_")[:2] == jautotune.shape_class(
        1_000_000, 6_000_000, 128, 11, "float32").split("_")[:2]


def test_cache_round_trip(cache):
    autotune._store("k1", {"tile_items": 4096})
    assert autotune._load_cache()["k1"]["tile_items"] == 4096
    assert autotune.cache_path() == str(cache)
    cache.write_text("{broken")
    assert autotune._load_cache() == {}


def test_cache_is_the_ports_own(monkeypatch):
    monkeypatch.delenv(autotune.CACHE_ENV, raising=False)
    path = autotune.cache_path()
    assert os.path.basename(path) == ".tune_cache_torch.json"
    assert os.path.abspath(path) != os.path.abspath(jautotune._CACHE_PATH)


def test_autotune_short_circuits_off_the_card(cache):
    csr = CsrMatrix.from_coo(CooMatrix.grid2d(20)).astype(np.float32)
    autotune.reset_timed()
    t = autotune.autotune_tile_items(csr, device="cpu")
    assert t == make_plan(csr.num_rows, csr.num_cols, csr.num_nonzeros,
                          device="cpu").tile_items
    assert autotune.TIMED["candidates"] == 0
    assert not cache.exists()   # nothing was timed or stored


def test_autotune_defaults_to_the_card(cache):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is reachable")
    csr = CsrMatrix.from_coo(CooMatrix.grid2d(20)).astype(np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        autotune.autotune_plan(csr)


def test_build_operator_accepts_autotune_flag(cache):
    csr = CsrMatrix.from_coo(CooMatrix.grid2d(16)).astype(np.float32)
    op = build_operator(csr, autotune=True, device="cpu")
    assert op.plan.tile_items == build_operator(
        csr, device="cpu").plan.tile_items
    assert "autotune" not in op.ignored
    # an explicit tile size wins over the tuner
    assert build_operator(csr, autotune=True, tile_items=1024,
                          device="cpu").plan.tile_items == 1024
