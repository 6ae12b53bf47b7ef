"""The port's headline benchmark (merge_spmv_tpu_torch/bench/headline.py):
bench.py's keys, and the plain path with device="cpu" at a small size.
The card's numbers come only from a run on the card (chip_smoke.py)."""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from merge_spmv_tpu_torch.bench import headline as H
from merge_spmv_tpu_torch.utils.device import measure_stream_bandwidth

_REPO = Path(__file__).resolve().parents[1]
SMALL = dict(grid_width=8, skew_rows=1024, circuit=(2000, 20000))


@pytest.fixture(scope="module")
def small_run():
    return H.run(device="cpu", **SMALL)


def test_keys_are_bench_py_keys():
    """HEADLINE_KEYS is the key set of bench.py's JSON line as the driver
    stored it (BENCH_r05.json)."""
    with open(_REPO / "BENCH_r05.json") as f:
        parsed = json.load(f)["parsed"]
    assert set(H.HEADLINE_KEYS) == set(parsed)


def test_cpu_run_has_every_key(small_run):
    out = small_run
    assert set(H.HEADLINE_KEYS) <= set(out)
    assert not [k for k in out if k.endswith("_error")]
    assert out["metric"] == "grid3d8_merge_csrmv_fp32_gflops"
    assert out["unit"] == "GFLOP/s"
    assert out["device_kind"] == "cpu" and out["backend"] == "torch"
    assert out["circuit_class_quarter_backend"] == "torch"
    # device-only numbers are not measured on the CPU
    assert out["stream_gbps"] is None and out["pct_peak"] is None
    assert out["dia_pct_peak"] is None
    assert out["dia_verified"] is True
    assert out["dia_byte_model"] == "hbm_all_bytes"
    assert out["skew_control"] == "shared_column_stream"
    for k in ("value", "kernel_ms", "effective_gbps", "vs_baseline",
              "dia_grid3d100_ms", "dia_grid3d100_gflops",
              "dia_grid3d100_actual_gbps", "dia_setup_ms",
              "skew_powerlaw_over_uniform_per_nnz", "skew_uniform_ms",
              "skew_powerlaw_ms",
              "skew_powerlaw_over_uniform_per_nnz_natural",
              "skew_powerlaw_natural_ms", "circuit_class_quarter_ms"):
        assert isinstance(out[k], float) and math.isfinite(out[k]) \
            and out[k] > 0, (k, out[k])
    assert 0 < out["circuit_class_quarter_nnz"] <= SMALL["circuit"][1] * 2


def test_rates_follow_the_times(small_run):
    out = small_run
    nnz = 6 * 8 ** 3 - 6 * 8 ** 2    # grid3d(8): 6 neighbours less the faces
    assert math.isclose(out["value"], 2 * nnz / out["kernel_ms"] / 1e6)
    assert math.isclose(out["dia_grid3d100_gflops"],
                        2 * nnz / out["dia_grid3d100_ms"] / 1e6)
    assert math.isclose(out["skew_powerlaw_over_uniform_per_nnz"],
                        out["skew_uniform_ms"] / out["skew_powerlaw_ms"])
    per_mnnz = out["circuit_class_quarter_ms"] / (
        out["circuit_class_quarter_nnz"] / 1e6)
    assert math.isclose(out["vs_baseline"], H.K40_MS_PER_MNNZ / per_mnnz)


def test_module_prints_one_json_line():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(_REPO) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-m", "merge_spmv_tpu_torch.bench.headline", "--cpu",
         "--grid", "6", "--skew-rows", "512", "--circuit-rows", "1000",
         "--circuit-nnz", "8000"],
        cwd=_REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    assert set(H.HEADLINE_KEYS) <= set(json.loads(lines[0]))


def test_device_paths_need_the_card():
    """Without a card the default device raises, and the triad probe
    never measures the host."""
    with pytest.raises(RuntimeError):
        measure_stream_bandwidth(device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            H.run(**SMALL)
