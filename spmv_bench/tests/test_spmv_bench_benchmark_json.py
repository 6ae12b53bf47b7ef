"""BENCHMARK.json against the contract's form, and every piece a cell
names found by name under spmv_bench/."""

import json
import re
from pathlib import Path

import pytest

from spmv_bench.run import cell_metrics, reader

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["spmv_bench"]
    assert not any(w.startswith("/") or ".." in w for w in BENCH["command"])
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units_use_allowed_characters():
    names = [m["name"] for m in METRICS] + CELLS + \
        [c["name"] for c in BENCH["configs"]] + \
        [w["traffic"] for w in BENCH["workloads"]] + \
        [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    assert all(UNIT.match(m["unit"]) for m in METRICS)
    assert len({m["name"] for m in METRICS}) == len(METRICS)
    assert len(set(CELLS)) == len(CELLS)
    for text in [w["why"] for w in BENCH["workloads"]] + \
            [c["why"] for c in BENCH["configs"]] + \
            [c["source"] for c in BENCH["configs"]] + \
            [m["layer"] for m in BENCH["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_metric_entries():
    for m in BENCH["end_to_end"]:
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["better"] in ("lower", "higher")
    setup = next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] <= 0.25 and "workloads" not in setup
    for m in BENCH["per_layer"]:
        assert m["source"] in SOURCES and m["better"] in ("lower", "higher")
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline")


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_what_its_metrics_need(cell):
    e2e, layer = cell_metrics(BENCH, cell)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2 and layer
    for m in BENCH["per_layer"]:
        if cell in m.get("workloads", []):
            assert m["moves"] in names, (m["name"], cell)


def test_each_per_layer_metric_moves_one_end_to_end_metric():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", []):
            assert cell in CELLS
            assert cell in e2e[m["moves"]].get("workloads", [cell])


def test_each_cell_finds_its_files_by_name():
    configs = {c["name"]: c for c in BENCH["configs"]}
    assert len({c["file"] for c in BENCH["configs"]}) == len(configs)
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4)
        conf = json.loads((ROOT / configs[w["config"]]["file"]).read_text())
        assert conf["name"] == w["config"]
        assert set(configs[w["config"]]["reduced"]) <= set(conf)
        assert (ROOT / "spmv_bench" / "generators" /
                f"{conf['generator']}.py").exists()
        traffic = json.loads((ROOT / "spmv_bench" / "traffic" /
                              f"{w['traffic']}.json").read_text())
        assert (ROOT / "spmv_bench" / "loops" /
                f"{traffic['loop']}.py").exists()
        limits = json.loads((ROOT / "spmv_bench" / "limits" /
                             f"{w['name']}.json").read_text())
        assert limits and all(v >= 0 for v in limits.values())
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(CELLS) // 4)


def test_each_reader_states_its_layer_unit_and_source():
    for m in BENCH["per_layer"]:
        module = reader(m["name"])
        assert (module.LAYER, module.UNIT, module.SOURCE) == \
            (m["layer"], m["unit"], m["source"])
