"""What a run loads: no module of JAX or of the JAX package, and nothing
of the program in the reference.  Checked in a fresh interpreter, by whole
top-level names (merge_spmv_tpu_torch begins with merge_spmv_tpu)."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "spmv_bench"


def loaded_top_levels(code: str) -> set:
    probe = code + ("\nimport sys, json\nprint(json.dumps(sorted("
                    "{m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout
    return set(json.loads(out.strip().splitlines()[-1]))


def test_run_path_loads_neither_jax_nor_the_jax_package():
    modules = ["spmv_bench.run", "spmv_bench.system", "spmv_bench.control",
               "merge_spmv_tpu_torch", "merge_spmv_tpu_torch.models.solvers"]
    modules += [f"spmv_bench.loops.{p.stem}"
                for p in (BENCH / "loops").glob("*.py")]
    modules += [f"spmv_bench.generators.{p.stem}"
                for p in (BENCH / "generators").glob("*.py")]
    readers = [str(p) for p in (BENCH / "metrics").glob("*.py")]
    code = "\n".join(f"import {m}" for m in modules) + (
        "\nfrom spmv_bench.run import reader\n"
        f"for p in {readers!r}:\n"
        "    import pathlib; reader(pathlib.Path(p).stem)\n")
    loaded = loaded_top_levels(code)
    assert "merge_spmv_tpu_torch" in loaded and "spmv_bench" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "merge_spmv_tpu"}


def test_reference_loads_nothing_of_the_program():
    loaded = loaded_top_levels("import spmv_bench.reference")
    assert not loaded & {"jax", "jaxlib", "flax", "merge_spmv_tpu",
                         "merge_spmv_tpu_torch"}


def test_only_system_names_the_program():
    for path in BENCH.rglob("*.py"):
        if path.parent.name == "tests" or path.name == "system.py":
            continue
        text = path.read_text()
        assert "import merge_spmv_tpu" not in text, path
        assert "from merge_spmv_tpu" not in text, path
