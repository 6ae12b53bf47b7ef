"""Seconds of the program's own multigrid span (`op.setup_s["multigrid"]`:
the grid check, the coarse levels, the colours' operators and the scratch
of `models/multigrid.py::build_multigrid`, after the fine operator's plan
and prepare)."""

LAYER = "multigrid"
UNIT = "s"
SOURCE = "program_span"


def read(run):
    return run.spans.get("multigrid")
