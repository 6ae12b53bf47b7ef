"""Seconds of the program's own plan span (`op.setup_s["plan"]`,
the host clock around `ops/plan.py::make_plan` in `build_operator`)."""

LAYER = "plan"
UNIT = "s"
SOURCE = "program_span"


def read(run):
    return run.spans.get("plan")
