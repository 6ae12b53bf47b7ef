"""Seconds of the program's own prepare span (`op.setup_s["prepare"]`:
the copy to the card, the tile search and the row norm in
`ops/operator.py::build_operator`)."""

LAYER = "operator"
UNIT = "s"
SOURCE = "program_span"


def read(run):
    return run.spans.get("prepare")
