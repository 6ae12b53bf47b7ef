"""Seconds of the program's own stochastic span
(`op.setup_s["stochastic"]`: the row sums, the scaling and the transpose
of the values to P = A^T D^-1 on the card, inside the prepare span of
`ops/operator.py::pagerank_operator`).  None where the program has no
such span."""

LAYER = "operator"
UNIT = "s"
SOURCE = "program_span"


def read(run):
    return run.spans.get("stochastic")
