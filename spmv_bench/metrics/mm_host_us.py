"""The host time of one SpMM call into the operator, in us: the mean
length of the program's `merge_spmv.op.mm` spans (`SpmvOperator.mm`,
`ops/operator.py`: operand checks and K1m's launches, one a block of 64
columns) in the traced window.  One reader for every cell's entry
(`mm_host_us.<mix>`)."""

from spmv_bench.spans import named

LAYER = "call"
UNIT = "us"
SOURCE = "program_span"
OP_MM = "merge_spmv.op.mm"


def read(run):
    calls = named(run.trace, OP_MM)
    if not calls:
        return None
    return 1e6 * sum(e - s for s, e in calls) / len(calls)
