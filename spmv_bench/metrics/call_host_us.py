"""The host time of one call into the operator, in us: the mean length
of the program's `merge_spmv.op.call` spans (`SpmvOperator.__call__`,
`ops/operator.py`: operand checks, the launch through ctypes) in the
traced window.  One reader for every cell's entry
(`call_host_us.<mix>`)."""

from spmv_bench.spans import OP_CALL, named

LAYER = "call"
UNIT = "us"
SOURCE = "program_span"


def read(run):
    calls = named(run.trace, OP_CALL)
    if not calls:
        return None
    return 1e6 * sum(e - s for s, e in calls) / len(calls)
