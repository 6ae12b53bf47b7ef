"""The system under test: merge_spmv_tpu_torch, and the only module of
the benchmark that imports it.

A configuration's ``entry`` names the package's function that builds
the operator and a traffic mix's ``solver`` a function of
``models/solvers.py``; both are looked up by name.  The benchmark hands
the program a host ``CsrMatrix`` of the arrays its generator made, and
reads back only the program's outputs, its ``op.setup_s`` spans and its
``SolveInfo``.
"""

from __future__ import annotations


class Program:
    name = "program"

    def build(self, host_csr: dict, config: dict, device):
        """The operator of ``config["entry"]`` over the host CSR."""
        import merge_spmv_tpu_torch as pkg

        csr = pkg.CsrMatrix.from_arrays(
            host_csr["num_rows"], host_csr["num_cols"],
            host_csr["row_offsets"], host_csr["col_indices"],
            host_csr["values"])
        return getattr(pkg, config["entry"])(csr, dtype=config["dtype"],
                                             device=device)

    def solve(self, solver: str, op, b, **kwargs):
        """(x, iterations, host_reads, step_ms) of ``solver(op, b, ...)``."""
        from merge_spmv_tpu_torch.models import solvers

        x, info = getattr(solvers, solver)(op, b, **kwargs)
        return x, int(info.iterations), info.host_reads, info.step_ms

    @staticmethod
    def setup_spans(op) -> dict:
        """The program's own set-up spans, seconds by name."""
        return dict(getattr(op, "setup_s", {}) or {})
