"""Structure probe: which operator should a user build for this matrix?

Counterpart of merge_spmv_tpu/ops/suggest.py.  The default contract is the
reference's (no preprocessing, merge-path CsrMV for everything), and three
documented opt-in splits trade one-time setup for per-call speed:

* DIA        — dense diagonals (stencil/banded-exact classes), ops/dia.py
* hot/cold   — power-law column popularity (kron/webbase), ops/split.py
* banded     — wide diagonal-local scatter (circuit class), ops/split.py

``suggest_backend`` runs the host-side structure probes (histogram passes
over col_indices, no device work) and names the operator whose win
condition the matrix matches; ``build_suggested`` builds it with the
port's builders.  The decision ladder and its thresholds are the JAX
package's, set on a TPU; whether each split beats the merge operator on
the card is measured by chip_smoke.py (PERF.md), not assumed here.
"""

from __future__ import annotations

import inspect

import numpy as np

from merge_spmv_tpu_torch.formats.csr import CsrMatrix
from merge_spmv_tpu_torch.ops.dia import (build_dia_operator,
                                          diagonal_assignment)
from merge_spmv_tpu_torch.ops.operator import build_operator
from merge_spmv_tpu_torch.ops.split import (_row_ids, build_hotcold_operator,
                                            build_split_operator,
                                            popularity_assignment)

__all__ = ["suggest_backend", "build_suggested"]


def suggest_backend(csr: CsrMatrix) -> dict:
    """Probe structure, return {"backend", "why", ...probe stats}.

    Decision ladder (first match wins):
      1. ≥90 % of nonzeros on ≤32 dense diagonals        → "dia"
      2. popularity split selects a hot set of ≥30 %      → "hotcold"
      3. 90th-percentile |col−row| beyond 32K columns     → "split"
      4. otherwise                                        → "merge"
    """
    row_ids = _row_ids(csr)
    offsets, dmask = diagonal_assignment(csr, min_coverage=0.9,
                                         row_ids=row_ids)
    if offsets.size:
        cov = float(dmask.mean())
        return {"backend": "dia", "diagonals": int(offsets.size),
                "coverage": round(cov, 3),
                "why": f"{offsets.size} dense diagonals hold "
                       f"{100 * cov:.0f}% of the nonzeros"}
    hot_mask, hot_windows = popularity_assignment(csr)
    # a marginal hot set does not pay for the second launch
    if hot_windows.size and float(hot_mask.mean()) >= 0.3:
        cov = float(hot_mask.mean())
        return {"backend": "hotcold", "hot_windows": int(hot_windows.size),
                "coverage": round(cov, 3),
                "why": f"{hot_windows.size} popular column windows hold "
                       f"{100 * cov:.0f}% of the nonzeros"}
    if csr.num_nonzeros:
        d = np.abs(csr.col_indices.astype(np.int64, copy=False) - row_ids)
        spread = int(np.quantile(d, 0.9))
        if spread > 32 * 1024:
            return {"backend": "split", "p90_distance": spread,
                    "why": f"90th-percentile column distance {spread} "
                           "spans the streaming-x budget"}
    return {"backend": "merge",
            "why": "no split precondition holds; the no-preprocessing "
                   "merge path is the right default"}


def build_suggested(csr: CsrMatrix, dtype="float32", **kwargs):
    """Build the operator ``suggest_backend`` names; returns (op, record).

    ``kwargs`` (``device=`` among them) go to whichever builder the probe
    picks, but only those its signature accepts: the caller cannot know
    the backend in advance, so a tuning kwarg for one backend must not
    crash another.
    """
    rec = suggest_backend(csr)
    builder, extra = {
        "dia": (build_dia_operator, {}),
        "hotcold": (build_hotcold_operator, {}),
        "split": (build_split_operator, {"edges_chunks": "quantile"}),
        "merge": (build_operator, {}),
    }[rec["backend"]]
    accepted = set(inspect.signature(builder).parameters)
    kw = {k: v for k, v in kwargs.items() if k in accepted}
    return builder(csr, dtype=dtype, **extra, **kw), rec
