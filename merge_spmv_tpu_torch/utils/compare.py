"""Length-scaled ULP result comparison (parity: utils.h:672-808).

The reference tolerance model reinterprets each float as its int32 bit
pattern and fails when ``sqrt(|int_a - int_b|) > len`` — i.e. the allowed ULP
distance grows with the square of the vector length, absorbing
reduction-order differences between parallel backends and the sequential
gold.  fp64 results are deliberately verified only to fp32 ULP distance
(utils.h:726-728): both operands are downcast to float32 first.  Integer and
other dtypes compare exactly (utils.h:672-686).

Deviation from the reference (deliberate): the length term is capped at
``ULP_LEN_CAP`` so the rule cannot go vacuous for long vectors.  The raw
reference rule can never fail once ``len`` exceeds ~46K (the sqrt of the
maximum possible int32 bit distance), which silently green-lights any
output at the 1M-row benchmark sizes this framework verifies at.  A
relative-error escape hatch keeps legitimately order-sensitive large
reductions passing: an element only fails when it is BOTH far in ULP space
and far in relative terms.
"""

from __future__ import annotations

import numpy as np

__all__ = ["ulp_distance", "compare_results", "max_ulp_distance",
           "ULP_LEN_CAP"]

# Cap on the length term of the reference rule sqrt(int_diff) > len.
# 1024**2 = 1.05M ulps (~1/8 binade, ~9 % relative error for normal
# floats) — generous for reduction-order noise (typically tens to
# hundreds of ULPs) but finite at any vector length, so a genuinely
# corrupted element always fails.
ULP_LEN_CAP = 1024

# Escape hatch: elements within this relative error never fail, even past
# the ULP threshold (guards huge-magnitude accumulations where ULP spacing
# is coarse relative to the value).
REL_TOL = 1e-4

# Backward-error escape: when the caller supplies the per-element
# condition scale (|alpha|*|A|@|x| + |beta*y_in| for SpMV — the standard
# backward-error bound), elements within BWD_TOL of that scale pass.
# Guards catastrophic-cancellation rows, whose tiny sums cannot be
# resolved to many ULPs by ANY reduction order (fp32 eps * a ~4K-item
# accumulation).
BWD_TOL = 4096 * np.finfo(np.float32).eps


def ulp_distance(computed, reference):
    """Per-element ULP distance after downcast to float32."""
    a = np.asarray(computed, dtype=np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(reference, dtype=np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def max_ulp_distance(computed, reference) -> int:
    d = ulp_distance(computed, reference)
    return int(d.max()) if d.size else 0


def compare_results(computed, reference, verbose: bool = True,
                    abs_bound=None):
    """Returns None if equivalent, else the index of the first failure.

    Float/double inputs use the capped length-scaled ULP rule
    (``sqrt(int_diff) > min(len, ULP_LEN_CAP)`` fails, unless the element
    is within REL_TOL relative error, or within BWD_TOL of the caller's
    per-element ``abs_bound`` condition scale); everything else compares
    exactly.
    """
    computed = np.asarray(computed)
    reference = np.asarray(reference)
    if computed.shape != reference.shape:
        raise ValueError(f"shape mismatch: {computed.shape} vs {reference.shape}")
    n = computed.size
    if computed.dtype.kind == "f" or reference.dtype.kind == "f":
        c = computed.ravel().astype(np.float64)
        r = reference.ravel().astype(np.float64)
        int_diff = ulp_distance(computed.ravel(), reference.ravel())
        thresh = min(n, ULP_LEN_CAP)
        ulp_bad = np.sqrt(int_diff.astype(np.float64)) > thresh
        with np.errstate(invalid="ignore"):
            rel_ok = np.abs(c - r) <= REL_TOL * np.maximum(np.abs(c),
                                                           np.abs(r))
        # NaN/Inf mismatches must fail: rel_ok is False for them by
        # construction (NaN comparisons are False)
        bad = ulp_bad & ~rel_ok
        if abs_bound is not None:
            scale = np.asarray(abs_bound, dtype=np.float64).ravel()
            bad &= ~(np.abs(c - r) <= BWD_TOL * scale)
    else:
        bad = computed.ravel() != reference.ravel()
    if not bad.any():
        return None
    idx = int(np.argmax(bad))
    if verbose:
        print(f"INCORRECT: [{idx}]: {computed.ravel()[idx]!r} != "
              f"{reference.ravel()[idx]!r}")
    return idx


def assert_allclose_ulp(computed, reference, context: str = "",
                        abs_bound=None):
    """Assertion wrapper for tests: raises with diagnostics on mismatch."""
    idx = compare_results(computed, reference, verbose=False,
                          abs_bound=abs_bound)
    if idx is not None:
        c = np.asarray(computed).ravel()
        r = np.asarray(reference).ravel()
        d = ulp_distance(c, r)
        raise AssertionError(
            f"{context} mismatch at [{idx}]: computed={c[idx]!r} "
            f"reference={r[idx]!r} ulp={d[idx]} max_ulp={d.max()} "
            f"threshold=sqrt(ulp)<={min(c.size, ULP_LEN_CAP)}")
