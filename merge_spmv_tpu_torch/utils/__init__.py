"""Harness utilities: result comparison, host RNG, device table, kernel
build and timers on the card."""

from merge_spmv_tpu_torch.utils.compare import compare_results, ulp_distance

__all__ = ["compare_results", "ulp_distance"]
