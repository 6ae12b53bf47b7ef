"""Host-side sparse-matrix data layer: COO/CSR containers, Matrix Market
ingest, synthetic generators and graph statistics (NumPy)."""

from merge_spmv_tpu_torch.formats.coo import CooMatrix
from merge_spmv_tpu_torch.formats.csr import CsrMatrix
from merge_spmv_tpu_torch.formats.stats import GraphStats

__all__ = ["CooMatrix", "CsrMatrix", "GraphStats"]
