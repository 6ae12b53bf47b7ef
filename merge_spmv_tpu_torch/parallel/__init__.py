"""Multi-process execution: global merge-path partitioning
(partition.py) and the SPMD CsrMV over a ``torch.distributed`` process
group (distributed.py), whose worker is ``mp_worker``.

The same diagonal search that splits tiles inside the card splits the
global (rows, nnz) merge path into per-rank shares; the row carries that
cross ranks are resolved by one reduce-scatter of S scalars.
"""

from merge_spmv_tpu_torch.parallel.partition import (MergePartition,
                                                     partition_csr)
from merge_spmv_tpu_torch.parallel.distributed import (
    PreparedDistributedCsrmv, ShareSplit, distributed_csrmv,
    distributed_csrmv_fn, materialize_y, prepare_distributed_csrmv)

__all__ = ["MergePartition", "partition_csr", "distributed_csrmv",
           "distributed_csrmv_fn", "prepare_distributed_csrmv",
           "PreparedDistributedCsrmv", "ShareSplit", "materialize_y"]
