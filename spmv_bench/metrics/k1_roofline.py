"""K1's share of its roofline: the least time of the products y = alpha
A x + beta y_in (y = A p inside CG) that the traced window asked for,
over K1's device seconds there
(`csrc/merge_csrmv.cu::merge_tile_kernel`; `roofline.kernel_share_pct`).
At k = 1 a product is one launch.  One reader for every cell's entry
(`k1_roofline.<mix>`)."""

from spmv_bench.roofline import kernel_share_pct

LAYER = "tile kernel K1"
UNIT = "%"
SOURCE = "device_trace"
KERNEL = "merge_tile_kernel"


def read(run):
    return kernel_share_pct(run, KERNEL)
