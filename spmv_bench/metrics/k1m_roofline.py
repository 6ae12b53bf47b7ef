"""K1m's share of its roofline: the least time of the products
Y = A X (k columns, beta = 0) that the traced window asked for, over
K1m's device seconds there (`csrc/merge_csrmm.cu::merge_tile_mm_kernel`;
`roofline.kernel_share_pct`).  K1m takes k above 64 as a launch a block
of 64 columns, and the share counts the whole product.  One reader for
every cell's entry (`k1m_roofline.<mix>`)."""

from spmv_bench.roofline import kernel_share_pct

LAYER = "tile kernel K1m"
UNIT = "%"
SOURCE = "device_trace"
KERNEL = "merge_tile_mm_kernel"


def read(run):
    return kernel_share_pct(run, KERNEL)
