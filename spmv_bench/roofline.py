"""Frozen byte and operation models of the products, and the card's
published peaks.

A product's bytes count each input read once and each output written
once: a value, a column index and a row end per nonzero and row of the
CSR, x (or X) once, y_in (or Y_in) once where beta is not 0, and y (or Y)
once.  Its operations are a multiply and an add per nonzero and
right-hand side, and the epilogue's alpha (and beta) per output.

The peaks are NVIDIA's data sheet figures for the H100 SXM part (dense,
no sparsity), at its 700 W power limit; a card set lower runs slower and
its ``power.limit`` is reported beside every share.
"""

from __future__ import annotations

INDEX_BYTES = 4

# (substring of torch.cuda.get_device_name, lower case) -> peaks
PEAKS = (
    ("h100 pcie", {"hbm_bytes_per_s": 2.0e12, "float64": 26.0e12,
                   "float32": 51.0e12}),
    ("h100", {"hbm_bytes_per_s": 3.35e12, "float64": 34.0e12,
              "float32": 67.0e12}),
)

VALUE_BYTES = {"float64": 8, "float32": 4}


def peaks(device_name: str):
    """The published peaks of the card named ``device_name``, or None for
    a card the table does not hold."""
    name = device_name.lower()
    for key, table in PEAKS:
        if key in name:
            return table
    return None


def product_bytes(rows: int, cols: int, nnz: int, k: int, dtype: str,
                  with_y_in: bool) -> int:
    """Bytes y = alpha A x + beta y_in must move for k right-hand sides."""
    v = VALUE_BYTES[dtype]
    a = nnz * (v + INDEX_BYTES) + rows * INDEX_BYTES
    vectors = cols * k * v + rows * k * v * (2 if with_y_in else 1)
    return a + vectors


def product_flops(rows: int, nnz: int, k: int, with_y_in: bool) -> int:
    """Operations of y = alpha A x + beta y_in for k right-hand sides."""
    return 2 * nnz * k + rows * k * (3 if with_y_in else 1)


def least_seconds(rows: int, cols: int, nnz: int, k: int, dtype: str,
                  with_y_in: bool, device_name: str):
    """(seconds, "bytes" | "operations") that bound one product on the
    card, or None where the card's peaks are unknown."""
    table = peaks(device_name)
    if table is None:
        return None
    t_bytes = product_bytes(rows, cols, nnz, k, dtype, with_y_in) \
        / table["hbm_bytes_per_s"]
    t_ops = product_flops(rows, nnz, k, with_y_in) / table[dtype]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_share_pct(run, name_part: str):
    """A kernel's roofline share in the traced window, in percent: the
    least time of the products the window asked for over the kernel's
    device seconds there.  A product is one of the cell's matrix with the
    traffic's whole ``k`` right-hand sides, y_in where its ``beta`` is not
    0; the loop counts them (``traced_products``).  So the share reads
    the same work however many launches make up a product (K1m takes k
    above 64 as a launch a block of 64 columns), and a kernel as slow as
    its bound reads at most 100.  None without a trace, a launch of the
    kernel, a product, or the card's peaks."""
    if run.trace is None:
        return None
    launches, seconds = run.trace.kernel(name_part)
    products = run.loop.traced_products
    p, t = run.cell.problem, run.cell.traffic
    least = least_seconds(p["num_rows"], p["num_cols"], p["nnz"],
                          int(t.get("k", 1)), p["dtype"],
                          float(t.get("beta", 0.0)) != 0.0, run.device_name)
    if not launches or not products or least is None:
        return None
    return 100.0 * least[0] * products / seconds
