"""Generate the local mini-corpus of .mtx files for the sweep — the port's
copy of the TPU package's tools/make_corpus.py (the same 25 files).

The reference's acceptance test is the 4,201-matrix SuiteSparse sweep
(eval_csrmv.sh, paper §IV); the SuiteSparse files are not in the
repository, so this tool writes a structurally varied corpus locally —
grids, wheels, power-law, uniform-random, dense, rectangular, banded, hub
columns (19 generated matrices), plus six hand-written symmetric /
skew-symmetric / pattern / array / integer banner variants to exercise
the parser paths (sparse_matrix.h:259-272 semantics).

    python -m merge_spmv_tpu_torch.tools.make_corpus <out-dir> [--large]
"""

import argparse
import os
import sys

import numpy as np

from merge_spmv_tpu_torch.formats.coo import CooMatrix
from merge_spmv_tpu_torch.utils.hostmem import enable_warm_heap


def write_banner_variant(path, banner, body_lines, comment="parser probe"):
    with open(path, "w") as f:
        f.write(f"%%MatrixMarket {banner}\n% {comment}\n")
        for line in body_lines:
            f.write(line + "\n")


def main(argv=None):
    enable_warm_heap()   # warm-page reuse for the generators' numpy
    ap = argparse.ArgumentParser()
    ap.add_argument("out_dir")
    ap.add_argument("--large", action="store_true",
                    help="include multi-million-nnz entries")
    args = ap.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)

    rs = np.random.RandomState(42)

    gens = {
        # stencils (uniform rows, banded columns)
        "grid2d_64": lambda: CooMatrix.grid2d(64),
        "grid2d_180": lambda: CooMatrix.grid2d(180),
        "grid3d_16": lambda: CooMatrix.grid3d(16),
        "grid3d_40": lambda: CooMatrix.grid3d(40),
        # skew adversaries
        "wheel_1k": lambda: CooMatrix.wheel(1000),
        "wheel_40k": lambda: CooMatrix.wheel(40000),
        "powerlaw_10k": lambda: CooMatrix.random_powerlaw(
            10000, 10000, 120000, seed=1),
        "powerlaw_rect": lambda: CooMatrix.random_powerlaw(
            8000, 5000, 60000, seed=2),
        # uniform random
        "uniform_5k_d8": lambda: CooMatrix.random_uniform(
            5000, 5000, 8, seed=3),
        "uniform_20k_d4": lambda: CooMatrix.random_uniform(
            20000, 20000, 4, seed=4),
        # dense-as-sparse
        "dense_256x512": lambda: CooMatrix.dense(256, 512),
        "dense_2048x64": lambda: CooMatrix.dense(2048, 64),
        # rectangular tall/wide
        "tall_100k_x_100": lambda: CooMatrix.random_uniform(
            100000, 100, 3, seed=5),
        "wide_100_x_100k": lambda: CooMatrix.random_uniform(
            100, 100000, 300, seed=6),
        # single row / col heavy shapes
        "one_dense_row": lambda: CooMatrix(
            5000, 5000, np.r_[np.zeros(5000, np.int64),
                              np.arange(1, 5000)],
            np.r_[np.arange(5000), rs.randint(0, 5000, 4999)],
            rs.uniform(0.1, 1, 9999)),
        "diag_50k": lambda: CooMatrix(
            50000, 50000, np.arange(50000), np.arange(50000),
            rs.uniform(0.1, 1, 50000)),
    }
    if args.large:
        gens.update({
            "grid3d_100": lambda: CooMatrix.grid3d(100),
            "powerlaw_1m": lambda: CooMatrix.random_powerlaw(
                1 << 20, 1 << 20, 16 << 20, seed=7),
            "uniform_1m_d16": lambda: CooMatrix.random_uniform(
                1 << 20, 1 << 20, 16, seed=8),
        })

    def banded(n, half_bw, nnz_per_row, seed):
        r = np.random.RandomState(seed)
        rows = np.repeat(np.arange(n, dtype=np.int64), nnz_per_row)
        cols = np.clip(rows + r.randint(-half_bw, half_bw + 1, rows.size),
                       0, n - 1)
        return CooMatrix(n, n, rows, cols, r.uniform(0.1, 1, rows.size))

    gens["banded_30k_bw200"] = lambda: banded(30000, 200, 6, 9)
    gens["banded_200k_bw1k"] = lambda: banded(200000, 1000, 5, 10)

    def hub_cols(n, hubs, hub_frac, deg, seed):
        """Power-law IN-degree (hub columns): the kron/webbase column
        class the hot/cold split keys on — here swept on the default
        merge path like every other corpus row."""
        r = np.random.RandomState(seed)
        rows = np.repeat(np.arange(n, dtype=np.int64), deg)
        hub = r.choice(n, hubs, replace=False)
        is_hub = r.random(rows.size) < hub_frac
        cols = np.where(is_hub, hub[r.randint(0, hubs, rows.size)],
                        r.randint(0, n, rows.size))
        return CooMatrix(n, n, rows, cols, r.uniform(0.1, 1, rows.size))

    gens["hubcols_60k"] = lambda: hub_cols(60000, 120, 0.6, 8, 11)

    for name, gen in sorted(gens.items()):
        path = os.path.join(args.out_dir, name + ".mtx")
        if os.path.exists(path):
            print(f"skip {name}")
            continue
        m = gen()
        m.to_market(path)
        print(f"wrote {name}: {m.num_rows}x{m.num_cols} nnz={m.num_nonzeros}")

    # Banner-variant probes (hand-written, exercise parser paths)
    bv = os.path.join
    write_banner_variant(
        bv(args.out_dir, "probe_symmetric.mtx"),
        "matrix coordinate real symmetric",
        ["5 5 6", "1 1 2.0", "2 1 -1.0", "3 2 -1.0", "4 3 -1.0",
         "5 4 -1.0", "5 5 2.0"])
    write_banner_variant(
        bv(args.out_dir, "probe_skew.mtx"),
        "matrix coordinate real skew-symmetric",
        ["4 4 3", "2 1 1.5", "3 2 -2.5", "4 1 0.5"])
    write_banner_variant(
        bv(args.out_dir, "probe_pattern.mtx"),
        "matrix coordinate pattern general",
        ["6 6 8", "1 2", "2 3", "3 4", "4 5", "5 6", "6 1", "1 4", "3 6"])
    write_banner_variant(
        bv(args.out_dir, "probe_pattern_sym.mtx"),
        "matrix coordinate pattern symmetric",
        ["5 5 5", "2 1", "3 2", "4 3", "5 4", "5 5"])
    write_banner_variant(
        bv(args.out_dir, "probe_array.mtx"),
        "matrix array real general",
        ["3 4"] + [repr(float(v)) for v in
                   rs.uniform(-1, 1, 12)])
    write_banner_variant(
        bv(args.out_dir, "probe_integer.mtx"),
        "matrix coordinate integer general",
        ["4 4 4", "1 1 3", "2 2 -2", "3 3 7", "4 4 1"])
    print("wrote 6 banner probes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
