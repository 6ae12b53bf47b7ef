"""Generate the 103-matrix statistics corpus (.mtx files) — the port's copy
of the TPU package's tools/make_corpus_stats.py (the same names, seeds and
arrays).

The reference's acceptance test is the 4,201-matrix SuiteSparse sweep
(eval_csrmv.sh:8-17, paper §IV Fig. 9).  The SuiteSparse files are not in
the repository and fetching them needs the network, so this writes a
structurally varied >=100-row synthetic corpus spanning the paper's two
statistical axes:

  * size: 0.45M .. 11M nonzeros (runtime-vs-nnz linearity, Fig. 9b);
  * row-length CoV: 0 (grids/banded) .. ~1000 (wheel) via a power-law
    alpha sweep (GFLOP/s-vs-CoV skew invariance, Fig. 9a);

plus independent axes the UF collection also covers: column locality
(banded -> global scatter), in-degree skew (hub columns), rectangular,
empty-row-heavy, dense-as-sparse, diagonal, block-community, and
kron-like adversaries.  Every matrix is >= 450k nnz so no row sits at
the per-launch floor.

    python -m merge_spmv_tpu_torch.tools.make_corpus_stats <out-dir>
        [--list-only] [--only NAME,...]
"""

import argparse
import os
import sys

import numpy as np

from merge_spmv_tpu_torch.formats.coo import CooMatrix
from merge_spmv_tpu_torch.utils.hostmem import enable_warm_heap


def _coo(n_rows, n_cols, rows, cols, vals):
    return CooMatrix(n_rows, n_cols, rows, cols, vals)


def banded(n, half_bw, deg, seed):
    r = np.random.RandomState(seed)
    rows = np.repeat(np.arange(n, dtype=np.int64), deg)
    cols = np.clip(rows + r.randint(-half_bw, half_bw + 1, rows.size),
                   0, n - 1)
    return _coo(n, n, rows, cols, r.uniform(0.1, 1, rows.size))


def powerlaw_local(n, alpha, mean_deg, spread, seed):
    """Power-law ROW lengths with row-local columns: the CoV axis swept
    independently of column locality (conflating them makes the skew
    statistic unreadable)."""
    r = np.random.RandomState(seed)
    raw = r.pareto(alpha, n) + 1.0
    degs = np.maximum(1, (raw * (mean_deg * n / raw.sum())).astype(np.int64))
    rows = np.repeat(np.arange(n, dtype=np.int64), degs)
    cols = np.clip(rows + r.randint(-spread, spread, rows.size), 0, n - 1)
    return _coo(n, n, rows, cols, r.uniform(0.1, 1, rows.size))


def uniform_spread(n, deg, spread, seed):
    """Uniform rows, column-locality axis: spread = half-width of the
    row-relative column window (n => effectively global)."""
    r = np.random.RandomState(seed)
    rows = np.repeat(np.arange(n, dtype=np.int64), deg)
    cols = np.clip(rows + r.randint(-spread, spread, rows.size), 0, n - 1)
    return _coo(n, n, rows, cols, r.uniform(0.1, 1, rows.size))


def hub_cols(n, hubs, hub_frac, deg, seed):
    """Power-law IN-degree (hub columns): webbase/kron column class."""
    r = np.random.RandomState(seed)
    rows = np.repeat(np.arange(n, dtype=np.int64), deg)
    hub = r.choice(n, hubs, replace=False)
    is_hub = r.random(rows.size) < hub_frac
    cols = np.where(is_hub, hub[r.randint(0, hubs, rows.size)],
                    r.randint(0, n, rows.size))
    return _coo(n, n, rows, cols, r.uniform(0.1, 1, rows.size))


def tridiag(n):
    i = np.arange(n, dtype=np.int64)
    rows = np.concatenate([i, i[1:], i[:-1]])
    cols = np.concatenate([i, i[1:] - 1, i[:-1] + 1])
    vals = np.concatenate([np.full(n, 2.0), np.full(n - 1, -1.0),
                           np.full(n - 1, -1.0)])
    return _coo(n, n, rows, cols, vals)


def empty_heavy(n, populated, deg, seed):
    r = np.random.RandomState(seed)
    pick = np.sort(r.choice(n, populated, replace=False))
    rows = np.repeat(pick.astype(np.int64), deg)
    cols = np.clip(rows + r.randint(-4096, 4096, rows.size), 0, n - 1)
    return _coo(n, n, rows, cols, r.uniform(0.1, 1, rows.size))


def block_community(n, nblocks, deg, seed):
    r = np.random.RandomState(seed)
    bs = n // nblocks
    rows = np.repeat(np.arange(n, dtype=np.int64), deg)
    base = (rows // bs) * bs
    cols = np.clip(base + r.randint(0, bs, rows.size), 0, n - 1)
    return _coo(n, n, rows, cols, r.uniform(0.1, 1, rows.size))


def kron_like(n, nnz, seed):
    """Power-law rows AND columns, globally scattered — the hardest UF
    class for any gather-limited device (honest inclusion)."""
    r = np.random.RandomState(seed)
    pr = (r.pareto(1.4, nnz) * n / 8).astype(np.int64) % n
    pc = (r.pareto(1.4, nnz) * n / 8).astype(np.int64) % n
    return _coo(n, n, pr, pc, r.uniform(0.1, 1, nnz))


def rect_tall(n_rows, n_cols, deg, seed):
    r = np.random.RandomState(seed)
    rows = np.repeat(np.arange(n_rows, dtype=np.int64), deg)
    cols = r.randint(0, n_cols, rows.size)
    return _coo(n_rows, n_cols, rows, cols, r.uniform(0.1, 1, rows.size))


def build_gens():
    gens = {}
    s = 100   # deterministic seed counter

    def add(name, fn):
        assert name not in gens, name
        gens[name] = fn

    # 1. stencils (CoV ~ 0, perfect locality), size axis
    for w in (300, 500, 700, 900, 1100, 1400):
        add(f"grid2d_{w}", lambda w=w: CooMatrix.grid2d(w))
    for w in (50, 64, 80, 100, 116):
        add(f"grid3d_{w}", lambda w=w: CooMatrix.grid3d(w))

    # 2. banded uniform (locality x size x degree)
    for n in (1 << 16, 1 << 17, 1 << 18, 1 << 19, 1 << 20):
        for bw in (128, 1024, 4096):
            for deg in (5, 9):
                s += 1
                add(f"banded_n{n>>10}k_bw{bw}_d{deg}",
                    lambda n=n, bw=bw, deg=deg, s=s: banded(n, bw, deg, s))

    # 3. power-law rows, local columns: the CoV sweep (Fig. 9a axis)
    for n in (1 << 17, 1 << 18, 1 << 19, 1 << 20):
        for alpha in (1.2, 1.5, 1.8, 2.2, 3.0):
            s += 1
            add(f"plaw_n{n>>10}k_a{str(alpha).replace('.', 'p')}",
                lambda n=n, a=alpha, s=s: powerlaw_local(n, a, 8, 2048, s))

    # 4. uniform rows, locality sweep (spread axis, independent of CoV)
    for spread in (512, 4096, 32768, 1 << 18):
        s += 1
        add(f"uspread_{spread}",
            lambda sp=spread, s=s: uniform_spread(1 << 18, 8, sp, s))
    for deg in (2, 4, 16, 32):
        s += 1
        add(f"udeg_{deg}",
            lambda d=deg, s=s: uniform_spread(1 << 18, d, 4096, s))

    # 5. wheel adversaries at measurable scale (hub row spans many tiles)
    for spokes in (1 << 20, 1 << 21, 1 << 22):
        add(f"wheel_{spokes>>20}m", lambda sp=spokes: CooMatrix.wheel(sp))

    # 6. dense-as-sparse
    add("dense_1000", lambda: CooMatrix.dense(1000, 1000))
    add("dense_4000x250", lambda: CooMatrix.dense(4000, 250))
    add("dense_250x4000", lambda: CooMatrix.dense(250, 4000))
    add("dense_2000", lambda: CooMatrix.dense(2000, 2000))

    # 7. diagonal / tridiagonal chains
    for n in (1 << 20, 1 << 22):
        s += 1
        add(f"diag_{n>>20}m", lambda n=n, s=s: _coo(
            n, n, np.arange(n), np.arange(n),
            np.random.RandomState(s).uniform(0.1, 1, n)))
    for n in (1 << 19, 1 << 21):
        add(f"tridiag_{n>>10}k", lambda n=n: tridiag(n))

    # 8. hub-column in-degree skew (popularity class)
    for hubs, frac in ((64, 0.3), (64, 0.6), (1024, 0.3), (1024, 0.6)):
        s += 1
        add(f"hub_{hubs}_f{int(frac*10)}",
            lambda h=hubs, f=frac, s=s: hub_cols(1 << 18, h, f, 8, s))

    # 9. rectangular
    s += 1
    add("tall_2m_x_1k", lambda s=s: rect_tall(1 << 21, 1024, 1, s))
    s += 1
    add("tall_512k_x_4k", lambda s=s: rect_tall(1 << 19, 4096, 3, s))
    s += 1
    add("wide_1k_x_512k", lambda s=s: _coo(
        1024, 1 << 19,
        np.repeat(np.arange(1024, dtype=np.int64), 1024),
        np.random.RandomState(s).randint(0, 1 << 19, 1024 * 1024),
        np.random.RandomState(s + 1).uniform(0.1, 1, 1024 * 1024)))

    # 10. empty-row heavy
    for n, pop in ((1 << 20, 150000), (1 << 21, 200000)):
        s += 1
        add(f"empties_n{n>>20}m_p{pop>>10}k",
            lambda n=n, p=pop, s=s: empty_heavy(n, p, 4, s))

    # 11. block communities
    for nb in (16, 256, 4096):
        s += 1
        add(f"blocks_{nb}", lambda nb=nb, s=s: block_community(
            1 << 19, nb, 6, s))

    # 12. scatter adversaries (honest hard rows; bounded count)
    s += 1
    add("kron_like_512k", lambda s=s: kron_like(1 << 19, 1 << 19, s))
    s += 1
    add("kron_like_1m", lambda s=s: kron_like(1 << 20, 1 << 20, s))
    s += 1
    add("uglobal_512k", lambda s=s: uniform_spread(1 << 19, 2, 1 << 19, s))

    # 13. extra CoV points with WIDER locality (spread x skew interaction)
    for alpha in (1.3, 1.6, 2.0):
        s += 1
        add(f"plaw_wide_a{str(alpha).replace('.', 'p')}",
            lambda a=alpha, s=s: powerlaw_local(1 << 19, a, 8, 16384, s))
    for w in (400, 800):
        add(f"grid2d_{w}", lambda w=w: CooMatrix.grid2d(w))
    add("grid3d_90", lambda: CooMatrix.grid3d(90))

    # 14. powerlaw generators from the framework itself
    s += 1
    add("gen_powerlaw_1m", lambda s=s: CooMatrix.random_powerlaw(
        1 << 20, 1 << 20, 4 << 20, seed=s))
    s += 1
    add("gen_uniform_1m", lambda s=s: CooMatrix.random_uniform(
        1 << 20, 1 << 20, 6, seed=s))
    return gens


def main(argv=None):
    enable_warm_heap()
    ap = argparse.ArgumentParser()
    ap.add_argument("out_dir")
    ap.add_argument("--list-only", action="store_true")
    ap.add_argument("--only", default="",
                    help="comma list of corpus names to write (default: "
                         "all)")
    args = ap.parse_args(argv)
    gens = build_gens()
    if args.only:
        names = args.only.split(",")
        unknown = sorted(set(names) - set(gens))
        if unknown:
            ap.error(f"not in the corpus: {unknown}")
        gens = {k: gens[k] for k in names}
    print(f"{len(gens)} corpus matrices")
    if args.list_only:
        for name in sorted(gens):
            print(" ", name)
        return 0
    os.makedirs(args.out_dir, exist_ok=True)
    total_nnz = 0
    for name, gen in sorted(gens.items()):
        path = os.path.join(args.out_dir, name + ".mtx")
        if os.path.exists(path):
            print(f"skip {name}", flush=True)
            continue
        m = gen()
        m.to_market(path)
        total_nnz += m.num_nonzeros
        print(f"wrote {name}: {m.num_rows}x{m.num_cols} "
              f"nnz={m.num_nonzeros}", flush=True)
    print(f"total nnz written: {total_nnz}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
