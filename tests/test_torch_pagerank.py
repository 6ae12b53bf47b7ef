"""PageRank in the port: ``ops/operator.py::pagerank_operator`` (P = A^T
D^-1 of a link graph) and ``models/solvers.py::pagerank`` over it, held
on the CPU (the kernels' plain versions) to dense arithmetic and to the
plain reference ``models/pagerank_reference.py``, on seeded directed
graphs with dangling and isolated vertices; and the benchmark's
Graphalytics generator (``spmv_bench/generators/graph500.py``) at scales
10-12 against ``rmat.py``'s draws at the same seed.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import merge_spmv_tpu_torch
from merge_spmv_tpu_torch import pagerank_operator, transition_operator
from merge_spmv_tpu_torch.formats.coo import CooMatrix
from merge_spmv_tpu_torch.formats.csr import CsrMatrix
from merge_spmv_tpu_torch.models import pagerank_reference as R
from merge_spmv_tpu_torch.models import solvers as S
from merge_spmv_tpu_torch.ops import operator as O
from merge_spmv_tpu_torch.utils import tracing as T
from spmv_bench.generators import graph500, rmat

ROOT = Path(__file__).resolve().parents[1]
REFERENCE = ROOT / "merge_spmv_tpu_torch" / "models" / "pagerank_reference.py"
SEED = 20020101
PARAMS = {"edgefactor": 16, "a": 0.57, "b": 0.19, "c": 0.19}


def link_graph(n=600, links=4000, seed=SEED, dangling_every=7,
               isolated_every=11):
    """A directed graph on n vertices with no duplicate link and no
    self-loop: ``links`` draws of (u, v) by Zipf weights; every
    ``dangling_every``-th vertex has no out-link and every
    ``isolated_every``-th none at all (an empty row and column)."""
    rng = np.random.RandomState(seed)
    w = 1.0 / np.arange(1, n + 1) ** 0.7
    rng.shuffle(w)
    w[::isolated_every] = 0.0
    w /= w.sum()
    u = rng.choice(n, links, p=w)
    v = rng.choice(n, links, p=w)
    keep = (u != v) & (u % dangling_every != 0)
    pairs = np.unique(u[keep].astype(np.int64) * n + v[keep])
    u, v = pairs // n, pairs % n
    return CsrMatrix.from_coo(CooMatrix(n, n, u.astype(np.int32),
                                        v.astype(np.int32),
                                        np.ones(u.size)))


def dense_p(csr):
    """P[v, u] = a_uv / outdeg(u), dense, in float64."""
    a = csr.to_dense().astype(np.float64)
    out = a.sum(axis=1, keepdims=True)
    return np.divide(a, out, out=np.zeros_like(a), where=out != 0).T


def reference(csr, dtype=torch.float64, damping=0.85, iterations=10):
    return R.pagerank(torch.from_numpy(csr.row_offsets),
                      torch.from_numpy(csr.col_indices), damping,
                      iterations, dtype)


def test_pagerank_operator_is_exported():
    assert merge_spmv_tpu_torch.pagerank_operator is pagerank_operator
    assert "pagerank_operator" in merge_spmv_tpu_torch.__all__


@pytest.mark.parametrize("dtype,rtol", [("float64", 2.0 ** -52),
                                        ("float32", 2.0 ** -23)])
def test_pagerank_operator_is_the_transposed_column_stochastic_matrix(
        dtype, rtol):
    """P's product with I is dense A^T D^-1 to within one rounding of
    ``dtype``: the transpose is right; each column of a vertex with an
    out-link sums to 1 and a dangling vertex's column is empty; each row
    of P holds its columns in increasing order."""
    csr = link_graph()
    op = pagerank_operator(csr, dtype=dtype, device="cpu")
    want = dense_p(csr)
    eye = torch.eye(csr.num_cols, dtype=getattr(torch, dtype))
    got = op.mm(eye).double().numpy()
    np.testing.assert_allclose(got, want, rtol=2 * rtol, atol=0)
    assert np.array_equal(got != 0, want != 0)
    out_degree = np.diff(csr.row_offsets)
    dangling = out_degree == 0
    assert dangling.sum() >= csr.num_rows // 7
    sums = got.sum(axis=0)
    np.testing.assert_allclose(sums[~dangling], 1.0, rtol=64 * rtol)
    assert (sums[dangling] == 0).all()
    ends = op.row_end_offsets.long().numpy()
    cols = op.col_indices.long().numpy()
    starts = np.concatenate([[0], ends[:-1]])
    for s, e in zip(starts, ends):
        assert (np.diff(cols[s:e]) > 0).all()
    assert op.values.dtype == getattr(torch, dtype)


def test_pagerank_operator_values_are_the_float64_quotient_rounded():
    """Each stored value of the float32 operator is A's value over its
    row's sum, computed in float64, rounded once, at P's position."""
    csr = link_graph()
    rng = np.random.RandomState(5)
    csr = CsrMatrix.from_arrays(csr.num_rows, csr.num_cols, csr.row_offsets,
                                csr.col_indices,
                                rng.uniform(0.5, 2.0, csr.num_nonzeros))
    op = pagerank_operator(csr, dtype="float32", device="cpu")
    rows = np.repeat(np.arange(csr.num_rows), np.diff(csr.row_offsets))
    sums = np.bincount(rows, weights=csr.values, minlength=csr.num_rows)
    scaled = csr.values / sums[rows]
    order = np.argsort(csr.col_indices, kind="stable")
    assert np.array_equal(op.values.numpy(), scaled[order].astype(np.float32))
    assert np.array_equal(op.col_indices.numpy(), rows[order])


def test_pagerank_operator_plans_on_p_s_pattern(monkeypatch):
    """make_plan is handed P's columns (A's rows, after the transpose),
    not A's columns; the plan's shape is P's."""
    seen = []
    real = O.make_plan

    def spy(*args, **kwargs):
        seen.append(torch.as_tensor(kwargs["col_indices"]).clone())
        return real(*args, **kwargs)

    monkeypatch.setattr(O, "make_plan", spy)
    csr = link_graph()
    op = pagerank_operator(csr, dtype="float64", device="cpu")
    assert len(seen) == 1
    assert torch.equal(seen[0].long(), op.col_indices.long())
    assert not np.array_equal(seen[0].numpy(), csr.col_indices)
    rows = np.repeat(np.arange(csr.num_rows), np.diff(csr.row_offsets))
    assert np.array_equal(np.sort(seen[0].numpy()), np.sort(rows))
    assert op.shape == (csr.num_cols, csr.num_rows)


def test_pagerank_operator_times_its_phases_in_spans():
    """setup_s: the stochastic span inside prepare's first half, the plan,
    prepare's second half (prepare the sum of the two); under a profiler
    one stochastic span inside the first of two prepare spans, the plan
    between them."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        op = pagerank_operator(link_graph(), dtype="float64", device="cpu")
    assert list(op.setup_s) == ["stochastic", "prepare", "plan"]
    assert all(v >= 0.0 and round(v, 3) == v for v in op.setup_s.values())
    spans = [(e.name, e.time_range.start, e.time_range.end)
             for e in prof.events() if e.name.startswith("merge_spmv.build")]
    names = [s[0] for s in sorted(spans, key=lambda s: s[1])]
    assert names == [T.BUILD_PREPARE, T.BUILD_STOCHASTIC, T.BUILD_PLAN,
                     T.BUILD_PREPARE]
    first = min((s for s in spans if s[0] == T.BUILD_PREPARE),
                key=lambda s: s[1])
    inner = next(s for s in spans if s[0] == T.BUILD_STOCHASTIC)
    assert first[1] <= inner[1] and inner[2] <= first[2]


def test_pagerank_operator_refuses_a_graph_that_is_not_square():
    coo = CooMatrix(4, 5, np.array([0, 1], np.int32),
                    np.array([4, 2], np.int32), np.ones(2))
    with pytest.raises(ValueError, match="square"):
        pagerank_operator(CsrMatrix.from_coo(coo), device="cpu")


def test_symmetric_graph_gives_a_d_inverse():
    """On an undirected graph P = A D^-1: the transpose of the transition
    operator's D^-1 A, value for value."""
    csr = link_graph()
    a = csr.to_dense()
    sym = ((a + a.T) > 0).astype(np.float64)
    rows, cols = np.nonzero(sym)
    csr = CsrMatrix.from_coo(CooMatrix(sym.shape[0], sym.shape[1],
                                       rows.astype(np.int32),
                                       cols.astype(np.int32), sym[rows, cols]))
    eye = torch.eye(csr.num_cols, dtype=torch.float64)
    p = pagerank_operator(csr, dtype="float64", device="cpu").mm(eye)
    d_inv_a = transition_operator(csr, dtype="float64", device="cpu").mm(eye)
    assert torch.equal(p, d_inv_a.T)


# the L1 distance sum_v |pr_v - pr_ref,v| allowed: the ranks sum to 1 and
# each step rounds each of them a few times, in another order than the
# reference, so the distance is a few units of roundoff in all: float64
# read 0.9e-16 to 1.4e-16 here, float32 6.5e-8 to 8.7e-8 (the float32
# reference against the float64 one ~2e-7, 1e9 times the float64 reading)
L1 = {"float64": 1e-14, "float32": 1e-6}


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("seed", [SEED, SEED + 1])
def test_pagerank_agrees_with_the_reference(dtype, seed):
    """pagerank(op, 0.85, tol=0, maxiter=10) over pagerank_operator: 10
    iterations exactly, one flag read at check_every 16, the ranks within
    ``L1`` of the float64 reference, dangling vertices included; their
    sum stays 1."""
    csr = link_graph(seed=seed)
    op = pagerank_operator(csr, dtype=dtype, device="cpu")
    pr, info = S.pagerank(op, 0.85, tol=0.0, maxiter=10)
    want = reference(csr)
    assert int(info.iterations) == 10 and info.host_reads == 1
    assert pr.dtype == getattr(torch, dtype)
    err = float((pr.double() - want).abs().sum())
    assert err <= L1[dtype], err
    assert abs(float(pr.double().sum()) - 1.0) <= L1[dtype]
    assert abs(float(want.sum()) - 1.0) <= 1e-14


def test_the_float32_reference_is_far_from_the_float64_one():
    """The control the benchmark puts in the program's place differs from
    the float64 reference by orders of magnitude more than the float64
    program does, so a check between the two readings rejects it."""
    csr = link_graph()
    err = float((reference(csr, torch.float32).double()
                 - reference(csr)).abs().sum())
    assert err > 1000 * L1["float64"]


def test_reference_takes_the_dangling_term_explicitly():
    """Against a dense power iteration written from the specification:
    PR_i = (1 - d)/n + d P PR_{i-1} + (d/n) sum of the dangling ranks."""
    csr = link_graph(200, 900)
    p = dense_p(csr)
    dangling = np.diff(csr.row_offsets) == 0
    n = csr.num_rows
    pr = np.full(n, 1.0 / n)
    for _ in range(10):
        pr = (1 - 0.85) / n + 0.85 * p @ pr + 0.85 / n * pr[dangling].sum()
    assert float(np.abs(reference(csr).numpy() - pr).sum()) <= 1e-14
    # the dangling term carries a share of the mass the check can see
    assert 0.85 / n * pr[dangling].sum() * n > 1e-2


def test_reference_imports_only_torch():
    tree = ast.parse(REFERENCE.read_text())
    imported = {alias.name.split(".")[0] for node in ast.walk(tree)
                if isinstance(node, ast.Import) for alias in node.names}
    imported |= {node.module.split(".")[0] for node in ast.walk(tree)
                 if isinstance(node, ast.ImportFrom) and node.module}
    assert imported <= {"torch", "__future__"}


def _pairs(csr):
    o = csr["row_offsets"]
    rows = torch.repeat_interleave(torch.arange(csr["num_rows"]),
                                   o[1:] - o[:-1])
    return rows, csr["col_indices"].long()


@pytest.mark.parametrize("scale", [10, 11, 12])
def test_graph500_is_graphalytics_conversion_of_the_rmat_draws(scale):
    """The graph is rmat.py's 16 x 2^scale draws at the same seed with
    self-loops dropped, mirrored, duplicates dropped and isolated
    vertices dropped (ids kept in order): symmetric, no self-loop, no
    duplicate, no empty row, every value 1."""
    params = dict(PARAMS, scale=scale)
    g = graph500.generate(params, SEED, "cpu")
    n = g["num_rows"]
    rows, cols = _pairs(g)
    keys = rows * n + cols
    assert g["num_cols"] == n
    assert bool((keys[1:] > keys[:-1]).all())           # sorted, no duplicate
    assert not bool((rows == cols).any())
    assert torch.equal(torch.sort(cols * n + rows).values, keys)
    assert bool((g["row_offsets"][1:] > g["row_offsets"][:-1]).all())
    assert bool((g["values"] == 1.0).all())
    assert g["values"].dtype == torch.float64
    assert g["col_indices"].dtype == torch.int32

    drawn = rmat.generate({"scale": scale, "nnz": 16 << scale, "a": 0.57,
                           "b": 0.19, "c": 0.19, "values": [1.0, 1.0]},
                          SEED, "cpu")
    u, v = _pairs(drawn)
    keep = u != v
    lo, hi = torch.minimum(u, v)[keep], torch.maximum(u, v)[keep]
    edges = torch.unique(lo * (1 << scale) + hi)
    ends = torch.unique(torch.cat([lo, hi]))
    assert n == ends.numel()
    assert g["values"].numel() == 2 * edges.numel()
    relabel = torch.full((1 << scale,), -1, dtype=torch.int64)
    relabel[ends] = torch.arange(n)
    a, b = relabel[edges >> scale], relabel[edges & ((1 << scale) - 1)]
    want = torch.sort(torch.cat([a * n + b, b * n + a])).values
    assert torch.equal(want, keys)


def test_graph500_is_seeded_and_keeps_most_draws():
    """The same seed gives the same graph, another seed another; at
    scale 12 the undirected edges are 16 x 2^12 draws less self-loops
    and duplicates, which at this small scale are a few tens of percent
    (at scale 24 Graphalytics keeps 97%)."""
    params = dict(PARAMS, scale=12)
    g = graph500.generate(params, SEED, "cpu")
    again = graph500.generate(params, SEED, "cpu")
    assert all(torch.equal(g[k], again[k]) for k in
               ("row_offsets", "col_indices", "values"))
    other = graph500.generate(params, SEED + 1, "cpu")
    assert not torch.equal(g["col_indices"][:1000],
                           other["col_indices"][:1000])
    edges = g["values"].numel() // 2
    assert 0.5 * (16 << 12) <= edges <= 16 << 12
    assert 0.4 * (1 << 12) <= g["num_rows"] <= 1 << 12
