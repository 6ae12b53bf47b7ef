"""FastRP in the port: ``ops/operator.py::transition_operator`` (P = D^-1 A)
and ``models/solvers.py::fastrp``, held on the CPU (the kernels' plain
versions) to dense arithmetic and to the plain reference
``models/fastrp_reference.py``, at 2^10-2^12 vertices from a seed; the
normalise-and-accumulate wrapper (``models/fastrp_cuda.py``): its plain
version bit for bit against the torch code the solver ran before it, its
path choice and its operand checks.  The kernel itself runs only on the
card (tests/test_torch_cuda.py).

The ``cuda``-marked case holds the card's K1m path to the same reference
at 2^16 vertices and skips without a card; run it there with

    python -m pytest --noconftest tests/test_torch_fastrp.py -m cuda -q
"""

import ast
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from merge_spmv_tpu_torch import transition_operator
from merge_spmv_tpu_torch.formats.coo import CooMatrix
from merge_spmv_tpu_torch.formats.csr import CsrMatrix
from merge_spmv_tpu_torch.models import fastrp_cuda as F
from merge_spmv_tpu_torch.models import fastrp_reference as R
from merge_spmv_tpu_torch.models import solvers as S
from merge_spmv_tpu_torch.utils import tracing as T

ROOT = Path(__file__).resolve().parents[1]
REFERENCE = ROOT / "merge_spmv_tpu_torch" / "models" / "fastrp_reference.py"
SEED = 20191908


def graph(n=2048, edges=12000, seed=SEED, isolated_every=17,
          symmetric=True, values="ones"):
    """A power-law graph on n vertices: ``edges`` draws of (u, v) by Zipf
    weights, mirrored when ``symmetric``, duplicates and self-loops kept;
    every ``isolated_every``-th vertex has no edge (an empty row)."""
    rng = np.random.RandomState(seed)
    w = 1.0 / np.arange(1, n + 1) ** 0.8
    rng.shuffle(w)
    w[::isolated_every] = 0.0
    w /= w.sum()
    u = rng.choice(n, edges, p=w)
    v = rng.choice(n, edges, p=w)
    rows, cols = (np.concatenate([u, v]), np.concatenate([v, u])) \
        if symmetric else (u, v)
    vals = np.ones(rows.size) if values == "ones" else \
        rng.uniform(0.5, 2.0, rows.size)
    return CsrMatrix.from_coo(CooMatrix(n, n, rows.astype(np.int32),
                                        cols.astype(np.int32), vals))


def projection(n, d, seed=SEED, dtype=torch.float64):
    """FastRP's very sparse projection: +-sqrt(3) with probability 1/6
    each, else 0."""
    u = torch.rand((n, d), generator=torch.Generator().manual_seed(seed),
                   dtype=torch.float64)
    s3 = 3.0 ** 0.5
    return torch.where(u < 1 / 6, s3, torch.where(u >= 5 / 6, -s3, 0.0)
                       ).to(dtype)


def dense_transition(csr):
    a = csr.to_dense().astype(np.float64)
    sums = a.sum(axis=1, keepdims=True)
    return np.divide(a, sums, out=np.zeros_like(a), where=sums != 0)


def reference(csr, r, weights, dtype=torch.float64):
    return R.fastrp(torch.from_numpy(csr.row_offsets),
                    torch.from_numpy(csr.col_indices),
                    torch.from_numpy(csr.values), r, weights, dtype)


def degrees(csr):
    return np.diff(csr.row_offsets)


def tolerance(csr, weights, unit):
    """The bound on |E - E_ref| entry by entry, in ``unit`` (the program's
    unit roundoff): a product's row is a mean of at most max-degree terms
    of size at most 1 (n's rows have norm 1, R's entries sqrt(3)), summed
    in another order than the reference, and the roundings of such a sum
    have mixed signs, so they grow as sqrt(max degree) u; each of the
    len(w) products carries the error before it, and E adds sum |w| rows
    of norm 1; 4x for the tail over every entry.  Read on the CPU
    (2048 vertices, max degree 1378): float64 1-3 u against ~900 u here,
    float32 7 u against ~900 u, the same reference in bfloat16 ~6e4 u."""
    w = np.abs(np.asarray(weights))
    return 4.0 * len(w) * w.sum() * np.sqrt(degrees(csr).max()) * unit


@pytest.mark.parametrize("dtype,rtol", [("float64", 2.0 ** -52),
                                        ("float32", 2.0 ** -23)])
@pytest.mark.parametrize("values", ["ones", "weighted"])
def test_transition_operator_is_dense_d_inverse_a(dtype, rtol, values):
    """Each stored value of the operator is A's over its row's sum to
    within one rounding of ``dtype`` (float64: the row sums' order;
    float32: the rounding of the float64 quotient), in A's positions;
    the product with I is dense D^-1 A to within a rounding a stored
    duplicate; empty rows stay empty."""
    csr = graph(1024, 5000, values=values)
    op = transition_operator(csr, dtype=dtype, device="cpu")
    rows = np.repeat(np.arange(csr.num_rows), degrees(csr))
    sums = np.bincount(rows, weights=csr.values, minlength=csr.num_rows)
    np.testing.assert_allclose(op.values.double().numpy(),
                               csr.values / sums[rows], rtol=rtol, atol=0)
    assert np.array_equal(op.col_indices.numpy(), csr.col_indices)
    assert np.array_equal(op.row_end_offsets.numpy(), csr.row_offsets[1:])
    empty = degrees(csr) == 0
    assert empty.sum() >= csr.num_rows // 17
    want = dense_transition(csr)
    eye = torch.eye(csr.num_cols, dtype=getattr(torch, dtype))
    most = np.bincount(rows * csr.num_cols + csr.col_indices).max()
    np.testing.assert_allclose(op.mm(eye).double().numpy(), want,
                               rtol=2 * most * rtol, atol=0)
    assert (want[empty] == 0).all()
    np.testing.assert_allclose(want.sum(axis=1)[~empty], 1.0, rtol=1e-12)
    assert list(op.setup_s) == ["plan", "transition", "prepare"]


def test_bfloat16_transition_operator_stores_bfloat16_values():
    """In bfloat16 the operator holds each float64 quotient rounded to
    bfloat16 (then widened to float32, its compute dtype), as
    build_operator holds a bfloat16 matrix's values: not the float32
    quotient."""
    csr = graph(1024, 5000, values="weighted")
    op = transition_operator(csr, dtype="bfloat16", device="cpu")
    rows = np.repeat(np.arange(csr.num_rows), degrees(csr))
    sums = np.bincount(rows, weights=csr.values, minlength=csr.num_rows)
    quotient = torch.from_numpy(csr.values / sums[rows])
    assert op.values.dtype == torch.float32
    assert torch.equal(op.values, quotient.to(torch.bfloat16).float())
    assert not torch.equal(op.values, quotient.float())


def test_transition_operator_refuses_a_row_summing_to_zero():
    csr = CsrMatrix.from_coo(CooMatrix(3, 3, [0, 0, 2], [1, 2, 0],
                                       [1.0, -1.0, 2.0]))
    with pytest.raises(ValueError, match="sums to 0"):
        transition_operator(csr, dtype="float64", device="cpu")


@pytest.mark.parametrize("d", [256, 130])
@pytest.mark.parametrize("weights", [(0.0, 1.0, 1.0), (0.5, 1.0, 0.0, 2.0)])
def test_fastrp_matches_the_reference_in_float64(d, weights):
    """d = 256 is four blocks of 64 columns on the card, d = 130 blocks of
    64, 64 and 2.  Tolerance: ``tolerance`` in float64's unit roundoff."""
    csr = graph()
    op = transition_operator(csr, dtype="float64", device="cpu")
    r = projection(csr.num_cols, d)
    emb, info = S.fastrp(op, r, weights)
    want = reference(csr, r, weights)
    assert emb.shape == (csr.num_rows, d) and emb.dtype == torch.float64
    err = float((emb - want).abs().max())
    assert err <= tolerance(csr, weights, 2.0 ** -53), err
    assert int(info.iterations) == len(weights)


def test_float32_fastrp_passes_where_the_bfloat16_reference_fails():
    """The float32 program within ``tolerance`` in float32's unit
    roundoff; the same reference in bfloat16 far outside it."""
    csr = graph()
    weights = (0.0, 1.0, 1.0)
    r = projection(csr.num_cols, 256, dtype=torch.float32)
    emb, _ = S.fastrp(transition_operator(csr, device="cpu"), r, weights)
    want = reference(csr, r, weights)
    limit = tolerance(csr, weights, 2.0 ** -24)
    assert emb.dtype == torch.float32
    assert float((emb.double() - want).abs().max()) <= limit
    control = reference(csr, r, weights, torch.bfloat16).double()
    assert float((control - want).abs().max()) > 10 * limit


@pytest.mark.parametrize("symmetric", [True, False])
def test_isolated_vertices_give_zero_rows_and_no_nan(symmetric):
    csr = graph(1024, 3000, symmetric=symmetric)
    op = transition_operator(csr, dtype="float32", device="cpu")
    emb, _ = S.fastrp(op, projection(csr.num_cols, 64, dtype=torch.float32))
    assert bool(torch.isfinite(emb).all())
    empty = torch.from_numpy(degrees(csr) == 0)
    assert int(empty.sum()) > 0
    assert bool((emb[empty] == 0).all())
    norms = torch.linalg.vector_norm(emb.double(), dim=1)
    assert float(norms.max()) <= 2 + 1e-5
    if symmetric:
        # a vertex with an edge has a neighbour with an edge back, so
        # neither weighted term is a zero row
        assert bool((norms[~empty] > 0).all())


def test_zero_weights_and_empty_weights():
    csr = graph(1024, 3000)
    op = transition_operator(csr, dtype="float64", device="cpu")
    r = projection(csr.num_cols, 8)
    emb, info = S.fastrp(op, r, (0.0, 0.0))
    assert bool((emb == 0).all()) and int(info.iterations) == 2
    with pytest.raises(ValueError, match="must not be empty"):
        S.fastrp(op, r, ())


def test_iterations_is_a_host_count():
    csr = graph(1024, 3000)
    op = transition_operator(csr, dtype="float32", device="cpu")
    _, info = S.fastrp(op, projection(csr.num_cols, 8), (0.0, 1.0, 1.0))
    assert not isinstance(info.iterations, torch.Tensor) or \
        info.iterations.device.type == "cpu"
    assert int(info.iterations) == 3
    assert info.host_reads == 0 and info.step_ms is None


def _spans(prof):
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.name.startswith("merge_spmv.")]


def test_spans_of_a_fastrp_call():
    """One solve span holding one prologue, one op.mm a weight and one
    normalize after each; the transition's scaling is a span of the
    build, and is timed."""
    csr = graph(1024, 3000)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        op = transition_operator(csr, dtype="float32", device="cpu")
        S.fastrp(op, projection(csr.num_cols, 8), (0.0, 1.0, 1.0, 0.5))
    spans = _spans(prof)
    named = {n: [s for s in spans if s[0] == n] for n in T.SPANS}
    assert len(named[T.BUILD_TRANSITION]) == 1
    assert op.setup_s["transition"] >= 0.0
    (solve,) = named[T.SOLVE]
    assert len(named[T.PROLOGUE]) == 1
    assert len(named[T.OP_MM]) == len(named[T.NORMALIZE]) == 4
    for s in named[T.OP_MM] + named[T.NORMALIZE] + named[T.PROLOGUE]:
        assert solve[1] <= s[1] and s[2] <= solve[2]
    order = sorted(named[T.OP_MM] + named[T.NORMALIZE], key=lambda s: s[1])
    assert [s[0] for s in order] == [T.OP_MM, T.NORMALIZE] * 4


def test_reference_imports_only_torch():
    tree = ast.parse(REFERENCE.read_text())
    imported = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            imported.add(node.module.split(".")[0])
    assert imported <= {"torch", "__future__"}, imported
    probe = (
        "import importlib.util, json, sys\n"
        f"spec = importlib.util.spec_from_file_location('ref', {str(REFERENCE)!r})\n"
        "m = importlib.util.module_from_spec(spec); spec.loader.exec_module(m)\n"
        "print(json.dumps(sorted({k.split('.')[0] for k in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    loaded = set(json.loads(out.strip().splitlines()[-1]))
    assert "torch" in loaded
    assert not loaded & {"jax", "jaxlib", "merge_spmv_tpu",
                         "merge_spmv_tpu_torch"}


def torch_step(n, emb, w):
    """FastRP's normalise-and-accumulate as models/solvers.py ran it before
    the kernel: the norms, the division in place, E's multiply or add."""
    norms = torch.linalg.vector_norm(n, dim=1, keepdim=True)
    n.div_(torch.where(norms > 0, norms, 1.0))
    if w != 0.0:
        emb = n * w if emb is None else emb.add_(n, alpha=w)
    return emb


ZERO_ROWS = (0, 5, 6)


def block(rows, d, dtype, seed):
    """A product's rows: normal values, ZERO_ROWS all 0."""
    gen = torch.Generator().manual_seed(seed)
    n = torch.randn((rows, d), generator=gen, dtype=torch.float64) * 3.0
    n[list(ZERO_ROWS)] = 0.0
    return n.to(dtype)


# (w, E given): E untouched, E = w n(N) (a new E), E += w n(N)
E_MODES = {"none": (0.0, True), "set": (0.75, False), "add": (-1.5, True)}


@pytest.mark.parametrize("store_n", [True, False])
@pytest.mark.parametrize("mode", list(E_MODES))
@pytest.mark.parametrize("d", [1, 3, 8, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
def test_plain_row_normalize_is_the_torch_step(dtype, d, mode, store_n):
    """The plain version gives the torch step's E and n(N) bit for bit;
    with ``store_n`` false N keeps its values; E is the one given where
    it is added to or untouched."""
    w, given = E_MODES[mode]
    n = block(40, d, dtype, seed=d)
    e = block(40, d, dtype, seed=d + 1) if given else None
    want_n = n.clone()
    want_e = torch_step(want_n, None if e is None else e.clone(), w)
    before = n.clone()
    got = F.row_normalize_plain(n, e, w, store_n=store_n)
    assert torch.equal(n, want_n if store_n else before)
    if given:
        assert got is e
    if want_e is None:
        assert got is None
    else:
        assert got.dtype == dtype and torch.equal(got, want_e)
    assert not torch.isnan(n).any() and bool((want_n[list(ZERO_ROWS)] == 0)
                                              .all())


@pytest.mark.parametrize("mode", ["set", "add"])
def test_the_last_product_gives_the_same_e_stored_or_not(mode):
    """E after a step is the same whether n(N) is written back or not; not
    writing it leaves N as it was.  Zero rows add nothing to E."""
    w, given = E_MODES[mode]
    es = []
    for store_n in (True, False):
        n = block(64, 256, torch.float32, seed=3)
        e = torch.ones(64, 256) if given else None
        es.append(F.row_normalize_plain(n, e, w, store_n=store_n))
        if not store_n:
            assert torch.equal(n, block(64, 256, torch.float32, seed=3))
    assert torch.equal(es[0], es[1])
    zero = list(ZERO_ROWS)
    assert bool((es[0][zero] == (1.0 if given else 0.0)).all())
    assert bool(torch.isfinite(es[0]).all())


def test_zero_rows_stay_zero_with_no_nan():
    n = torch.zeros(8, 5, dtype=torch.float64)
    n[3] = torch.tensor([3.0, 0.0, 4.0, 0.0, 0.0])
    e = F.row_normalize_plain(n, None, 2.0)
    assert torch.equal(n[3], torch.tensor([0.6, 0.0, 0.8, 0.0, 0.0],
                                          dtype=torch.float64))
    assert int((n != 0).sum()) == 2 and not torch.isnan(n).any()
    assert torch.equal(e, 2.0 * n)


def test_the_cpu_takes_the_torch_path_once_a_product():
    """takes() is false on the CPU and true on every CUDA device, so on
    the CPU fastrp counts one torch normalise-and-accumulate a product and
    launches nothing; its E is the torch step's, bit for bit."""
    assert not F.takes("cpu") and not F.takes(torch.device("cpu"))
    assert F.takes("cuda") and F.takes("cuda:1")
    csr = graph(1024, 3000)
    op = transition_operator(csr, dtype="float32", device="cpu")
    r = projection(csr.num_cols, 16, dtype=torch.float32)
    weights = (0.0, 1.0, 0.5, 1.0)
    before, launches = dict(S.NORMALIZES), dict(F.LAUNCHES)
    emb, _ = S.fastrp(op, r, weights)
    assert S.NORMALIZES == {"fused": before["fused"],
                            "torch": before["torch"] + len(weights)}
    assert F.LAUNCHES == launches
    want, x = None, r
    for w in weights:
        x = op.mm(x)
        want = torch_step(x, want, w)
    assert torch.equal(emb, want)


def test_a_last_weight_of_0_makes_no_last_step():
    """With a last weight of 0 nothing reads the last product's rows, so
    fastrp makes no step for it (no count, no normalize span); E is the
    torch steps' over the others, bit for bit."""
    csr = graph(1024, 3000)
    op = transition_operator(csr, dtype="float32", device="cpu")
    r = projection(csr.num_cols, 8, dtype=torch.float32)
    weights = (0.5, 1.0, 0.0)
    before = dict(S.NORMALIZES)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        emb, info = S.fastrp(op, r, weights)
    spans = _spans(prof)
    assert sum(s[0] == T.OP_MM for s in spans) == 3
    assert sum(s[0] == T.NORMALIZE for s in spans) == 2
    assert S.NORMALIZES == {"fused": before["fused"],
                            "torch": before["torch"] + 2}
    assert info.iterations == 3
    want, x = None, r
    for w in weights[:2]:
        x = op.mm(x)
        want = torch_step(x, want, w)
    assert torch.equal(emb, want)


@pytest.mark.parametrize("step", [F.row_normalize_plain, F.row_normalize])
def test_the_wrapper_checks_its_operands(step):
    n = torch.ones(6, 8)
    with pytest.raises(ValueError, match="contiguous"):
        step(torch.ones(8, 6).t(), None, 1.0)
    with pytest.raises(ValueError, match="shape"):
        step(n, torch.ones(6, 7), 1.0)
    with pytest.raises(ValueError, match="shape"):
        step(n, torch.ones(48), 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        step(n, torch.ones(8, 6).t(), 1.0)
    with pytest.raises(TypeError, match="float64"):
        step(n, torch.ones(6, 8, dtype=torch.float64), 1.0)
    with pytest.raises(ValueError, match=r"\[rows, d\]"):
        step(torch.ones(6), None, 1.0)
    assert torch.equal(n, torch.ones(6, 8))


def test_the_kernel_wrapper_refuses_the_cpu_and_other_dtypes():
    with pytest.raises(ValueError, match="CUDA device"):
        F.row_normalize(torch.ones(4, 8), None, 1.0)
    with pytest.raises(TypeError, match="float32, float64 or bfloat16"):
        F.row_normalize(torch.ones(4, 8, dtype=torch.float16), None, 1.0)


@pytest.mark.parametrize("d,itemsize,align,want", [
    (256, 4, 16, 2), (64, 4, 16, 1), (260, 4, 16, 3), (512, 4, 16, 4),
    (256, 8, 16, 4), (128, 8, 16, 2), (4, 4, 16, 1), (2, 8, 16, 1),
    (516, 4, 16, 0), (260, 8, 16, 0), (1, 4, 16, 0), (3, 4, 16, 0),
    (6, 4, 16, 0), (256, 4, 8, 0), (256, 4, 4, 0), (0, 4, 16, 0)])
def test_the_path_follows_the_row_alone(d, itemsize, align, want):
    """The vector path where a row is a whole number of 16-byte vectors,
    at most 2 KB, at 16-byte alignment: ceil(vectors / 32) a lane; else
    the scalar path (0)."""
    assert F.vectors_per_lane(d, itemsize, align) == want


def test_the_grid_is_a_block_per_rows_of_its_warps():
    """A block per 8 warps' rows: ROWS_IN_FLIGHT a warp on the vector
    path, one on the scalar path."""
    per_vector_block = (F.THREADS // 32) * F.ROWS_IN_FLIGHT
    assert F.grid_blocks(2 ** 21, 2) == 2 ** 21 // per_vector_block
    assert F.grid_blocks(10 * per_vector_block + 1, 2) == 11
    assert F.grid_blocks(17, 0) == 3
    assert F.grid_blocks(1, 4) == 1
    assert F.grid_blocks(2 ** 40, 0) == F.MAX_BLOCKS


@pytest.mark.cuda
def test_fastrp_on_the_card_matches_the_reference():
    """2^16 vertices, d = 256 in float32: K1m four launches a product,
    within ``tolerance`` in float32's unit roundoff of the float64
    reference, and the float32 program's iterations a host count."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc to build the kernels)")
    from merge_spmv_tpu_torch.ops import csrmv_cuda as K

    csr = graph(1 << 16, 600_000, isolated_every=29)
    op = transition_operator(csr, dtype="float32")
    r = projection(csr.num_cols, 256, dtype=torch.float32)
    weights = (0.0, 1.0, 1.0)
    before = K.LAUNCHES["merge_tile_mm"]
    emb, info = S.fastrp(op, r.cuda(), weights)
    torch.cuda.synchronize()
    assert K.LAUNCHES["merge_tile_mm"] - before == 4 * len(weights)
    assert info.iterations.device.type == "cpu"
    want = reference(csr, r, weights)
    err = float((emb.double().cpu() - want).abs().max())
    assert err <= tolerance(csr, weights, 2.0 ** -24), err
