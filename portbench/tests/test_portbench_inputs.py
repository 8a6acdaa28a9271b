"""Generators, plain references and the frozen yardstick, against scipy
and hand counts."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from portbench import roofline
from portbench.generators import hpcg27, kronecker
from portbench.reference import solvers

HPCG = {"diagonal": 26.0, "off_diagonal": -1.0,
        "off_diagonal_range": [-1.5, -0.5]}
KRON = {"scale": 9, "edgefactor": 16, "initiator": [0.57, 0.19, 0.19, 0.05],
        "structure_seed": 3}


def hpcg(nx, ny=None, nz=None):
    return hpcg27.generate({**HPCG, "nx": nx, "ny": ny or nx,
                            "nz": nz or nx}, "cpu")


def to_scipy(rows, cols, vals, shape):
    return sp.coo_matrix((vals.double().numpy(), (rows.numpy(),
                                                  cols.numpy())),
                         shape=shape).tocsr()


@pytest.mark.parametrize("nx", [8, 16])
def test_hpcg_structure_and_values(nx):
    p = hpcg(nx)
    rows, cols, vals = p.coo(0, 0)
    assert p.nnz == rows.numel() == (3 * nx - 2) ** 3
    a = to_scipy(rows, cols, vals, p.shape)
    assert a.nnz == p.nnz                      # no duplicates
    assert (a.diagonal() == 26).all()
    off = a - sp.diags(a.diagonal())
    assert set(np.unique(off.data)) == {-1.0}
    assert abs(a - a.T).max() == 0
    # interior rows hold 27 entries, corners 8
    counts = np.diff(a.indptr)
    assert counts.max() == 27 and counts.min() == 8


def test_hpcg_value_set_one_is_seeded_and_keeps_structure():
    p = hpcg(6, 5, 4)
    r0, c0, _ = p.coo(0, 0)
    r1, c1, v1 = p.coo(1, 2**35 + 1)
    _, _, v1b = hpcg(6, 5, 4).coo(1, 2**35 + 1)
    _, _, v2 = p.coo(1, 7)
    assert torch.equal(r0, r1) and torch.equal(c0, c1)
    assert torch.equal(v1, v1b) and not torch.equal(v1, v2)
    off = v1[r1 != c1]
    assert off.min() >= -1.5 and off.max() <= -0.5
    assert (v1[r1 == c1] == 26).all()


def test_kronecker_is_seeded_undirected_and_simple():
    g = kronecker.generate(KRON, "cpu")
    h = kronecker.generate(KRON, "cpu")
    other = kronecker.generate({**KRON, "structure_seed": 4}, "cpu")
    assert torch.equal(g.rows, h.rows) and torch.equal(g.cols, h.cols)
    assert not (g.rows.numel() == other.rows.numel()
                and torch.equal(g.rows, other.rows))
    a = to_scipy(g.rows, g.cols, torch.ones(g.nnz), g.shape)
    assert a.nnz == g.nnz                      # no duplicate edges
    assert a.diagonal().sum() == 0             # no self-loops
    assert abs(a - a.T).max() == 0             # undirected
    assert (np.diff(a.indptr) > 0).all()       # no isolated vertex
    p = to_scipy(*g.coo(0, 0), g.shape)
    assert np.allclose(p.sum(axis=0), 1.0, atol=1e-6)   # column-stochastic
    # the edge list holds about edgefactor * 2^scale edges each way
    assert 0.5 * 16 * 512 < g.nnz / 2 <= 16 * 512


def test_stencil_reference_against_scipy():
    p = hpcg(5, 4, 3)
    for s in (0, 1):
        a = to_scipy(*p.coo(s, 11), p.shape)
        ref = p.reference(s, 11, torch.float64)
        x = np.random.default_rng(s).standard_normal(p.shape[0])
        assert np.allclose(ref.apply(torch.from_numpy(x)).numpy(), a @ x,
                           rtol=1e-13, atol=1e-12)
        assert np.allclose(ref.abs_apply(torch.from_numpy(x)).numpy(),
                           abs(a) @ abs(x), rtol=1e-13, atol=1e-12)
        keys, vals, scale = ref.square_coo()
        c = (a @ a).tocoo()
        k = c.row.astype(np.int64) * p.shape[0] + c.col
        o = np.argsort(k)
        assert np.array_equal(keys.numpy(), k[o])
        assert np.allclose(vals.numpy(), c.data[o], rtol=1e-13, atol=1e-12)
        s_ref = (abs(a) @ abs(a)).tocoo()
        assert np.allclose(scale.numpy(), s_ref.data[np.argsort(
            s_ref.row.astype(np.int64) * p.shape[0] + s_ref.col)])


def test_coo_reference_cg_and_pagerank_against_scipy():
    g = kronecker.generate(KRON, "cpu")
    p = to_scipy(*g.coo(0, 0), g.shape)
    ref = g.reference(0, 0, torch.float64)
    x = np.random.default_rng(1).random(g.shape[0])
    assert np.allclose(ref.apply(torch.from_numpy(x)).numpy(), p @ x)
    # PageRank by scipy, step by step
    x0 = x / x.sum()
    want = x0.copy()
    for _ in range(10):
        want = 0.85 * (p @ want) + 0.15 / g.shape[0]
    got = solvers.pagerank(ref.apply, torch.from_numpy(x0), 10, 0.85)
    assert np.allclose(got.numpy(), want, rtol=1e-12)
    # CG against a direct solve on an SPD operator: 60 steps converge
    h = hpcg(4)
    a = to_scipy(*h.coo(0, 0), h.shape)
    b = np.random.default_rng(2).standard_normal(h.shape[0])
    xs, hist = solvers.cg(h.reference(0, 0, torch.float64).apply,
                          torch.from_numpy(b), 60)
    assert np.allclose(xs.numpy(), sp.linalg.spsolve(a.tocsc(), b),
                       rtol=1e-9, atol=1e-10)
    assert hist.shape == (60,) and hist[-1] < 1e-20 * float(b @ b)


def test_least_work_against_hand_counts():
    # 3x3 grid in one plane: 9 rows, 49 nonzeros ((3*3-2)^2)
    p = hpcg(3, 3, 1)
    assert p.nnz == 49
    assert roofline.spmv_least_bytes(49, 9, 9) == (49 + 9 + 9) * 4
    rows, cols = p.row_col_counts()
    # sum over k of nnz(A[:, k]) nnz(A[k, :]): corners 4*4, edges 6*6,
    # the centre 9*9
    assert roofline.spgemm_products(cols, rows) == 4 * 16 + 4 * 36 + 81
    assert roofline.spgemm_least_bytes(49, 49, 81) == (49 + 49 + 81) * 4
    t, bound = roofline.least_seconds(3350 * 10**9, 0,
                                      "NVIDIA H100 80GB HBM3")
    assert (t, bound) == (1.0, "bytes")
    t, bound = roofline.least_seconds(0, 67 * 10**12, "NVIDIA H100 80GB HBM3")
    assert (t, bound) == (1.0, "flops")
    assert roofline.device_gbps("NVIDIA H100 PCIe") == 2000.0
    with pytest.raises(KeyError):
        roofline.least_seconds(1, 1, "cpu")
