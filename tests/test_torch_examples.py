"""The PyTorch port's examples on the CPU: conjugate gradients on the SPD
stencil converges and matches the JAX package's examples/cg.py to 1e-4,
and matrix_powers (a cached product, prepare(A^2), A^4 v through two
SpMVs) agrees with scipy below its 1e-4 bound."""

import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

import jax.numpy as jnp

import bmsparse_tpu as bj
from bmsparse_tpu.ops.plan import prepare as prepare_j

from bmsparse_tpu_torch.examples import cg as cg_t
from bmsparse_tpu_torch.examples import matrix_powers as mp_t

REPO = Path(__file__).resolve().parents[1]


def _jax_cg_module():
    sys.path.insert(0, str(REPO / "examples"))
    try:
        import cg
    finally:
        sys.path.pop(0)
    return cg


@pytest.mark.parametrize("iters", [10, 60])
def test_cg_matches_jax(iters):
    n = 512
    cg_j = _jax_cg_module()
    rows, cols, vals = cg_t.build_spd_stencil(n)
    for a, b in zip((rows, cols, vals), cg_j.build_spd_stencil(n)):
        np.testing.assert_array_equal(a, b)
    p, b = cg_t.setup(n, device="cpu")
    x, hist = cg_t.cg(p, b, iters)
    assert x.device.type == hist.device.type == "cpu"
    assert hist.shape == (iters,)
    pj = prepare_j(bj.coo_to_bmsparse(rows, cols, vals, (n, n),
                                      backend="host"))
    xj, hj = cg_j.cg(pj, jnp.asarray(b.numpy()), iters)
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(hist[:5].numpy(), np.asarray(hj)[:5],
                               rtol=1e-4)
    if iters >= 60:
        assert float(hist[-1]) ** 0.5 < 1e-3 * float(torch.dot(b, b)) ** 0.5
        ax = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)) @ x.numpy()
        np.testing.assert_allclose(ax, b.numpy(), rtol=1e-3, atol=1e-3)


def test_cg_main_cpu(capsys):
    assert cg_t.main(["512", "60", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "us/iteration on cpu" in out


@pytest.mark.parametrize("band", [4, 8])
def test_matrix_powers(band):
    r = mp_t.run(4096, band, device="cpu")
    assert r["err"] < mp_t.ERR_BOUND
    offs = np.arange(-band // 2, band // 2 + 1)
    s = sp.diags([np.ones(4096 - abs(o)) for o in offs], offs)
    assert r["nnz"] == s.nnz and r["nnz_a2"] >= (s @ s).nnz


def test_matrix_powers_main_cpu(capsys):
    assert mp_t.main(["4096", "8", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "cached multiply:" in out and "A^4 v rel err vs scipy" in out
