"""The SpGEMM compress alternatives of the PyTorch port: the gather-fold
(spgemm_compress="fold") and the segment compress ("mxu", kernel
segment_compress_class), on the CPU against the JAX package.

segment_compress_class_plain is held against the Pallas kernel in
interpret mode at rtol = atol = 1e-6 (the Pallas kernel sums through
one-hot matrix products). The fold's plan (compress_mode and its
contributor table g_tbl) must equal JAX _plan_product's exactly; C from
"fold" and from "mxu" must equal the scatter path's C: the structure
exactly, the values at rtol 1e-6 (every output position receives one
non-zero term, so the three sums are exact), on the cases of
tests/test_spgemm.py's fold and MXU tests.

The cases marked `gpu` hold the CUDA kernel against its plain version on
the card and skip where there is none. They import no JAX:
    python -m pytest tests/test_torch_compress.py --noconftest -m gpu
"""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import bmsparse_tpu_torch as bt
from bmsparse_tpu_torch.ops import spgemm as sgt
from bmsparse_tpu_torch.ops.cuda.compress_kernel import (
    segment_compress_class, segment_compress_class_plain,
)
from bmsparse_tpu_torch.utils.timing import PhaseTimer

COMPRESS_TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def ref():
    """The JAX package, imported here and not at module level so that the
    `gpu` cases run where JAX is not installed."""
    return SimpleNamespace(
        jnp=pytest.importorskip("jax.numpy"),
        bj=pytest.importorskip("bmsparse_tpu"),
        sg=pytest.importorskip("bmsparse_tpu.ops.spgemm"),
        ck=pytest.importorskip("bmsparse_tpu.ops.pallas.compress_kernel"),
        timer=pytest.importorskip("bmsparse_tpu.utils.timing").PhaseTimer)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def compress_mode():
    """Sets spgemm_compress in the port (and in the JAX package where it
    is imported) for one test."""
    import sys

    def set_mode(mode):
        bt.set_config(spgemm_compress=mode)
        if "bmsparse_tpu" in sys.modules:
            sys.modules["bmsparse_tpu"].set_config(spgemm_compress=mode)

    yield set_mode
    set_mode("auto")


def _segment_inputs(rpad, t_pad, step, seed=0, pad=40):
    """Packed rows with sorted output rows (increments drawn from
    [0, step), so wide steps leave output rows and 512-row windows with
    no contributor) and `pad` padding rows at 2**30."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((rpad, 128)).astype(np.float32)
    b = np.minimum(np.cumsum(rng.integers(0, step, rpad)), t_pad - 1)
    b[rpad - pad:] = 2**30
    return w, b.astype(np.int32)


def _banded(n, band, seed):
    """tests/test_spgemm.py's _banded: A and its transposed-layout B."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n, dtype=np.int64), band)
    offs = rng.integers(-band // 2, band // 2 + 1, size=rows.shape[0])
    cols = np.clip(rows + offs, 0, n - 1)
    key = np.unique(rows * n + cols)
    rows, cols = np.divmod(key, n)
    vals = rng.standard_normal(rows.shape[0]).astype(np.float32)
    return rows.astype(np.int32), cols.astype(np.int32), vals, (n, n)


def _random768():
    """tests/test_spgemm.py's MXU case."""
    n = 768
    rng = np.random.default_rng(11)
    flat = rng.choice(n * n, int(n * n * 0.01), replace=False)
    r, c = np.divmod(flat, n)
    v = rng.standard_normal(flat.shape[0]).astype(np.float32)
    o = np.lexsort((c, r))
    return r[o].astype(np.int32), c[o].astype(np.int32), v[o], (n, n)


CASES = {"banded8192": lambda: _banded(8192, 10, seed=22),
         "random768": _random768}


def _port_operands(name, device="cpu"):
    r, c, v, shape = CASES[name]()
    return (bt.coo_to_bmsparse(r, c, v, shape, device=device),
            bt.coo_to_bmsparse(r, c, v, shape, transposed=True,
                               device=device))


def _jax_operands(ref, name):
    r, c, v, shape = CASES[name]()
    return (ref.bj.coo_to_bmsparse(r, c, v, shape, backend="host"),
            ref.bj.coo_to_bmsparse(r, c, v, shape, transposed=True,
                                   backend="host"))


def _same_c(c, c_ref):
    assert c.nb == c_ref.nb and c.nnz == c_ref.nnz
    for f in ("brow", "bcol", "bmp_hi", "bmp_lo", "offsets"):
        assert torch.equal(getattr(c, f), getattr(c_ref, f)), f
    np.testing.assert_allclose(c.values[: c.nnz].cpu().numpy(),
                               c_ref.values[: c.nnz].cpu().numpy(),
                               **COMPRESS_TOL)


# ---------------------------------------------------------------------------
# segment_compress_class: the plain version against the Pallas kernel
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("rpad,t_pad,step", [(512, 1024, 3), (1024, 8192, 9),
                                             (128, 512, 1)])
def test_segment_compress_matches_pallas(ref, rpad, t_pad, step):
    w, b = _segment_inputs(rpad, t_pad, step)
    want = np.asarray(ref.ck.segment_compress_class(
        ref.jnp.asarray(w), ref.jnp.asarray(b), t_pad))
    got = segment_compress_class(torch.from_numpy(w), torch.from_numpy(b),
                                 t_pad)
    assert got.shape == (t_pad, 128) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **COMPRESS_TOL)


def test_segment_compress_drops_rows_outside():
    w = torch.ones(6, 128)
    b = torch.tensor([-1, 0, 0, 3, 5, 2**30], dtype=torch.int32)
    out = segment_compress_class_plain(w, b, 4)
    assert out[:, 0].tolist() == [2.0, 0.0, 0.0, 1.0]
    before = segment_compress_class.launches
    segment_compress_class(w, b, 4)
    assert segment_compress_class.launches == before
    with pytest.raises(TypeError):
        segment_compress_class(w.double(), b, 4)
    with pytest.raises(ValueError):
        segment_compress_class(w, b.long(), 4)
    with pytest.raises(ValueError):
        segment_compress_class(w, b, 2**30)


# ---------------------------------------------------------------------------
# the fold's plan and the compress modes through the public API
# ---------------------------------------------------------------------------
def test_fold_plan_matches_jax(ref, compress_mode):
    from test_torch_spgemm import assert_same_plan

    compress_mode("fold")
    aj, bjm = _jax_operands(ref, "banded8192")
    at, btm = _port_operands("banded8192")
    pj = ref.sg._plan_product(aj, bjm, None, None, ref.timer(False), False)
    pt = sgt._plan_product(at, btm, None, None, PhaseTimer(False), False)
    assert pj.compress_mode == pt.compress_mode == "fold"
    assert_same_plan(pj, pt)
    gj = np.asarray(pj.g_tbl)
    assert gj.shape == tuple(pt.g_tbl.shape) and gj.shape[1] == pt.jmax
    np.testing.assert_array_equal(gj, pt.g_tbl.numpy())


def test_fold_refused_matches_jax(ref, compress_mode, monkeypatch):
    """Where the fold's eligibility rules refuse it, both packages keep
    the scatter and its (1, 1) placeholder table."""
    for mod in (ref.sg, sgt):
        monkeypatch.setattr(mod, "_FOLD_MAX_ROWS", 128)
    compress_mode("fold")
    aj, bjm = _jax_operands(ref, "banded8192")
    at, btm = _port_operands("banded8192")
    pj = ref.sg._plan_product(aj, bjm, None, None, ref.timer(False), False)
    pt = sgt._plan_product(at, btm, None, None, PhaseTimer(False), False)
    assert pj.compress_mode == pt.compress_mode == "scatter"
    np.testing.assert_array_equal(np.asarray(pj.g_tbl), pt.g_tbl.numpy())


@pytest.mark.parametrize("mode,name", [("fold", "banded8192"),
                                       ("mxu", "banded8192"),
                                       ("mxu", "random768")])
def test_compress_modes_equal_scatter(ref, compress_mode, mode, name):
    at, btm = _port_operands(name)
    c_sc = bt.spgemm(at, btm)
    compress_mode(mode)
    pp = bt.prepare_product(at, btm)
    assert pp.compress_mode == pp.plan.compress_mode == mode
    _same_c(pp(), c_sc)
    _same_c(bt.spgemm(at, btm), c_sc)
    # and the JAX package's C under the same mode (its XLA products, so
    # that interpret mode runs only the compress kernel)
    aj, bjm = _jax_operands(ref, name)
    cj = ref.sg.spgemm(aj, bjm, impl="sell")
    np.testing.assert_allclose(c_sc.values[: c_sc.nnz].numpy(),
                               np.asarray(cj.values)[: cj.nnz],
                               rtol=1e-5, atol=1e-5)
    ref_sp = (at.to_scipy().tocsr() @ btm.to_scipy().tocsr()).tocsr()
    assert bt.mean_relative_error(pp(), ref_sp) < 1e-5


def test_mxu_on_an_empty_product(compress_mode):
    compress_mode("mxu")
    one = np.array([1.0], np.float32)
    a = bt.coo_to_bmsparse(np.array([0], np.int32), np.array([0], np.int32),
                           one, (16, 16), device="cpu")
    b = bt.coo_to_bmsparse(np.array([8], np.int32), np.array([0], np.int32),
                           one, (16, 16), transposed=True, device="cpu")
    pp = bt.prepare_product(a, b)
    assert pp.compress_mode == "scatter"      # no K-group: nothing to class
    assert pp().nb == 0


# ---------------------------------------------------------------------------
# the CUDA kernel against the plain version, on the card
# ---------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("rpad,t_pad,step", [(4096, 8192, 3),
                                             (300_000, 400_000, 3),
                                             (1000, 400_000, 400),
                                             (0, 16, 1)])
def test_segment_compress_kernel_on_card(cuda, rpad, t_pad, step):
    w, b = _segment_inputs(rpad, t_pad, step, pad=min(40, rpad))
    if rpad:
        b[0] = -1                  # before every output row: drops out
    w_t, b_t = torch.from_numpy(w).to(cuda), torch.from_numpy(b).to(cuda)
    before = segment_compress_class.launches
    got = segment_compress_class(w_t, b_t, t_pad)
    torch.cuda.synchronize()
    assert segment_compress_class.launches == before + 1
    torch.testing.assert_close(
        got, segment_compress_class_plain(w_t, b_t, t_pad), **COMPRESS_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["fold", "mxu"])
def test_compress_modes_on_card(cuda, compress_mode, mode):
    at, btm = _port_operands("banded8192", device=cuda)
    c_sc = bt.spgemm(at, btm)
    compress_mode(mode)
    before = segment_compress_class.launches
    pp = bt.prepare_product(at, btm)
    assert pp.compress_mode == mode
    _same_c(pp(), c_sc)
    launched = segment_compress_class.launches - before
    assert launched == (len(pp.plan.groups) if mode == "mxu" else 0)
