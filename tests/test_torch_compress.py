"""The SpGEMM compress alternatives of the PyTorch port: the gather-fold
(spgemm_compress="fold") and the segment compress ("mxu", kernel
segment_compress_class), on the CPU against the JAX package; and the
default compress (bitmap_compress), whose plain version must equal the
JAX package's _compress_rows bit for bit (each output position has one
writer in both).

segment_compress_class_plain is held against the Pallas kernel in
interpret mode at rtol = atol = 1e-6 (the Pallas kernel sums through
one-hot matrix products). The fold's plan (compress_mode and its
contributor table g_tbl) must equal JAX _plan_product's exactly; C from
"fold" and from "mxu" must equal the scatter path's C: the structure
exactly, the values at rtol 1e-6 (every output position receives one
non-zero term, so the three sums are exact), on the cases of
tests/test_spgemm.py's fold and MXU tests.

The cases marked `gpu` hold the CUDA kernels against their plain
versions (bitmap_compress bit for bit) on the
card and skip where there is none. They import no JAX:
    python -m pytest tests/test_torch_compress.py --noconftest -m gpu
"""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import bmsparse_tpu_torch as bt
from bmsparse_tpu_torch.ops import spgemm as sgt
from bmsparse_tpu_torch.ops.cuda.bitmap_compress_kernel import (
    bitmap_compress, bitmap_compress_plain,
)
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


def _rank_inputs(rows, density, seed=0, pad=0, tail=0, past=False):
    """The default compress's operands as a plan gives them: c_rows (R, 64)
    with NaN in every lane whose bit is unset (no compress may read it),
    bitmap words, and offsets that are the exclusive prefix sum of the
    rows' counts in a shuffled (natural) order, so the rows cover
    [0, nnz) once each; `pad` zero-bitmap rows at random places with
    random offsets; nnz_pad = nnz + tail. `past` ends the cover with a
    row that straddles nnz and sends another row past nnz_pad: their
    values at or past nnz must drop, and the tail reads 0.
    Returns (c_rows, hi, lo, off, nnz_pad, nnz)."""
    rng = np.random.default_rng(seed)
    bits = rng.random((rows, 64)) < density
    cnt = bits.sum(1)
    nat = rng.permutation(rows)
    if past:
        live = nat[cnt[nat] > 1]
        last, other = live[-1], live[0]
        nat = np.append(nat[(nat != last) & (nat != other)], last)
    off = np.zeros(rows, np.int64)
    off[nat] = np.cumsum(cnt[nat]) - cnt[nat]
    nnz = int(cnt[nat].sum())
    if past:
        nnz -= int(cnt[last] - cnt[last] // 2)
    nnz_pad = nnz + tail
    if past:
        off[other] = nnz_pad + 100
    vals = rng.standard_normal((rows, 64)).astype(np.float32)
    vals[~bits] = np.nan
    if pad:
        at = np.sort(rng.choice(rows + pad, pad, replace=False))
        bits = np.insert(bits, at - np.arange(pad), False, axis=0)
        vals = np.insert(vals, at - np.arange(pad), np.nan, axis=0)
        off = np.insert(off, at - np.arange(pad),
                        rng.integers(0, max(nnz, 1), pad), axis=0)
    hi, lo = bt.format.bitmap.pack_bits(torch.from_numpy(bits.astype(np.int32)))
    return (torch.from_numpy(vals), hi, lo, torch.from_numpy(off), nnz_pad,
            nnz)


def _jax_compress_rows(ref, c_rows, hi, lo, off, nnz_pad, nnz):
    """The JAX package's _compress_rows to nnz, then the zero tail."""
    got = np.asarray(ref.sg._compress_rows(
        ref.jnp.asarray(c_rows.numpy()),
        ref.jnp.asarray(hi.numpy().astype(np.uint32)),
        ref.jnp.asarray(lo.numpy().astype(np.uint32)),
        ref.jnp.asarray(off.numpy().astype(np.int32)), nnz))
    return np.concatenate([got, np.zeros(nnz_pad - nnz, got.dtype)])


RANK_CASES = {
    "density0": dict(rows=256, density=0.0, tail=5),
    "density1/64": dict(rows=2048, density=1 / 64),
    "density1/4": dict(rows=1024, density=0.25),
    "density1": dict(rows=512, density=1.0),
    "padding": dict(rows=1024, density=0.25, pad=300),
    "past_nnz_pad": dict(rows=1024, density=0.25, tail=20, past=True),
    "empty": dict(rows=0, density=0.25, pad=128, tail=1),
    "zero_tail": dict(rows=1024, density=0.25, pad=40, tail=777),
}


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
# bitmap_compress: the plain version against the JAX package's _compress_rows
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", list(RANK_CASES))
def test_bitmap_compress_plain_matches_compress_rows(ref, case):
    c_rows, hi, lo, off, nnz_pad, nnz = _rank_inputs(**RANK_CASES[case])
    want = _jax_compress_rows(ref, c_rows, hi, lo, off, nnz_pad, nnz)
    assert want.shape == (nnz_pad,) and not want[nnz:].any()
    before = bitmap_compress.launches
    for got in (bitmap_compress_plain(c_rows, hi, lo, off, nnz_pad, nnz),
                bitmap_compress(c_rows, hi, lo, off, nnz_pad, nnz)):
        assert got.dtype == torch.float32
        assert np.array_equal(got.numpy(), want)
    got = bitmap_compress_plain(c_rows.double(), hi, lo, off, nnz_pad, nnz)
    assert np.array_equal(got.numpy(), want.astype(np.float64))
    assert bitmap_compress.launches == before       # CPU: no kernel


def test_bitmap_compress_checks_its_operands():
    c_rows, hi, lo, off, nnz_pad, nnz = _rank_inputs(64, 0.25)
    with pytest.raises(TypeError):
        bitmap_compress(c_rows.double(), hi, lo, off, nnz_pad, nnz)
    with pytest.raises(TypeError):
        bitmap_compress(c_rows[:, :32], hi, lo, off, nnz_pad, nnz)
    with pytest.raises(ValueError):
        bitmap_compress(c_rows, hi.int(), lo, off, nnz_pad, nnz)
    with pytest.raises(ValueError):
        bitmap_compress(c_rows, hi, lo, off[:-1], nnz_pad, nnz)
    with pytest.raises(ValueError):
        bitmap_compress(c_rows, hi, lo, off, nnz_pad, nnz_pad + 1)


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
    before_bc = bitmap_compress.launches
    pp = bt.prepare_product(at, btm)
    assert pp.compress_mode == mode
    _same_c(pp(), c_sc)
    launched = segment_compress_class.launches - before
    assert launched == (len(pp.plan.groups) if mode == "mxu" else 0)
    assert bitmap_compress.launches == before_bc


@pytest.mark.gpu
@pytest.mark.parametrize("case", [*RANK_CASES, "rows300k"])
def test_bitmap_compress_kernel_on_card(cuda, case):
    kw = RANK_CASES.get(case, dict(rows=300_000, density=13.9 / 64, pad=4096,
                                   tail=1000))
    args = [x.to(cuda) if torch.is_tensor(x) else x
            for x in _rank_inputs(**kw)]
    c_rows, hi, lo, off, nnz_pad, nnz = args
    want = bitmap_compress_plain(c_rows, hi, lo, off, nnz_pad, nnz)
    before = bitmap_compress.launches
    for _ in range(2):                 # the tail is written, not inherited
        got = bitmap_compress(c_rows, hi, lo, off, nnz_pad, nnz)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        got.fill_(float("nan"))
        del got
    assert bitmap_compress.launches == before + 2


@pytest.mark.gpu
def test_bitmap_compress_once_per_product_on_card(cuda):
    """The cached product's default compress is the kernel, one launch per
    pp(); C equals the plain route's (structure exactly, values to the
    sum order's rounding)."""
    at, btm = _port_operands("banded8192", device=cuda)
    pp = bt.prepare_product(at, btm)
    assert pp.compress_mode == "scatter"
    for _ in range(3):
        before = bitmap_compress.launches
        c = pp()
        torch.cuda.synchronize()
        assert bitmap_compress.launches == before + 1
    _same_c(c, bt.prepare_product(at, btm, impl="plain")())
