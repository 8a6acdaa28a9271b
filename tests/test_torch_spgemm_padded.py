"""The port's static-bound SpGEMM and the shard options of its plan and SpMV,
on the CPU, against the JAX package on the same seeded inputs:

  * `_c_symbolic` arrays equal JAX's on the same sorted task list;
  * `spgemm_padded` equals JAX's: C's structure (keys, bitmaps, offsets,
    block count) exactly, values at rtol = atol = 1e-5;
  * `spgemm(impl="xla")` equals JAX's `impl="xla"` the same way;
  * `prepare(force_layout=, col_shift=, sell_unit=8)` plans equal JAX's
    array for array (a shard of a banded matrix, with forced diagonals it
    lacks and forced padding groups);
  * `dia_apply` with `col_shift` (the plain twin) against JAX
    `dia_impl="pallas"` with `max_shift_rows` (interpret mode), including
    shifts past the end of v, and `sell_apply` on a
    shard's pack with a column offset against JAX's `col_base` over its
    slabs and, far columns included, against JAX's `sell_apply` over v
    zeroed outside the window, at rtol = atol = 1e-5;
  * under impl="auto" float64 takes the plain path on a CUDA device.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

import bmsparse_tpu as bj
from bmsparse_tpu.ops import spgemm as sgj
from bmsparse_tpu.ops import spmv as spmv_j
from bmsparse_tpu.ops.plan import prepare as prepare_j

import bmsparse_tpu_torch as bt
from bmsparse_tpu_torch.ops import spgemm as sgt
from bmsparse_tpu_torch.ops import spmv as spmv_t
from bmsparse_tpu_torch.ops.plan import prepare as prepare_t
from bmsparse_tpu_torch.utils import testmats as tm

from conftest import random_coo
from test_torch_plan import assert_same_plan

PARITY = dict(rtol=1e-5, atol=1e-5)


def _pair(r, c, v, shape):
    """A and transposed B = A in both packages."""
    return (bj.coo_to_bmsparse(r, c, v, shape, backend="host"),
            bj.coo_to_bmsparse(r, c, v, shape, transposed=True,
                               backend="host"),
            bt.coo_to_bmsparse(r, c, v, shape, device="cpu"),
            bt.coo_to_bmsparse(r, c, v, shape, transposed=True,
                               device="cpu"))


CASES = {
    "random96": lambda: _pair(*random_coo(96, 96, density=0.06, seed=43),
                              (96, 96)),
    "band512": lambda: _pair(*tm.make_banded(512, 6, seed=4), (512, 512)),
    "rect": lambda: (
        bj.coo_to_bmsparse(*random_coo(40, 72, 0.1, seed=1), (40, 72),
                           backend="host"),
        bj.coo_to_bmsparse(*random_coo(72, 56, 0.1, seed=2), (72, 56),
                           transposed=True, backend="host"),
        bt.coo_to_bmsparse(*random_coo(40, 72, 0.1, seed=1), (40, 72),
                           device="cpu"),
        bt.coo_to_bmsparse(*random_coo(72, 56, 0.1, seed=2), (72, 56),
                           transposed=True, device="cpu")),
}


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _words(x):
    """Bitmap words of either package as uint32."""
    return _np(x).astype(np.int64).astype(np.uint32)


def _same_c(cj, ct, nb_equal=True):
    for f in ("brow", "bcol", "offsets"):
        np.testing.assert_array_equal(_np(getattr(ct, f)),
                                      _np(getattr(cj, f)), err_msg=f)
    for f in ("bmp_hi", "bmp_lo"):
        np.testing.assert_array_equal(_words(getattr(ct, f)),
                                      _words(getattr(cj, f)), err_msg=f)
    assert int(ct.nb) == int(cj.nb)
    assert ct.values.shape[0] == cj.values.shape[0]
    np.testing.assert_allclose(_np(ct.values), _np(cj.values), **PARITY)


def _max_tasks(at, btm):
    """A task bound that holds: the bucketed task total."""
    from bmsparse_tpu_torch.config import bucket_size

    return bucket_size(int(sgt._task_counts(at, btm, btm.block_rows)[3]))


@pytest.mark.parametrize("name", sorted(CASES))
def test_c_symbolic_matches_jax(name):
    aj, bj_, at, btm = CASES[name]()
    nt = _max_tasks(at, btm)
    sent = aj.block_rows + 1
    _, offs, brs, total = sgj._task_counts(aj, bj_, bj_.block_rows)
    a_idx, b_idx, ck_row, ck_col, ph, pl, _ = sgj._build_tasks(
        aj, bj_, offs, brs, total, nt, sent)
    want = sgj._c_symbolic(ph, pl, ck_row, ck_col, sent)
    got = sgt._c_symbolic(
        torch.from_numpy(np.asarray(ph).astype(np.int64)),
        torch.from_numpy(np.asarray(pl).astype(np.int64)),
        torch.from_numpy(np.array(ck_row)),
        torch.from_numpy(np.array(ck_col)), sent)
    names = ("c_seg", "cbrow", "cbcol", "c_hi", "c_lo", "c_offsets", "nbc",
             "nnzc")
    for n, x, y in zip(names, want, got):
        np.testing.assert_array_equal(_np(y).astype(np.int64),
                                      np.asarray(x).astype(np.int64),
                                      err_msg=n)
    # the port's task list is the JAX package's, padding included
    _, offs_t, brs_t, total_t = sgt._task_counts(at, btm, btm.block_rows)
    got_tasks = sgt._build_tasks(at, btm, offs_t, brs_t, total_t, nt, sent)
    for n, x, y in zip(("a_idx", "b_idx", "ck_row", "ck_col"),
                       (a_idx, b_idx, ck_row, ck_col), got_tasks):
        np.testing.assert_array_equal(_np(y), np.asarray(x), err_msg=n)


@pytest.mark.parametrize("name", sorted(CASES))
def test_spgemm_padded_matches_jax(name):
    aj, bj_, at, btm = CASES[name]()
    nt = _max_tasks(at, btm)
    cj = sgj.spgemm_padded(aj, bj_, max_tasks=nt)
    ct = sgt.spgemm_padded(at, btm, nt)
    assert torch.is_tensor(ct.nb) and ct.nnz == cj.nnz
    _same_c(cj, ct)
    ref = (at.to_scipy() @ btm.to_scipy()).tocsr()
    assert bt.mean_relative_error(ct, ref) < 1e-5


def test_spgemm_padded_tight_bounds():
    """Block, value and task bounds below what the product needs cut the
    padded result where JAX's does."""
    aj, bj_, at, btm = CASES["random96"]()
    nt = _max_tasks(at, btm)
    nbc = int(sgt.spgemm_padded(at, btm, nt).nb)
    kw = dict(max_c_blocks=nbc + 3, max_c_nnz=64 * nbc)
    _same_c(sgj.spgemm_padded(aj, bj_, max_tasks=nt, **kw),
            sgt.spgemm_padded(at, btm, nt, **kw))
    # a task bound that does not hold cuts the task list where JAX's does
    _same_c(sgj.spgemm_padded(aj, bj_, max_tasks=nt // 2),
            sgt.spgemm_padded(at, btm, nt // 2))


@pytest.mark.parametrize("name", sorted(CASES))
def test_spgemm_xla_matches_jax(name):
    aj, bj_, at, btm = CASES[name]()
    cj = bj.spgemm(aj, bj_, impl="xla")
    ct = bt.spgemm(at, btm, impl="xla")
    assert ct.nb == int(cj.nb) and ct.nnz == cj.nnz
    _same_c(cj, ct)
    np.testing.assert_allclose(ct.values.numpy(),
                               bt.spgemm(at, btm).values.numpy(), **PARITY)


def test_spgemm_xla_float64_and_empty():
    _, _, at, btm = CASES["rect"]()
    a64, b64 = at.astype(torch.float64), btm.astype(torch.float64)
    c = bt.spgemm(a64, b64, impl="xla")
    assert c.values.dtype == torch.float64
    ref = (at.to_scipy() @ btm.to_scipy()).tocsr()
    assert bt.mean_relative_error(c, ref) < 1e-12
    one = np.array([1.0], np.float32)
    a = bt.coo_to_bmsparse(np.array([0], np.int32), np.array([0], np.int32),
                           one, (16, 16), device="cpu")
    b = bt.coo_to_bmsparse(np.array([8], np.int32), np.array([0], np.int32),
                           one, (16, 16), transposed=True, device="cpu")
    c = bt.spgemm(a, b, impl="xla")
    assert c.nb == 0 and not c.values.any()
    with pytest.raises(ValueError, match="xla"):
        bt.prepare_product(at, btm, impl="xla")


# ---------------------------------------------------------------------------
# shard options of prepare, dia_apply and sell_apply
# ---------------------------------------------------------------------------
def _shard(n=2048, bpr=128, s=1, extra=True, own_cols=False):
    """Shard s of a banded matrix with a few far entries: rows localized,
    columns global, as parallel/plan.py builds it. own_cols keeps only
    the entries in the shard's own column slice, which every halo window
    holds."""
    r, c, v = tm.make_banded(n, 5, seed=21)
    if extra:
        rng = np.random.default_rng(22)
        rr = rng.integers(0, n, 300)
        cc = rng.integers(0, n, 300)
        key = np.unique(np.concatenate([r.astype(np.int64) * n + c,
                                        rr * n + cc]))
        r, c = (x.astype(np.int32) for x in np.divmod(key, n))
        v = rng.standard_normal(len(r)).astype(np.float32)
    lo, hi = s * bpr * 8, (s + 1) * bpr * 8
    keep = (r >= lo) & (r < hi)
    if own_cols:
        keep &= (c >= lo) & (c < hi)
    r, c, v = r[keep] - lo, c[keep], v[keep]
    shape = (bpr * 8, n)
    return (bj.coo_to_bmsparse(r, c, v, shape, backend="host"),
            bt.coo_to_bmsparse(r, c, v, shape, device="cpu"), lo)


@pytest.mark.parametrize("forced", [False, True])
def test_prepare_shard_options_match_jax(forced):
    mj, mt, shift = _shard()
    layout = None
    if forced:
        base = prepare_j(mj, col_shift=shift, sell_unit=8)
        groups = tuple((k, d.shape[1] + 1) for k, d in
                       zip(base.sell_ks, base.sell_dense)) + ((1, 2),)
        groups = tuple(sorted(groups, reverse=True))
        layout = (tuple(sorted(base.dia_offsets + (-700, 700))), groups)
    pj = prepare_j(mj, force_layout=layout, col_shift=shift, sell_unit=8)
    pt = prepare_t(mt, force_layout=layout, col_shift=shift, sell_unit=8)
    assert pt.dia is not None and pt.sell_ks and pt.stream is None
    assert all(pk is None for pk in pt.sell_pack)
    assert_same_plan(pj, pt)


def test_prepare_forced_layout_empty_shard_and_errors():
    _, mt, shift = _shard()
    e = np.empty(0, np.int32)
    mj0 = bj.coo_to_bmsparse(e, e, np.empty(0, np.float32), (1024, 2048),
                             backend="host")
    mt0 = bt.coo_to_bmsparse(e, e, np.empty(0, np.float32), (1024, 2048),
                             device="cpu")
    layout = ((-1, 0, 1), ((3, 2), (1, 1)))
    kw = dict(force_layout=layout, col_shift=shift, sell_unit=8)
    assert_same_plan(prepare_j(mj0, **kw), prepare_t(mt0, **kw))
    with pytest.raises(ValueError, match="lacks K groups"):
        prepare_t(mt, force_layout=((0,), ((1, 64),)), col_shift=shift,
                  sell_unit=8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shift,max_rows", [(0, 0), (256, 0), (1024, 0),
                                             (5120, 40)])
def test_dia_apply_col_shift_matches_jax(shift, max_rows, dtype):
    """The tall case: shifts past the end of v read zeros (JAX sizes its
    sliced copy of v by max_shift_rows; the port reads v at the shift)."""
    rng = np.random.default_rng(shift + 3)
    offs = (-130, -1, 0, 2, 129)
    dia = rng.standard_normal((len(offs), 16, 128)).astype(np.float32)
    n = 3000
    v = rng.standard_normal(n).astype(np.float32)
    want = np.asarray(spmv_j.dia_apply(
        jnp.asarray(dia, getattr(jnp, dtype)), offs, jnp.asarray(v), n,
        dia_impl="pallas", col_shift=jnp.int32(shift),
        max_shift_rows=max_rows))
    got = spmv_t.dia_apply(torch.from_numpy(dia).to(getattr(torch, dtype)),
                           offs, torch.from_numpy(v), col_shift=shift)
    np.testing.assert_allclose(got.numpy(), want, **PARITY)
    if shift == 5120:
        assert not got.any()


@pytest.mark.parametrize("hl", [0, 128, 256])
def test_sell_apply_col_base_matches_jax(hl):
    """Halo mode: vpad is the window of v from column lo, which the port
    reads through the shard's gathered pack at col_off = lo. On a shard
    whose columns all lie in its own slice (as a halo plan proves), it
    equals the JAX package's halo mode, its slabs read from block column
    col_base = lo / 8. On the whole shard, far columns included, it
    equals the JAX package's sell_apply over v zeroed outside the window:
    a column outside reads 0."""
    for own_cols in (True, False):
        mj, mt, shift = _shard(own_cols=own_cols)
        pj = prepare_j(mj, col_shift=shift, sell_unit=8)
        pt = prepare_t(mt, col_shift=shift, sell_unit=8)
        assert pt.sell_gpack.nnz > 0
        n = mt.num_cols
        v = np.random.default_rng(hl).standard_normal(n).astype(np.float32)
        lo = shift - hl
        win = np.zeros(1024 + 2 * hl, np.float32)
        src = v[max(lo, 0):lo + win.shape[0]]
        win[max(-lo, 0):max(-lo, 0) + src.shape[0]] = src
        if own_cols:
            want = spmv_j.sell_apply(
                pj.sell_dense, pj.sell_bcol, pj.out_gather, jnp.asarray(win),
                win.shape[0] // 8, col_base=jnp.int32(lo // 8),
                global_sentinel=-(-n // 8))
        else:
            vz = np.zeros(n, np.float32)
            vz[max(lo, 0):lo + win.shape[0]] = src
            want = spmv_j.sell_apply(pj.sell_dense, pj.sell_bcol,
                                     pj.out_gather, jnp.asarray(vz), n // 8)
        got = spmv_t.sell_apply(pt.sell_chunks, pt.out_gather,
                                torch.from_numpy(win), gpack=pt.sell_gpack,
                                col_off=lo)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **PARITY)


# ---------------------------------------------------------------------------
# float64 under impl="auto"
# ---------------------------------------------------------------------------
def test_auto_resolves_float64_to_plain():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    for use in (sgt._use_kernels, spmv_t._use_kernels):
        assert use("auto", cuda, torch.float32)
        assert use("auto", cuda, torch.bfloat16)
        assert not use("auto", cuda, torch.float64)
        assert not use("auto", cpu, torch.float32)
        assert not use("plain", cuda, torch.float32)
        assert use("cuda", cuda, torch.float32)
        with pytest.raises(NotImplementedError, match="float64"):
            use("cuda", cuda, torch.float64)
        with pytest.raises(ValueError, match="CUDA"):
            use("cuda", cpu, torch.float32)
    assert not sgt._use_kernels("xla", cuda, torch.float32)
