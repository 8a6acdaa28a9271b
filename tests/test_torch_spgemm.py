"""The SpGEMM slice of the PyTorch port, on the CPU, against the JAX package.

Plans: the port's _plan_product must build the JAX package's plan arrays
exactly (symbolic tables, sigma order, K-groups, slot tables — window-
relative where a group has a tile window — window plans, compress
columns, C's container fields and the counts), in float32 and bfloat16,
with the window kernel's plans on in both packages
(spgemm_winkernel="on"). Values: the port's spgemm / prepare_product
against JAX spgemm(impl="pallas") (Pallas kernels in interpret mode) at
rtol = atol = 1e-5 (only the order of float32 sums differs), and against
scipy in float64 with the JAX suite's bound, mean relative error < 1e-5.
The port's numeric stage also runs on the JAX package's own plan, carried
across with interop.product_plan_from_numpy. The numeric work tables (one
launch per kernel kind over all K-groups) are the port's own: they are
checked to cover every chunk once, in the stacked row layout, ordered by
the chunk's first A block, and their plain twin against the JAX package's
_numeric_sell_parts.
"""

import dataclasses
import functools

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import bmsparse_tpu as bj
from bmsparse_tpu.ops import spgemm as sgj
from bmsparse_tpu.ops.segsort import sort_by_key as sort_by_key_j
from bmsparse_tpu.utils.timing import PhaseTimer as PhaseTimerJ

import bmsparse_tpu_torch as bt
from bmsparse_tpu_torch.format import bitmap as bm_t
from bmsparse_tpu_torch.config import bucket_size
from bmsparse_tpu_torch.interop import chunk_amin, product_plan_from_numpy
from bmsparse_tpu_torch.ops import spgemm as sgt
from bmsparse_tpu_torch.ops.segsort import segmented_sort, sort_by_key
from bmsparse_tpu_torch.oracle.scipy_oracle import oracle_spgemm
from bmsparse_tpu_torch.utils import roofline
from bmsparse_tpu_torch.utils import testmats as tm
from bmsparse_tpu_torch.utils.timing import PhaseTimer

from conftest import data_path, random_coo
from test_pallas_spgemm_window import _banded as _diag_band

PARITY = dict(rtol=1e-5, atol=1e-5)
MRE = 1e-5


@pytest.fixture(autouse=True)
def _window_plans_on():
    bj.set_config(spgemm_winkernel="on")
    bt.set_config(spgemm_winkernel="on")
    yield
    bj.set_config(spgemm_winkernel="auto")
    bt.set_config(spgemm_winkernel="auto")


def _ragusa():
    r, c, v, shape = bt.read_matrix_market(data_path("A_matrix.mtx"))
    return (r, c, v, shape), (r, c, v, shape), True


def _random(ashape, bshape, density):
    a = (*random_coo(*ashape, density=density, seed=1), ashape)
    b = (*random_coo(*bshape, density=density, seed=2), bshape)
    return a, b, True


def _square(gen, n):
    return (*gen, (n, n))


def _empty():
    one = np.array([1.0], np.float32)
    return ((np.array([0], np.int32), np.array([0], np.int32), one, (16, 16)),
            (np.array([8], np.int32), np.array([0], np.int32), one, (16, 16)),
            True)


def _structural_zeros():
    rows = np.array([0, 0, 1, 1], np.int32)
    cols = np.array([0, 1, 0, 1], np.int32)
    return ((rows, cols, np.ones(4, np.float32), (8, 8)),
            (rows, cols, np.array([1, 1, -1, -1], np.float32), (8, 8)), True)


def _untransposed():
    a, b, _ = _random((40, 40), (40, 40), 0.1)
    return a, b, False


# name -> () -> (A triplets + shape, B triplets + shape, B transposed)
CASES = {
    "ragusa16": _ragusa,
    "random24": lambda: _random((24, 24), (24, 24), 0.15),
    "random64x48": lambda: _random((64, 48), (48, 80), 0.08),
    "random33x57": lambda: _random((33, 57), (57, 29), 0.12),
    "random128": lambda: _random((128, 128), (128, 128), 0.03),
    "diag_band4096": lambda: (
        _square(_diag_band(4096, [0, 1, -1, 8, -8, 17]), 4096),) * 2 + (True,),
    "blockdense16k": lambda: (
        _square(tm.make_blockdense(16384, 12000, seed=3), 16384),) * 2
        + (True,),
    # six K-groups, five with a tile window and one without
    "fem96": lambda: (tm.fem2d(96, seed=7),) * 2 + (True,),
    "untransposed": _untransposed,
    "empty": _empty,
    "structural_zeros": _structural_zeros,
}


@functools.lru_cache(maxsize=None)
def _operands(name, dtype="float32"):
    """(A, B) in both packages, and scipy A @ B of the stored values."""
    a, b, b_t = CASES[name]()
    dj, dt = getattr(jnp, dtype), getattr(torch, dtype)
    aj = bj.coo_to_bmsparse(*a, backend="host").astype(dj)
    bjm = bj.coo_to_bmsparse(*b, transposed=b_t, backend="host").astype(dj)
    at = bt.coo_to_bmsparse(*a, device="cpu").astype(dt)
    btm = bt.coo_to_bmsparse(*b, transposed=b_t, device="cpu").astype(dt)
    ref = (at.to_scipy().tocsr() @ btm.to_scipy().tocsr()).tocsr()
    return aj, bjm, at, btm, ref


@functools.lru_cache(maxsize=None)
def _plans(name, dtype="float32"):
    bj.set_config(spgemm_winkernel="on")
    bt.set_config(spgemm_winkernel="on")
    aj, bjm, at, btm, _ = _operands(name, dtype)
    pj = sgj._plan_product(aj, bjm, None, None, PhaseTimerJ(False), False)
    pt = sgt._plan_product(at, btm, None, None, PhaseTimer(False), False)
    return pj, pt


def _np(x, words=False):
    """A plan array as int64 numpy; bitmap words through uint32."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy().astype(np.int64)
    x = np.asarray(x)
    return (x.view(np.uint32) if words else x).astype(np.int64)


def _jax_plan_arrays(pj) -> dict:
    """The JAX plan's fields on the host, as product_plan_from_numpy
    takes them."""
    host = {f: np.asarray(getattr(pj, f)) for f in (
        "keys_tbl", "cbrow", "cbcol", "c_hi", "c_lo", "c_off")}
    host["sig_st"] = tuple(np.asarray(x) for x in pj.sig_st)
    for f in ("tas", "tbs"):
        host[f] = tuple(np.asarray(x) for x in getattr(pj, f))
    host["pws"] = tuple(None if w is None else tuple(np.asarray(x) for x in w)
                        for w in pj.pws)
    for f in ("groups", "pwin", "nnz_pad", "num_c_blocks", "num_c_nnz",
              "num_tasks", "num_alive", "nba_pad", "nbb_pad"):
        host[f] = getattr(pj, f)
    return host


COUNTS = ("num_tasks", "num_alive", "num_c_blocks", "num_c_nnz", "jmax",
          "nbc_pad", "nb_pad_c", "nnz_pad", "nba_pad", "nbb_pad")


def assert_same_plan(pj, pt):
    for f in COUNTS:
        assert getattr(pj, f) == getattr(pt, f), f
    assert [tuple(g) for g in pj.groups] == [tuple(g) for g in pt.groups]
    assert tuple(pj.pwin) == tuple(pt.pwin)
    assert tuple(pj.win) == tuple(pt.win)
    kj = _np(pj.keys_tbl)
    kj[:, 2:4] = _np(np.asarray(pj.keys_tbl)[:, 2:4], words=True)
    pairs = [("keys_tbl", kj, _np(pt.keys_tbl))]
    for f in ("c_seg", "a_idx", "b_idx", "starts_sig", "cnt_sig", "ends_sig",
              "cbrow", "cbcol", "c_off"):
        pairs.append((f, _np(getattr(pj, f)), _np(getattr(pt, f))))
    for f in ("c_hi", "c_lo"):
        pairs.append((f, _np(getattr(pj, f), words=True),
                      _np(getattr(pt, f))))
    for i, (x, y) in enumerate(zip(pj.sig_st, pt.sig_st, strict=True)):
        pairs.append((f"sig_st[{i}]", _np(x, words=i < 2), _np(y)))
    for f in ("tas", "tbs", "win_starts", "pws"):
        for g, (x, y) in enumerate(zip(getattr(pj, f), getattr(pt, f),
                                       strict=True)):
            if f in ("win_starts", "pws"):
                assert (x is None) == (y is None), f"{f}[{g}]"
                for s, (xs, ys) in enumerate(zip(x or (), y or ())):
                    pairs.append((f"{f}[{g}][{s}]", _np(xs), _np(ys)))
            else:
                pairs.append((f"{f}[{g}]", _np(x), _np(y)))
    for name, x, y in pairs:
        assert x.shape == y.shape, name
        np.testing.assert_array_equal(x, y, err_msg=name)


def _values(c):
    return c.values[: c.nnz].float().cpu().numpy() if isinstance(
        c.values, torch.Tensor) else np.asarray(c.values)[: c.nnz]


def assert_same_c(cj, ct):
    """C's structure exactly, its values to PARITY."""
    assert int(cj.nb) == ct.nb and cj.nnz == ct.nnz
    for f in ("brow", "bcol", "offsets"):
        np.testing.assert_array_equal(_np(getattr(cj, f)), _np(getattr(ct, f)),
                                      err_msg=f)
    for f in ("bmp_hi", "bmp_lo"):
        np.testing.assert_array_equal(_np(getattr(cj, f), words=True),
                                      _np(getattr(ct, f)), err_msg=f)
    np.testing.assert_allclose(_values(ct), _values(cj), **PARITY)


# ---------------------------------------------------------------------------
# plans, compared exactly
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(CASES))
def test_plan_matches_jax(name):
    pj, pt = _plans(name)
    assert_same_plan(pj, pt)
    if name == "diag_band4096":
        assert all(w is not None for w in pt.pwin)
        assert all(ta.shape[2] == 8 for ta in pt.tas)
    if name == "blockdense16k":
        assert len(pt.groups) > 1 and all(w is None for w in pt.pwin)
    if name == "empty":
        assert pt.num_c_blocks == 0 and not pt.groups


@pytest.mark.parametrize("name", ["ragusa16", "diag_band4096",
                                  "blockdense16k", "random33x57"])
def test_plan_matches_jax_bf16(name):
    pj, pt = _plans(name, "bfloat16")
    assert pt.a_flat.dtype == torch.bfloat16
    assert_same_plan(pj, pt)


def test_slab_window_plans_match_jax(monkeypatch):
    """The JAX package's slab windows, forced on at a small size as its own
    test does, plan the same in the port (whose numeric_sell then runs
    those groups on their absolute slot tables)."""
    for mod in (sgj, sgt):
        monkeypatch.setattr(mod, "_WIN_TABLE_MIN_ROWS", 8)
        monkeypatch.setattr(mod, "_SELL_SLAB", 2)
    a = _square(tm.make_banded(16384, 12, seed=21), 16384)
    aj = bj.coo_to_bmsparse(*a, backend="host")
    bjm = bj.coo_to_bmsparse(*a, transposed=True, backend="host")
    at = bt.coo_to_bmsparse(*a, device="cpu")
    btm = bt.coo_to_bmsparse(*a, transposed=True, device="cpu")
    bj.set_config(spgemm_winkernel="off")
    bt.set_config(spgemm_winkernel="off")
    pj = sgj._plan_product(aj, bjm, None, None, PhaseTimerJ(False), False)
    pt = sgt._plan_product(at, btm, None, None, PhaseTimer(False), False)
    assert any(wa or wb for wa, wb in pt.win)
    assert_same_plan(pj, pt)
    ref = (at.to_scipy().tocsr() @ btm.to_scipy().tocsr()).tocsr()
    assert bt.mean_relative_error(bt.prepare_product(at, btm)(), ref) < MRE


# ---------------------------------------------------------------------------
# the slice: values against JAX and scipy
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(CASES))
def test_spgemm_matches_scipy(name):
    _, _, at, btm, ref = _operands(name)
    c = bt.spgemm(at, btm)
    assert c.values.dtype == torch.float32 and not c.transposed
    assert bt.mean_relative_error(c, ref) < MRE
    assert c.nnz >= ref.nnz
    # the cached product gives the same C
    c2 = bt.prepare_product(at, btm)()
    assert_same_c(c, c2)
    if name == "structural_zeros":
        assert c.nnz == 4 and not c.values[:4].any()
    if name == "empty":
        assert c.nb == 0 and c.generate_coo()[0].size == 0


@pytest.mark.parametrize("name,dtype", [("ragusa16", "float32"),
                                        ("random24", "float32"),
                                        ("structural_zeros", "float32"),
                                        ("random24", "bfloat16")])
def test_spgemm_matches_jax_pallas(name, dtype):
    aj, bjm, at, btm, ref = _operands(name, dtype)
    cj = sgj.spgemm(aj, bjm, impl="pallas")
    ct = bt.spgemm(at, btm)
    assert_same_c(cj, ct)
    assert ct.values.dtype == torch.float32
    # the oracle sees the stored (bfloat16-rounded) values
    assert bt.mean_relative_error(ct, ref) < MRE


@pytest.mark.parametrize("name", ["diag_band4096", "blockdense16k",
                                  "random128", "untransposed"])
def test_numeric_on_jax_plan(name):
    """The port's numeric stage on the JAX package's plan (carried across
    by product_plan_from_numpy) gives the port's own C: plan and numeric
    agree independently."""
    pj, pt = _plans(name)
    _, _, at, btm, ref = _operands(name)
    p = product_plan_from_numpy(at, btm, _jax_plan_arrays(pj))
    c = sgt._assemble_c(p, sgt._numeric_from_plan(p, kernels=False))
    assert_same_c(c, bt.spgemm(at, btm))
    assert bt.mean_relative_error(c, ref) < MRE


@pytest.mark.parametrize("name", ["diag_band4096", "fem96", "blockdense16k",
                                  "random33x57"])
def test_work_tables_cover_every_chunk(name):
    """One numeric_window table over the windowed groups, one numeric_sell
    table over the others: every chunk of every group exactly once (the
    bucketed chunk count, padding chunks included), its rows at the
    stacked layout's offset, its slot rows and window starts those of the
    group's tables, and the rows in non-decreasing order of the chunk's
    first A block."""
    _, pt = _plans(name)
    win, sell = pt.launches
    nb_a = pt.a_flat.shape[0]
    amin = chunk_amin(pt.groups, pt.pwin,
                      [None if w is None else [x.numpy() for x in w]
                       for w in pt.pws],
                      [t.numpy() for t in pt.tas], nb_a)
    big = np.iinfo(np.int64).max
    seen = {}
    row0 = 0
    starts = []
    for g, (_, c0, c1) in enumerate(pt.groups):
        starts.append(row0)
        row0 += bucket_size(c1 - c0, minimum=1) * 128
    assert pt.rows == row0
    for launch, is_win in ((win, True), (sell, False)):
        if launch is None:
            assert all((w is not None) != is_win for w in pt.pwin)
            continue
        stride = 8 if is_win else 1
        keys = []
        for kg, slot, wsa, wsb, oc in launch.work.tolist():
            g = max(i for i, r in enumerate(starts) if r <= oc * 128)
            j = oc - starts[g] // 128
            kg_g, c0, c1 = pt.groups[g]
            assert (pt.pwin[g] is not None) == is_win and kg == kg_g
            assert (g, j) not in seen
            seen[(g, j)] = True
            rows = launch.slots_a[slot + np.arange(kg) * stride]
            if is_win:
                t = pt.pwin[g][2]
                tile, tt = divmod(j, t)
                want = pt.tas[g][tile, :, tt]
                assert (wsa, wsb) == (int(pt.pws[g][0][tile]),
                                      int(pt.pws[g][1][tile]))
            else:
                want = pt.tas[g][j]
                assert wsa == wsb == 0
            assert torch.equal(rows, want)
            keys.append(amin[c0 + j] if j < c1 - c0 else big)
        assert keys == sorted(keys)
    for g, (_, c0, c1) in enumerate(pt.groups):
        n = bucket_size(c1 - c0, minimum=1)
        assert [j for gg, j in seen if gg == g] == list(range(n))
    if name == "fem96":
        assert win is not None and sell is not None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_product_twin_matches_jax_numeric(dtype):
    """The per-product plain twin (both kinds' launches into one c_rows)
    against the JAX package's _numeric_sell_parts, Pallas kernels in
    interpret mode, on a plan with window and sell groups."""
    pj, pt = _plans("fem96", dtype)
    assert None in pt.pwin and any(w is not None for w in pt.pwin)
    want = np.asarray(sgj._numeric_sell_parts(
        pj.a_flat, pj.b_flat, pj.tas, pj.tbs, pj.groups, "pallas", pj.win,
        pj.win_starts, pj.pwin, pj.pws, pj.nba_pad, pj.nbb_pad))
    got = sgt._numeric_products(pt.a_flat, pt.b_flat, pt.launches, pt.rows,
                                kernels=False)
    assert got.shape == want.shape and got.dtype == torch.float32
    # the rows of each group's real chunks: a padding chunk's slots carry
    # the next group's blocks, which may lie outside the tile's window,
    # where the TPU kernel's in-VMEM gather reads positions it does not
    # bound (the port reads the blocks they stand for); their bitmaps are
    # empty, so no compress reads them
    real = np.zeros(pt.rows, bool)
    row0 = 0
    for _, c0, c1 in pt.groups:
        real[row0:row0 + (c1 - c0) * 128] = True
        row0 += bucket_size(c1 - c0, minimum=1) * 128
    assert not (pt.sig_st[0].numpy()[~real] | pt.sig_st[1].numpy()[~real]
                ).any()
    np.testing.assert_allclose(got.numpy()[real], want[real], **PARITY)
    # the kernel wrappers take their plain twins for CPU tensors
    got_k = sgt._numeric_products(pt.a_flat, pt.b_flat, pt.launches, pt.rows,
                                  kernels=True)
    torch.testing.assert_close(got_k, got, rtol=0, atol=0)


def test_cached_product_matches_jax_pallas_mixed_groups():
    aj, bjm, at, btm, ref = _operands("fem96")
    cj = sgj.spgemm(aj, bjm, impl="pallas")
    c = bt.prepare_product(at, btm)()
    assert_same_c(cj, c)
    assert bt.mean_relative_error(c, ref) < MRE


def test_cached_remultiply_with_new_values():
    _, _, at, btm, _ = _operands("diag_band4096")
    pp = bt.prepare_product(at, btm)
    scale = torch.linspace(0.5, 2.0, at.values.shape[0])
    a2 = dataclasses.replace(at, values=at.values * scale)
    c2 = pp(a=a2)
    ref2 = (a2.to_scipy().tocsr() @ btm.to_scipy().tocsr()).tocsr()
    assert bt.mean_relative_error(c2, ref2) < MRE
    assert_same_c(bt.spgemm(a2, btm), c2)
    # Prepared operands give the same product through their dense tiles
    pa = bt.prepare(a2)
    assert_same_c(pp(a=pa), c2)
    r, c, v, shape = _square(tm.make_banded(4096, 4, seed=5), 4096)
    with pytest.raises(ValueError, match="structure"):
        pp(a=bt.coo_to_bmsparse(r, c, v, shape, device="cpu"))


def test_result_feeds_spmv_and_spgemm():
    _, _, at, btm, ref = _operands("random128")
    c = bt.spgemm(at, btm)
    v = np.random.default_rng(0).standard_normal(128).astype(np.float32)
    u = bt.spmv(bt.prepare(c), torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(u, ref @ v, rtol=1e-4, atol=1e-4)
    c3 = bt.spgemm(c, btm)
    assert bt.mean_relative_error(
        c3, (ref @ btm.to_scipy().tocsr()).tocsr()) < 1e-4


def test_float64_runs_plain():
    a, b, b_t = CASES["random64x48"]()
    at = bt.coo_to_bmsparse(*a, device="cpu").astype(torch.float64)
    btm = bt.coo_to_bmsparse(*b, transposed=b_t,
                             device="cpu").astype(torch.float64)
    c = bt.spgemm(at, btm)
    assert c.values.dtype == torch.float64
    assert all(w is None for w in bt.prepare_product(at, btm).plan.pwin)
    ref = (at.to_scipy() @ btm.to_scipy()).tocsr()
    assert bt.mean_relative_error(c, ref) < 1e-12


def test_errors_and_what_is_not_ported():
    _, _, at, btm, _ = _operands("random24")
    # impl="xla" (the chunked numeric) is ported: same C as the default
    c_xla, c = bt.spgemm(at, btm, impl="xla"), bt.spgemm(at, btm)
    assert torch.equal(c_xla.bmp_hi, c.bmp_hi) and c_xla.nnz == c.nnz
    torch.testing.assert_close(c_xla.values, c.values, **PARITY)
    with pytest.raises(ValueError, match="CUDA"):
        bt.spgemm(at, btm, impl="cuda")
    with pytest.raises(ValueError, match="impl"):
        bt.spgemm(at, btm, impl="pallas")
    with pytest.raises(ValueError, match="untransposed"):
        bt.spgemm(btm, btm)
    with pytest.raises(ValueError, match="inner dims"):
        bt.spgemm(at, bt.coo_to_bmsparse(*_empty()[0], transposed=True,
                                         device="cpu"))
    bt.set_config(spgemm_compress="gather")
    try:
        with pytest.raises(ValueError, match="spgemm_compress"):
            bt.spgemm(at, btm)
        with pytest.raises(ValueError, match="spgemm_compress"):
            bt.prepare_product(at, btm)
    finally:
        bt.set_config(spgemm_compress="auto")


def test_verbose_phase_labels(capsys):
    _, _, at, btm, _ = _operands("random24")
    bt.spgemm(at, btm, verbose=True)
    out = capsys.readouterr().out
    for label in ("Task list size:", "Bmp reduction:", "T_1:", "T_3:",
                  "T_6:", "T_9:", "T_9b:", "Toda F:"):
        assert label in out, label
    timer = PhaseTimer(enabled=False)
    with timer.phase("T_1"):
        pass
    timer.report()
    assert capsys.readouterr().out == ""


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b_transposed", [True, False])
def test_bitmap_product_matches_jax(b_transposed):
    from bmsparse_tpu.format import bitmap as bm_j

    rng = np.random.default_rng(7)
    words = [rng.integers(0, 2**32, 500, dtype=np.uint64).astype(np.uint32)
             for _ in range(4)]
    # sparse words too, so that some products are empty
    words = [np.where(rng.random(500) < 0.5, w & (w >> 3) & (w >> 7), w)
             .astype(np.uint32) for w in words]
    want = bm_j.bitmap_product(*(jnp.asarray(w) for w in words),
                               b_transposed=b_transposed)
    got = bm_t.bitmap_product(*(bm_t.words_to_tensor(w) for w in words),
                              b_transposed=b_transposed)
    for x, y in zip(want, got):
        np.testing.assert_array_equal(np.asarray(x), bm_t.tensor_to_words_np(y))
    o = bm_t.bitmap_or(*(bm_t.words_to_tensor(w) for w in words))
    np.testing.assert_array_equal(bm_t.tensor_to_words_np(o[0]),
                                  words[0] | words[2])


def test_sorts_match_lax_sort():
    """Stable and lexicographic: ties keep their input order, as
    jax.lax.sort does."""
    rng = np.random.default_rng(3)
    k0 = rng.integers(-3, 4, 2000).astype(np.int32)
    k1 = rng.integers(0, 5, 2000).astype(np.int32)
    k2 = rng.integers(0, 3, 2000).astype(np.int32)
    val = np.arange(2000, dtype=np.int32)
    for nk, ops in ((1, (k0, val)), (2, (k0, k1, val)),
                    (3, (k0, k1, k2, val))):
        want = sort_by_key_j(*(jnp.asarray(x) for x in ops), num_keys=nk)
        got = sort_by_key(*(torch.from_numpy(x) for x in ops), num_keys=nk)
        for x, y in zip(want, got):
            np.testing.assert_array_equal(np.asarray(x), y.numpy())
    got = segmented_sort(torch.from_numpy(k0), torch.from_numpy(k1),
                         torch.from_numpy(val))
    want = jax.lax.sort((jnp.asarray(k0), jnp.asarray(k1), jnp.asarray(val)),
                        num_keys=2)
    for x, y in zip(want, got):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())


def test_helpers_match_jax(ragusa16):
    from bmsparse_tpu.oracle.scipy_oracle import oracle_spgemm as oracle_j
    from bmsparse_tpu.utils import roofline as roofline_j

    import bench

    c = oracle_spgemm(ragusa16, ragusa16)
    assert (abs(c - oracle_j(ragusa16, ragusa16)) > 0).nnz == 0
    args = (1000, 30, 900, 25, 5000, 12000, 400)
    assert roofline.spgemm_min_bytes(*args) == roofline_j.spgemm_min_bytes(
        *args)
    for gen, args in (("make_banded", (3000, 16)),
                      ("make_blockdense", (4096, 500))):
        for x, y in zip(getattr(tm, gen)(*args, seed=4),
                        getattr(bench, gen)(*args, seed=4)):
            np.testing.assert_array_equal(x, y)
    assert sgt._K_BUCKETS == sgj._K_BUCKETS
    for k in (1, 4, 5, 7, 100, 3 << 19, 1 << 21):
        assert sgt._bucket_k(k) == sgj._bucket_k(k)
    assert sp.issparse(c)
