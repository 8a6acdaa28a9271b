"""The Galerkin chain of an AMG re-set-up (ops/galerkin.py) and the
device structure operations under it (format/layout.py).

  * `transpose` and `relayout` round-trip bit for bit, at sizes that are
    not multiples of 8, padded or not; each returns its value
    permutation; the transpose equals the host COO round trip
    (format/convert.py::transpose) on the valid blocks and scipy's .T;
  * `tiles_from_values` through `value_slots` is decompress_blocks_flat;
  * `prepare_product` on rectangular operands (sizes not multiples of 8,
    B in either layout) against scipy in float64;
  * a three-level `prepare_galerkin` chain on HPCG's 27-point operator at
    12^3 under impl="plain" against the plain reference
    (tests/_galerkin_reference.py, float64 torch, no port code): the
    pattern exact, the values within float32 rounding of their scale;
  * an A of another structure raises.

The cases marked `gpu` run the chain under impl="auto" on the card (the
product kernels and the bitmap-rank compress) against impl="plain" there;
they import no JAX:
    python -m pytest tests/test_torch_galerkin.py --noconftest -m gpu
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

import _galerkin_reference as ref  # noqa: E402

import bmsparse_tpu_torch as bt  # noqa: E402
from bmsparse_tpu_torch.format import layout  # noqa: E402
from bmsparse_tpu_torch.format.convert import transpose as host_transpose  # noqa: E402
from bmsparse_tpu_torch.utils import timing  # noqa: E402

FIELDS = ("brow", "bcol", "bmp_hi", "bmp_lo", "offsets", "values")
SHAPES = [(37, 21), (64, 64), (5, 130), (130, 9)]
# Chained float32 products, judged per entry against |R| |A| |P|: each
# entry is a sum of at most a few hundred float32 products, rounded once
# per step, so its error stays within some hundreds of 2^-24 of that
# scale; the chain reads about 1e-7 here and bfloat16 (2^-8) about 1e-3.
GAP = 1e-5


def _random(shape, density, seed, transposed, padded):
    rng = np.random.default_rng(seed)
    s = sp.random(*shape, density=density, random_state=rng, format="coo",
                  dtype=np.float32)
    m = bt.coo_to_bmsparse(s.row, s.col, s.data, shape,
                           transposed=transposed,
                           backend="device" if padded else "host",
                           device="cpu")
    if padded:
        m = m.pad_to(m.nb_pad + 3, m.nnz_pad + 5)
    return s, m


def _same(x, y):
    for f in FIELDS:
        assert torch.equal(getattr(x, f), getattr(y, f)), f
    assert (x.nb, x.nnz, x.shape, x.transposed) == (y.nb, y.nnz, y.shape,
                                                     y.transposed)


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_transpose_round_trips_and_is_the_transpose(shape, transposed,
                                                    padded):
    s, m = _random(shape, 0.15, sum(shape), transposed, padded)
    for want in (None, False, True):
        t, perm = layout.transpose(m, want)
        assert t.transposed == (transposed if want is None else want)
        assert t.shape == shape[::-1]
        assert torch.equal(t.values, m.values[perm])
        np.testing.assert_array_equal(t.to_scipy().toarray(),
                                      s.T.toarray().astype(np.float64))
        h = host_transpose(m, want)
        for f in FIELDS[:-1]:
            assert torch.equal(getattr(t, f)[:h.nb], getattr(h, f)[:h.nb]), f
        assert torch.equal(t.values[:t.nnz], h.values[:h.nnz])
        back, perm2 = layout.transpose(t, transposed)
        _same(back, m)
        assert torch.equal(perm[perm2], torch.arange(m.nnz_pad))


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_layout_switch_round_trips_and_keeps_the_matrix(shape, transposed,
                                                        padded):
    s, m = _random(shape, 0.2, 2 * sum(shape), transposed, padded)
    sw, perm = layout.relayout(m, not transposed)
    assert sw.transposed == (not transposed)
    assert torch.equal(sw.values, m.values[perm])
    assert torch.equal(sw.decompress_blocks_flat(),
                       m.decompress_blocks_flat())
    np.testing.assert_array_equal(sw.to_scipy().toarray(),
                                  s.toarray().astype(np.float64))
    back, perm2 = layout.relayout(sw, transposed)
    _same(back, m)
    assert torch.equal(perm[perm2], torch.arange(m.nnz_pad))
    same, ident = layout.relayout(m, transposed)
    assert same is m and torch.equal(ident, torch.arange(m.nnz_pad))
    # the packed values to the dense tiles, in one scatter
    for x in (m, sw):
        tiles = layout.tiles_from_values(x.values, layout.value_slots(x),
                                         x.nb_pad)
        assert torch.equal(tiles, x.decompress_blocks_flat())


@pytest.mark.parametrize("b_transposed", [False, True])
@pytest.mark.parametrize("m,k,n", [(37, 21, 13), (100, 45, 203),
                                   (9, 130, 7), (64, 8, 3)])
def test_rectangular_prepared_product_matches_scipy(m, k, n, b_transposed):
    rng = np.random.default_rng(m * k + n)
    a = sp.random(m, k, density=0.2, random_state=rng, format="coo",
                  dtype=np.float32)
    b = sp.random(k, n, density=0.2, random_state=rng, format="coo",
                  dtype=np.float32)
    am = bt.coo_to_bmsparse(a.row, a.col, a.data, (m, k), device="cpu")
    bm = bt.coo_to_bmsparse(b.row, b.col, b.data, (k, n),
                            transposed=b_transposed, device="cpu")
    want = (a.astype(np.float64) @ b.astype(np.float64)).toarray()
    pp = bt.prepare_product(am, bm, impl="plain")
    for c in (pp(), pp(am.astype(torch.float32), bm),
              bt.spgemm(am, bm, impl="plain")):
        assert c.shape == (m, n)
        np.testing.assert_allclose(c.to_scipy().toarray(), want, rtol=1e-5,
                                   atol=1e-6)
    # C's pattern is the structural product (no cancellation in |A| |B|)
    pattern = (abs(a) @ abs(b)).tocoo()
    r, c, _ = pp().generate_coo()
    assert set(zip(r.tolist(), c.tolist())) == set(
        zip(pattern.row.tolist(), pattern.col.tolist()))


def _hpcg(n, off=None, device="cpu"):
    """HPCG's 27-point operator on an n^3 grid as a reference Sparse:
    diagonal 26, off-diagonals -1 or the given (27, n^3) values."""
    g = torch.arange(n ** 3, device=device)
    z, y, x = g // (n * n), (g // n) % n, g % n
    rows, cols, vals = [], [], []
    k = 0
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                ok = ((z + dz >= 0) & (z + dz < n) & (y + dy >= 0)
                      & (y + dy < n) & (x + dx >= 0) & (x + dx < n))
                rows.append(g[ok])
                cols.append(g[ok] + (dz * n + dy) * n + dx)
                if (dz, dy, dx) == (0, 0, 0):
                    v = torch.full((n ** 3,), 26.0)
                elif off is None:
                    v = torch.full((n ** 3,), -1.0)
                else:
                    v = off[k]
                vals.append(v[ok.cpu()].to(device=device,
                                            dtype=torch.float64))
                k += 1
    return ref.Sparse(torch.cat(rows), torch.cat(cols), torch.cat(vals),
                      (n ** 3, n ** 3)).sorted()


def _to_bm(s, device):
    return bt.coo_to_bmsparse(s.rows, s.cols, s.vals.float(), s.shape,
                              backend="device", device=device)


def _decoded(c):
    """A BmSparse as a reference Sparse of float64 values, sorted."""
    r, cc, v = c.generate_coo()
    return ref.Sparse(torch.from_numpy(r), torch.from_numpy(cc),
                      torch.from_numpy(v), c.shape).sorted()


def _gap(got, want):
    """(pattern mismatch, largest |got - want| / scale): want carries the
    value and its scale |R| |A| |P| as two columns."""
    want = ref.Sparse(*(x.cpu() for x in (want.rows, want.cols,
                                          want.vals)), want.shape)
    if not torch.equal(got.keys(), want.keys()):
        return 1, float("inf")
    d = (got.vals - want.vals[:, 0]).abs()
    return 0, float((d / want.vals[:, 1]).max())


def _chain(n, levels, impl, device):
    """The first set-up in float64 (the reference's hierarchy), then the
    program's chain from A0 of a second value set: returns the
    hierarchy, the P as the program gets them (float32), the galerkins,
    the outputs of the first set-up and of the re-set-up, and A0's two
    value sets."""
    h = ref.hierarchy(_hpcg(n, device=device), (n, n, n), levels)
    p32 = [dataclasses.replace(p, vals=p.vals.float().double())
           for p in h["p"]]
    g = torch.Generator().manual_seed(7)
    a0_new = _hpcg(n, off=-0.5 - torch.rand((27, n ** 3), generator=g),
                   device=device)
    a = _to_bm(h["a"][0], device)
    gals, first = [], []
    for p in p32:
        gal = bt.prepare_galerkin(a, _to_bm(p, device), impl=impl)
        a = gal(a)
        gals.append(gal)
        first.append(a)
    outs, a = [], _to_bm(a0_new, device)
    for gal in gals:
        a = gal(a)
        outs.append(a)
    return h, p32, gals, first, outs, a0_new


@pytest.fixture(scope="module")
def chain12():
    return _chain(12, 3, "plain", "cpu")


def test_galerkin_chain_matches_the_plain_reference(chain12):
    """Each level against R A P in float64 from the same inputs: A0 as
    generated, then the program's own A_l (so each level's gap is one
    level's rounding), and the P the program got; the pattern is the
    symbolic one of |R| |A| |P| at every level."""
    h, p32, gals, first, outs, a0_new = chain12
    for run, a0 in ((first, h["a"][0]), (outs, a0_new)):
        a_in = a0
        for lvl, (p, c) in enumerate(zip(p32, run)):
            want = ref.galerkin(a_in, p)
            assert c.shape == want.shape == (p.shape[1], p.shape[1])
            assert c.nnz == want.rows.numel() == gals[lvl].num_c_nnz
            got = _decoded(c)
            mismatch, gap = _gap(got, want)
            assert mismatch == 0 and gap < GAP, (lvl, gap)
            a_in = got
    # the first set-up's structures are the reference hierarchy's
    for lvl in range(len(p32)):
        assert torch.equal(_decoded(first[lvl]).keys(),
                           h["a"][lvl + 1].sorted().keys())
    # the chain as a whole, against the float64 chain from the same A0:
    # level 1 is one level's rounding; the values differ from set 0's
    np.testing.assert_allclose(
        _decoded(outs[0]).vals.numpy(),
        ref.galerkin(a0_new, p32[0]).vals[:, 0].numpy(), rtol=1e-5,
        atol=1e-5 * float(h["a"][1].vals.abs().max()))
    assert not torch.equal(outs[0].values, first[0].values)


def test_galerkin_intermediate_is_the_product_a_p(chain12):
    """The first product's output, carried into the second through the
    plan-time map, is A P: the second product's B tiles equal those the
    B operand in the transposed layout decompresses to."""
    h, p32, gals, first, outs, a0_new = chain12
    gal = gals[0]
    a = _to_bm(a0_new, "cpu")
    ap = gal.ap(a, gal.ap.plan.b)
    ap_b, _ = layout.relayout(ap, True)
    tiles = layout.tiles_from_values(ap.values, gal._ap_slots,
                                     gal.rap.plan.b_flat.shape[0])
    assert torch.equal(tiles, ap_b.decompress_blocks_flat())
    c = gal.rap(gal.r, ap_b)
    assert torch.equal(c.values, outs[0].values)
    _, gap = _gap(_decoded(ap), ref.spgemm(ref.with_scale(a0_new),
                                           ref.with_scale(p32[0])))
    assert gap < GAP


def _altered(m, kind):
    if kind == "nnz":
        return dataclasses.replace(m, nnz=m.nnz - 1)
    if kind == "blocks":
        return m.pad_to(m.nb_pad + 1)
    if kind == "layout":
        return layout.relayout(m, True)[0]
    if kind == "shape":
        return dataclasses.replace(m, num_rows=m.num_rows + 1)
    # same counts, another bitmap: one block's two words swapped
    hi, lo = m.bmp_hi.clone(), m.bmp_lo.clone()
    i = int(torch.nonzero(hi != lo)[0])
    hi[i], lo[i] = m.bmp_lo[i], m.bmp_hi[i]
    return dataclasses.replace(m, bmp_hi=hi, bmp_lo=lo)


@pytest.mark.parametrize("kind", ["nnz", "blocks", "layout", "shape",
                                  "bitmaps"])
def test_a_of_another_structure_raises(chain12, kind):
    _, _, gals, first, _, _ = chain12
    with pytest.raises(ValueError, match="structure|bitmaps"):
        gals[1](_altered(first[0], kind))


def test_prepare_galerkin_checks_its_operands():
    a = _to_bm(_hpcg(4), "cpu")
    p = bt.coo_to_bmsparse(np.arange(64), np.arange(64) // 3,
                           np.ones(64, np.float32), (64, 22), device="cpu")
    with pytest.raises(ValueError, match="untransposed"):
        bt.prepare_galerkin(layout.relayout(a, True)[0], p, impl="plain")
    with pytest.raises(ValueError, match="inner dims"):
        bt.prepare_galerkin(a, layout.transpose(p)[0], impl="plain")
    g = bt.prepare_galerkin(a, p, impl="plain")
    assert g.shape == (22, 22) and g.r.shape == (22, 64)
    assert "galerkin.plan" in timing.kept


@pytest.mark.gpu
def test_galerkin_chain_on_the_card():
    """impl="auto" (the product kernels, float32) against impl="plain" on
    the card, on HPCG's operator at 20^3 (three levels): equal patterns,
    values within float32 rounding of their scale, the kernels launched
    by each product, and no host sync inside a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from bmsparse_tpu_torch.ops.cuda import spgemm_kernel as sk
    from bmsparse_tpu_torch.ops.cuda import spgemm_window_kernel as wk

    h, p32, gals, first, outs, a0_new = _chain(20, 3, "auto", "cuda")
    _, _, _, _, plain, _ = _chain(20, 3, "plain", "cuda")
    a_in = a0_new
    for lvl, (p, c, c_plain) in enumerate(zip(p32, outs, plain)):
        want = ref.galerkin(a_in, p)
        got = _decoded(c)
        mismatch, gap = _gap(got, want)
        assert mismatch == 0 and gap < GAP, (lvl, gap)
        assert torch.equal(got.keys(), _decoded(c_plain).keys())
        a_in = ref.Sparse(*(x.cuda() for x in (got.rows, got.cols,
                                               got.vals)), got.shape)
    a = _to_bm(a0_new, "cuda")
    torch.cuda.synchronize()
    before = sk.numeric_sell.launches + wk.numeric_window.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        for gal in gals:
            a = gal(a)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    launched = sk.numeric_sell.launches + wk.numeric_window.launches - before
    assert 2 * len(gals) <= launched <= 4 * len(gals)


@pytest.mark.gpu
def test_galerkin_compress_kernel_on_the_card():
    """Each level call compresses its two products with bitmap_compress
    (two launches), and A_c equals impl="plain"'s: the same structure,
    the values within the products' sum-order rounding."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from bmsparse_tpu_torch.ops.cuda.bitmap_compress_kernel import (
        bitmap_compress,
    )

    _, _, gals, _, outs, a0_new = _chain(12, 3, "auto", "cuda")
    _, _, _, _, plain, _ = _chain(12, 3, "plain", "cuda")
    for c, c_plain in zip(outs, plain):
        for f in FIELDS[:-1]:
            assert torch.equal(getattr(c, f), getattr(c_plain, f)), f
        assert (c.nb, c.nnz, c.shape) == (c_plain.nb, c_plain.nnz,
                                          c_plain.shape)
        scale = float(c_plain.values.abs().max())
        torch.testing.assert_close(c.values, c_plain.values, rtol=GAP,
                                   atol=GAP * scale)
    a = _to_bm(a0_new, "cuda")
    for gal in gals:
        before = bitmap_compress.launches
        a = gal(a)
        torch.cuda.synchronize()
        assert bitmap_compress.launches == before + 2


def test_the_benchmark_holds_the_same_reference():
    """portbench/reference/galerkin.py is this reference, byte for byte."""
    from pathlib import Path

    here = Path(__file__).resolve()
    assert (here.parent / "_galerkin_reference.py").read_bytes() == (
        here.parents[1] / "portbench" / "reference" / "galerkin.py"
    ).read_bytes()


@pytest.mark.parametrize("argv", [["12", "3", "1"], ["20", "4", "2"]])
def test_amg_setup_example_on_the_cpu(argv, capsys):
    from bmsparse_tpu_torch.examples import amg_setup

    assert amg_setup.main([*argv, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "re-set-up:" in out and "rel err vs scipy" in out
    r = amg_setup.run(int(argv[0]), int(argv[1]), 1, device="cpu")
    n = int(argv[0])
    assert r["n"] == n ** 3 and len(r["levels"]) == int(argv[1]) - 1
    assert r["levels"][0] == (-(-n // 3)) ** 3 and r["err"] < 1e-5


def _spans(fn):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return [e.name() for e in prof.profiler.kineto_results.events()
            if e.name().startswith("bmsp.")]


def test_galerkin_and_one_shot_plan_spans(chain12):
    """A Galerkin call opens `bmsp.galerkin` once, around two products,
    A's tiles and one relayout; one-shot spgemm() opens `bmsp.spgemm.plan`
    once around its plan."""
    _, _, gals, first, _, _ = chain12
    names = _spans(lambda: gals[1](first[0]))
    assert names.count("bmsp.galerkin") == 1
    assert names.count("bmsp.galerkin.relayout") == 1
    assert names.count("bmsp.product") == 2
    assert names.count("bmsp.product.decompress") == 1
    assert names.count("bmsp.spgemm.compress") == 2
    a = first[0]
    names = _spans(lambda: bt.spgemm(a, layout.relayout(a, True)[0],
                                     impl="plain"))
    assert names.count("bmsp.spgemm.plan") == 1
