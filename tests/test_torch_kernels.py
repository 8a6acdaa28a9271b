"""The port's SpMV kernels against the JAX package's Pallas kernels, and
the gathered groups' kernel (sell_gather, which replaces no Pallas
kernel) against its plain version.

On the CPU each wrapper (dia_spmv, sell_window) runs its plain torch
version, which is held against the Pallas kernel in interpret mode on the
same inputs: offsets beyond one 128-lane row in both directions, window
widths cw 8 and 64, k-groups deeper than the TPU kernel's k-slice, float32
and bfloat16, and the DIA kernel's column shift (the multi-device path's).
`sell_window` reads a group's pack (sell_kernel.pack_group), built here
from the Pallas kernel's slab; the pack expands back to the slab bit for
bit. Tolerance rtol = atol = 1e-5: only the order of the float32 sums
differs.

The cases marked `gpu` hold the CUDA kernels against the plain versions on
the card and skip where there is none. They import no JAX, so they also
run on a machine without it:
    python -m pytest tests/test_torch_kernels.py --noconftest -m gpu
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from bmsparse_tpu_torch.ops.cuda import sell_kernel as sk
from bmsparse_tpu_torch.ops.cuda.sell_gather_kernel import (
    gather_pack, sell_gather, sell_gather_plain,
)
from bmsparse_tpu_torch.ops.cuda.sell_kernel import (
    pack_group, sell_window, sell_window_plain,
)
from bmsparse_tpu_torch.ops.cuda.spmv_kernel import dia_spmv, dia_spmv_plain
from bmsparse_tpu_torch.utils.testmats import roadnet

TOL = dict(rtol=1e-5, atol=1e-5)

DIA_OFFSETS = {
    "band": tuple(range(-8, 9)),
    "far": (-300, -129, -128, -1, 0, 1, 127, 128, 129, 300),
    "main": (0,),
}

# (cw, kg): kg=24 is deeper than the TPU kernel's k-slice at cw=64 in
# float32 (11) and bfloat16 (23), and as deep as road1M's first K-group
SELL_SHAPES = [(8, 3), (8, 24), (64, 2), (64, 24)]


@pytest.fixture(scope="module")
def ref():
    """The JAX package's kernels, imported here and not at module level so
    that the `gpu` cases run where JAX is not installed."""
    spmv_j = pytest.importorskip("bmsparse_tpu.ops.spmv")
    sell_j = pytest.importorskip("bmsparse_tpu.ops.pallas.sell_kernel")
    return SimpleNamespace(jnp=pytest.importorskip("jax.numpy"),
                           dia_apply=spmv_j.dia_apply, sell=sell_j)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _dia_inputs(offsets, r_rows=24, n=2999, seed=0):
    rng = np.random.default_rng(seed)
    dia = rng.standard_normal((len(offsets), r_rows, 128)).astype(np.float32)
    v = rng.standard_normal(n).astype(np.float32)
    return dia, v


def _sell_inputs(cw, kg, cap=3, seed=0):
    """Random window plan with padding slots (rel 0, dense 0) and windows
    that run past the end of v."""
    rng = np.random.default_rng(seed)
    n = 700 * cw - 5
    ncu = -(-n // cw)
    ncu_pad = sk.ncu_padded(ncu)
    ws = rng.integers(0, ncu_pad - sk.WINDOW_UNITS + 1, cap).astype(np.int32)
    ws[-1] = ncu_pad - sk.WINDOW_UNITS
    rel = rng.integers(0, sk.WINDOW_UNITS, (cap, kg, 128)).astype(np.int32)
    # slabs hold few nonzeros, as the planner's do (a slot covers 8 rows x
    # cw columns of a sparse matrix)
    dense = rng.standard_normal((cw, cap, kg, 8, 128)).astype(np.float32)
    dense = np.where(rng.random(dense.shape) < 0.1, dense, np.float32(0))
    pad = rng.random((cap, kg, 128)) < 0.2
    rel[pad] = 0
    dense[:, pad.nonzero()[0], pad.nonzero()[1], :, pad.nonzero()[2]] = 0
    v = rng.standard_normal(n).astype(np.float32)
    return dense, rel, ws, v, n, ncu, ncu_pad


def _t(x, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t if dtype is None else t.to(dtype)


def _pack(dense, rel, ws, dtype=torch.float32):
    return pack_group(_t(dense, dtype), _t(rel), _t(ws))


def _kronecker(scale, edgefactor=16, seed=0, hub=0):
    """Graph500's Kronecker graph (initiator 0.57, 0.19, 0.19, its vertex
    permutation), undirected, self-loops and duplicates dropped, as P = A
    D^-1 in COO (rows, cols, vals, shape); `hub` more edges from vertex 0
    to distinct others give it a row at least that long."""
    rng = np.random.default_rng(seed)
    nv, m = 1 << scale, edgefactor << scale
    ab, c_norm, a_norm = 0.76, 0.19 / 0.24, 0.57 / 0.76
    ii = np.zeros(m, np.int64)
    jj = np.zeros(m, np.int64)
    for ib in range(scale):
        ii_bit = rng.random(m) > ab
        jj_bit = rng.random(m) > np.where(ii_bit, c_norm, a_norm)
        ii += ii_bit.astype(np.int64) << ib
        jj += jj_bit.astype(np.int64) << ib
    perm = rng.permutation(nv)
    ii, jj = perm[ii], perm[jj]
    extra = rng.choice(np.arange(1, nv), min(hub, nv - 1), replace=False)
    ii = np.concatenate([ii, np.zeros(len(extra), np.int64)])
    jj = np.concatenate([jj, extra])
    src, dst = np.concatenate([ii, jj]), np.concatenate([jj, ii])
    keep = src != dst
    key = np.unique(src[keep] * nv + dst[keep])
    rows, cols = key // nv, key % nv
    deg = np.bincount(rows, minlength=nv)
    vals = (1.0 / deg[cols]).astype(np.float32)
    return rows.astype(np.int32), cols.astype(np.int32), vals, (nv, nv)


def _planner_slab(cw, kg, cap=3, seed=0):
    """A slab as the planner lays it out: each lane's real slots first, at
    distinct window units, then padding slots (rel 0, dense 0); whole
    padding lanes; real slots sparse, some empty."""
    rng = np.random.default_rng(seed)
    count = rng.integers(0, kg + 1, (cap, 128))
    count[:, rng.random(128) < 0.1] = 0                   # padding lanes
    real = np.arange(kg)[None, :, None] < count[:, None, :]   # (cap, kg, 128)
    rel = np.sort(np.stack([np.stack([
        rng.choice(sk.WINDOW_UNITS, kg, replace=False) for _ in range(128)],
        axis=1) for _ in range(cap)]), axis=1).astype(np.int32)
    rel[~real] = 0
    dense = rng.standard_normal((cw, cap, kg, 8, 128)).astype(np.float32)
    dense = np.where((rng.random(dense.shape) < 0.2)
                     & real[None, :, :, None, :], dense, np.float32(0))
    ws = rng.integers(0, 100, cap).astype(np.int32)
    return dense, rel, ws


def _expand(pack, rel, kg):
    """The slab (cw, cap, kg, 8, 128) a pack holds, from the pack and the
    group's rel: an entry at window column u * cw + w of row (c, i, l)
    sits in the first slot k of lane l with rel[c, k, l] == u (real slots
    come first and hold distinct units). Padding entries (zero bits) are
    dropped; every slab position is written at most once."""
    cw, cap = pack.cw, pack.cap
    vals = pack.vals
    bits = (vals.view(torch.int16) if vals.element_size() == 2
            else vals.view(torch.int32)).numpy()
    off = pack.slice_off.numpy()
    length = (off[1:] - off[:-1]) // sk.SLICE
    g = np.where(length % 4 == 0, 4, np.where(length % 2 == 0, 2, 1))
    s = np.repeat(np.arange(len(length)), sk.SLICE * length)
    q = np.arange(len(s)) - off[s]
    t = q // g[s] % sk.SLICE
    keep = bits != 0
    s, t = s[keep], t[keep]
    c = s // (sk.CHUNK_ROWS // sk.SLICE)
    lr = pack.rows.numpy().astype(np.int64)[s * sk.SLICE + t]
    i, lane = lr // 128, lr % 128
    col = pack.cols.numpy().astype(np.int64)[keep]
    u, w = col // cw, col % cw
    hit = rel[c, :, lane] == u[:, None]                    # (nnz, kg)
    assert hit.any(axis=1).all()
    k = hit.argmax(axis=1)
    flat = np.ravel_multi_index((w, c, k, i, lane), (cw, cap, kg, 8, 128))
    assert len(np.unique(flat)) == len(flat) == pack.nnz
    out = torch.zeros(cw * cap * kg * 8 * 128, dtype=vals.dtype)
    out[torch.from_numpy(flat)] = vals[torch.from_numpy(keep)]
    return out.reshape(cw, cap, kg, 8, 128)


def _same_bits(a, b):
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a.numpy(), b.numpy())


# ---------------------------------------------------------------------------
# plain versions (the CPU wrappers) against the Pallas kernels
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("offsets", sorted(DIA_OFFSETS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dia_matches_pallas(ref, offsets, dtype):
    offs = DIA_OFFSETS[offsets]
    dia, v = _dia_inputs(offs)
    jnp = ref.jnp
    want = np.asarray(ref.dia_apply(
        jnp.asarray(dia, getattr(jnp, dtype)), offs, jnp.asarray(v),
        v.shape[0], dia_impl="pallas"))
    dia_t = _t(dia, getattr(torch, dtype))
    got = dia_spmv(dia_t, _t(v), offs)
    assert got.shape == (dia.shape[1], 128) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_array_equal(got.numpy(),
                                  dia_spmv_plain(dia_t, _t(v), offs).numpy())


@pytest.mark.parametrize("cw,kg", SELL_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sell_window_matches_pallas(ref, cw, kg, dtype):
    dense, rel, ws, v, n, ncu, ncu_pad = _sell_inputs(cw, kg)
    jnp = ref.jnp
    vflat = np.zeros(ncu * cw, np.float32)
    vflat[:n] = v
    vtab = np.zeros((cw, ncu_pad), np.float32)
    vtab[:, :ncu] = vflat.reshape(ncu, cw).T
    want = np.asarray(ref.sell.sell_window_group(
        jnp.asarray(dense, getattr(jnp, dtype)), jnp.asarray(rel),
        jnp.asarray(ws), jnp.asarray(vtab), kg, cw))
    pack = _pack(dense, rel, ws, getattr(torch, dtype))
    got = sell_window(pack, _t(v), n)
    assert got.shape == (3, 8, 128) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("cw", [8, 64])
@pytest.mark.parametrize("kg", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pack_expands_to_slab(cw, kg, dtype):
    """The pack holds every nonzero of the slab once, and nothing else:
    expanded, it gives the slab back bit for bit."""
    dense, rel, ws = _planner_slab(cw, kg, seed=cw + kg)
    slab = _t(dense, getattr(torch, dtype))
    pack = pack_group(slab, _t(rel), _t(ws))
    assert pack.nnz == int((dense != 0).sum()) > 0
    assert torch.equal(pack.ws, _t(ws)) and pack.cw == cw
    _same_bits(_expand(pack, rel, kg), slab)
    # the SELL-32 layout: one slice per 32 rows, each at most as long as
    # its chunk's longest row, and a row map that permutes each chunk
    length = (pack.slice_off[1:] - pack.slice_off[:-1]) // sk.SLICE
    assert length.numel() == 3 * 32 and int(length.max()) <= kg * cw
    for c in range(3):
        chunk = pack.rows[c * 1024:(c + 1) * 1024].long()
        assert torch.equal(chunk.sort().values, torch.arange(1024))


def test_window_helpers_match_jax(ref):
    for cw in (8, 16, 64):
        for kg in (1, 2, 3, 11, 12, 23, 24, 25, 100):
            for itemsize in (2, 4):
                assert sk.k_slice(cw, kg, itemsize) == ref.sell.k_slice(
                    cw, kg, itemsize)
                assert sk.group_vmem_ok(cw, kg, itemsize) == \
                    ref.sell.group_vmem_ok(cw, kg, itemsize)
    for ncu in (1, 127, 128, 255, 256, 1000, 131072):
        assert sk.ncu_padded(ncu) == ref.sell.ncu_padded(ncu)
    assert sk.WINDOW_UNITS == ref.sell.WINDOW_UNITS
    assert sk.k_slice(64, 24, 4) < 24 and sk.k_slice(64, 24, 2) < 24


def test_wrappers_reject_what_the_kernels_do_not_take():
    dia, v = _dia_inputs((0, 1))
    with pytest.raises(TypeError):
        dia_spmv(_t(dia, torch.float64), _t(v), (0, 1))
    with pytest.raises(ValueError):
        dia_spmv(_t(dia), _t(v), (0,))
    with pytest.raises(ValueError):
        dia_spmv(_t(dia[:, :, :64]), _t(v), (0, 1))
    with pytest.raises(ValueError, match="at most"):
        dia_spmv(torch.zeros(129, 1, 128), _t(v), tuple(range(129)))
    dense, rel, ws, v, n, *_ = _sell_inputs(8, 3)
    pack = _pack(dense, rel, ws)
    with pytest.raises(ValueError):
        sell_window(dataclasses.replace(pack, ws=pack.ws[:2]), _t(v), n)
    with pytest.raises(ValueError):
        sell_window(pack, _t(v), v.shape[0] + 1)
    with pytest.raises(ValueError):
        sell_window(dataclasses.replace(pack, cols=pack.cols.long()),
                    _t(v), n)
    with pytest.raises(TypeError):
        sell_window(pack, _t(v).double(), n)
    with pytest.raises(TypeError):
        sell_window(pack.astype(torch.float64), _t(v), n)
    with pytest.raises(ValueError, match="contiguous"):
        sell_window(pack, torch.stack([_t(v), _t(v)], 1)[:, 0], n)
    with pytest.raises(ValueError, match="16 bits"):
        pack_group(torch.zeros(256, 1, 1, 8, 128), torch.zeros(
            1, 1, 128, dtype=torch.int32), torch.zeros(1, dtype=torch.int32))


def _gather_inputs(dtype=torch.float32, seed=0):
    """A small GatherPack: rows of 0 to 3,000 entries (3 segments and
    more), empty rows, rows left out of the pack, columns past n."""
    rng = np.random.default_rng(seed)
    nrows, n = 40, 5000
    counts = rng.integers(0, 300, nrows)
    counts[[3, 17]] = [3000, 0]
    row = np.repeat(np.arange(nrows), counts)
    col = np.concatenate([rng.choice(n + 40, c, replace=False)
                          for c in counts])
    vals = rng.standard_normal(len(row)).astype(np.float32)
    rows = rng.permutation(2 * nrows)[:nrows]
    pack = gather_pack(row, col, vals, rows, dtype)
    v = torch.from_numpy(rng.standard_normal(n + 40).astype(np.float32))
    return pack, v, n, 2 * nrows


def test_sell_gather_plain_sums_rows():
    """Each pack row is the sum of its entries, written at its stacked
    row; rows outside the pack keep what out held; a segment holds at
    most SEG_LEN entries of one row."""
    pack, v, n, nout = _gather_inputs()
    out = torch.full((nout,), float("nan"))
    got = sell_gather(pack, v, n, out)
    assert got is out
    seg_rows = np.repeat(np.arange(pack.rows.shape[0]),
                         np.diff(pack.row_seg.numpy()))
    row = np.repeat(seg_rows, np.diff(pack.seg_off.numpy()))
    assert np.diff(pack.seg_off.numpy()).max() <= 1024
    assert np.diff(pack.row_seg.numpy())[3] == 3
    col = pack.cols[:pack.nnz].numpy().astype(np.int64)
    key = row * (n + 40) + col
    assert (np.diff(key) > 0).all()
    x = np.where(col < n, v.numpy()[np.minimum(col, n - 1)], 0)
    want = np.zeros(pack.rows.shape[0])
    np.add.at(want, row, pack.vals[:pack.nnz].double().numpy() * x)
    r = pack.rows.long()
    np.testing.assert_allclose(got[r].numpy(), want, **TOL)
    rest = torch.ones(nout, dtype=torch.bool)
    rest[r] = False
    assert out[rest].isnan().all()
    assert pack.vals.numel() % 4 == 0 and pack.vals.numel() - pack.nnz < 4


def _window(v, col_off, n):
    """v's entries [col_off, col_off + n), zero outside v."""
    w = torch.zeros(n, dtype=v.dtype, device=v.device)
    lo, hi = max(col_off, 0), min(col_off + n, v.shape[0])
    if hi > lo:
        w[lo - col_off:hi - col_off] = v[lo:hi]
    return w


@pytest.mark.parametrize("col_off", [0, 1000, -64])
def test_sell_gather_col_off_reads_a_window(col_off):
    """With col_off, v is the window of the whole vector from column
    col_off: entry e reads v[cols[e] - col_off], zero outside [0, n),
    the same sums as the whole vector zeroed outside the window."""
    pack, v, n, nout = _gather_inputs()
    m = 3000
    win = _window(_window(v, 0, n), col_off, m)
    masked = torch.zeros(n + m + 1000)
    masked[:n] = v[:n]
    keep = torch.zeros_like(masked, dtype=torch.bool)
    keep[max(col_off, 0):max(col_off + m, 0)] = True
    masked = torch.where(keep, masked, 0.0)
    got = sell_gather(pack, win, m, torch.full((nout,), float("nan")),
                      col_off)
    want = sell_gather(pack, masked, masked.shape[0],
                       torch.full((nout,), float("nan")))
    torch.testing.assert_close(got, want, equal_nan=True, **TOL)


def test_sell_gather_rejects_what_the_kernel_does_not_take():
    pack, v, n, nout = _gather_inputs()
    out = torch.zeros(nout)
    for bad in (dict(cols=pack.cols.long()),
                dict(rows=pack.rows[:-1]),
                dict(seg_off=pack.seg_off.int()),
                dict(vals=pack.vals[:-1], cols=pack.cols[:-1])):
        with pytest.raises(ValueError):
            sell_gather(dataclasses.replace(pack, **bad), v, n, out)
    with pytest.raises(ValueError):
        sell_gather(pack, v, v.shape[0] + 1, out)
    with pytest.raises(ValueError, match="contiguous"):
        sell_gather(pack, torch.stack([v, v], 1)[:, 0], n, out)
    before = sell_gather.launches
    sell_gather(pack, v, n, out)
    assert sell_gather.launches == before


@pytest.mark.parametrize("shift", [128, 256, -384])
def test_dia_shift_matches_pallas(ref, shift):
    """The shift against the JAX DIA path at col_shift (Pallas, interpret
    mode): the same reads of v."""
    offs = DIA_OFFSETS["far"]
    dia, v = _dia_inputs(offs)
    jnp = ref.jnp
    want = np.asarray(ref.dia_apply(
        jnp.asarray(dia), offs, jnp.asarray(v), v.shape[0],
        dia_impl="pallas", col_shift=jnp.int32(max(shift, 0))))
    if shift < 0:
        # JAX slices v from row col_shift // 128 and cannot start before
        # it; shifting the offsets instead gives the same reads
        want = np.asarray(ref.dia_apply(
            jnp.asarray(dia), tuple(o + shift for o in offs), jnp.asarray(v),
            v.shape[0], dia_impl="pallas"))
    got = dia_spmv(_t(dia), _t(v), offs, shift)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_plain_versions_do_not_count_launches():
    dia, v = _dia_inputs((0, 1))
    before = (dia_spmv.launches, sell_window.launches)
    dia_spmv(_t(dia), _t(v), (0, 1))
    dense, rel, ws, v, n, *_ = _sell_inputs(8, 3)
    sell_window(_pack(dense, rel, ws), _t(v), n)
    assert (dia_spmv.launches, sell_window.launches) == before


# ---------------------------------------------------------------------------
# the CUDA kernels against the plain versions, on the card
# ---------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("offsets", sorted(DIA_OFFSETS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dia_kernel_on_card(cuda, offsets, dtype):
    offs = DIA_OFFSETS[offsets]
    dia, v = _dia_inputs(offs, r_rows=1000, n=127_777)
    dia_t = _t(dia, getattr(torch, dtype)).to(cuda)
    v_t = _t(v).to(cuda)
    before = dia_spmv.launches
    got = dia_spmv(dia_t, v_t, offs)
    torch.cuda.synchronize()
    assert dia_spmv.launches == before + 1
    want = dia_spmv_plain(dia_t, v_t, offs)
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("offsets", sorted(DIA_OFFSETS))
@pytest.mark.parametrize("shift", [384, -256, 131_072])
def test_dia_kernel_shift_on_card(cuda, offsets, shift):
    """A shard's column shift (parallel/spmv.py): a non-zero one, and a
    tall one whose reads all lie past the end of v."""
    offs = DIA_OFFSETS[offsets]
    dia, v = _dia_inputs(offs, r_rows=1000, n=127_777)
    dia_t, v_t = _t(dia).to(cuda), _t(v).to(cuda)
    before = dia_spmv.launches
    got = dia_spmv(dia_t, v_t, offs, shift)
    torch.cuda.synchronize()
    assert dia_spmv.launches == before + 1
    want = dia_spmv_plain(dia_t, v_t, offs, shift)
    torch.testing.assert_close(got, want, **TOL)
    if shift == 131_072:
        assert not want.any()


@pytest.mark.gpu
@pytest.mark.parametrize("cw,kg", SELL_SHAPES + [(16, 5)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sell_window_kernel_on_card(cuda, cw, kg, dtype):
    dense, rel, ws, v, n, *_ = _sell_inputs(cw, kg, cap=40)
    args = (_pack(dense, rel, ws, getattr(torch, dtype)).to(cuda),
            _t(v).to(cuda), n)
    before = sell_window.launches
    got = sell_window(*args)
    torch.cuda.synchronize()
    assert sell_window.launches == before + 1
    torch.testing.assert_close(got, sell_window_plain(*args), **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sell_window_kernel_road_like_on_card(cuda, dtype):
    """The packs of a road network's windowed groups (cw = 64, the main
    path's layout at road1M, cut to 262,144 rows), kernel against twin."""
    import bmsparse_tpu_torch as bt

    r, c, vals, shape = roadnet(262_144, seed=8)
    p = bt.prepare(bt.coo_to_bmsparse(r, c, vals, shape, device="cpu"),
                   dtype=getattr(torch, dtype), stream="off")
    packs = [pk.to(cuda) for pk in p.sell_pack if pk is not None]
    assert packs and all(pk.cw == 64 for pk in packs)
    n = p.block_cols * 8
    v = torch.randn(n, generator=torch.Generator().manual_seed(3)).to(cuda)
    for pk in packs:
        before = sell_window.launches
        got = sell_window(pk, v, n)
        torch.cuda.synchronize()
        assert sell_window.launches == before + 1
        torch.testing.assert_close(got, sell_window_plain(pk, v, n), **TOL)


@pytest.mark.gpu
def test_kernels_reject_mixed_devices_on_card(cuda):
    dia, v = _dia_inputs((0,))
    with pytest.raises(ValueError, match="dia on"):
        dia_spmv(_t(dia).to(cuda), _t(v), (0,))


def _gather_ref(pack, v, n, nout):
    """The pack's rows (nan where out has no pack row) in float64, and
    their scale |vals| |v| row by row: float32 sums in any order lie
    within a few 1e-7 of the scale."""
    p64 = pack.astype(torch.float64)
    nan = torch.full((nout,), float("nan"), dtype=torch.float64,
                     device=v.device)
    ref = sell_gather_plain(p64, v.double(), n, nan.clone())
    scale = sell_gather_plain(dataclasses.replace(p64, vals=p64.vals.abs()),
                              v.double().abs(), n, nan.clone())
    return ref, scale


def _assert_gap(got, ref, scale, gap=1e-5):
    """|got - ref| within gap times the row's scale, nan where ref is."""
    assert torch.equal(got.isnan(), ref.isnan())
    w = ~ref.isnan()
    err = (got[w].double() - ref[w]).abs()
    assert bool((err <= gap * scale[w]).all()), float(
        (err / scale[w].clamp(min=1e-300)).max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sell_gather_kernel_on_card(cuda, dtype):
    pack, v, n, nout = _gather_inputs(getattr(torch, dtype))
    pack, v = pack.to(cuda), v.to(cuda)
    out = torch.full((nout,), float("nan"), device=cuda)
    before = sell_gather.launches
    sell_gather(pack, v, n, out)
    torch.cuda.synchronize()
    assert sell_gather.launches == before + 2
    _assert_gap(out, *_gather_ref(pack, v, n, nout))


@pytest.mark.gpu
def test_sell_gather_kernel_col_off_on_card(cuda):
    """The halo mode's column offset: the kernel against its plain twin
    on a window of v, offsets on either side of 0."""
    pack, v, n, nout = _gather_inputs()
    pack = pack.to(cuda)
    for col_off in (1000, -64):
        win = _window(v, col_off, 3000).to(cuda)
        got = sell_gather(pack, win, 3000, torch.full(
            (nout,), float("nan"), device=cuda), col_off)
        want = sell_gather_plain(pack, win, 3000, torch.full(
            (nout,), float("nan"), device=cuda), col_off)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, equal_nan=True, **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sell_gather_kronecker_on_card(cuda, dtype):
    """A Kronecker scale-16 plan (the PageRank cell's structure: hub rows
    on the SELL tier, the rest on the stream tier in float32): the kernel
    and its plain version against the pack's float64 sums, two calls bit
    for bit, and two launches per tier with a gathered pack per SpMV,
    whose result meets the float64 oracle."""
    import bmsparse_tpu_torch as bt

    r, c, vals, shape = _kronecker(16, seed=5)
    f32 = dtype == "float32"
    m = bt.coo_to_bmsparse(r, c, vals, shape, device="cpu")
    p = bt.prepare(m, dtype=getattr(torch, dtype),
                   stream="force" if f32 else "off").to(cuda)
    assert p.sell_gpack is not None and (p.stream is not None) == f32
    n = p.block_cols * 8
    nout = (p.sell_rows + 1) * 8
    g = torch.Generator().manual_seed(3)
    v = torch.randn(n, generator=g).to(cuda)
    ref = _gather_ref(p.sell_gpack, v, n, nout)
    outs = []
    for fn in (sell_gather, sell_gather, sell_gather_plain):
        out = torch.full((nout,), float("nan"), device=cuda)
        outs.append(fn(p.sell_gpack, v, n, out))
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])
    _assert_gap(outs[0], *ref)
    _assert_gap(outs[2], *ref)
    x = torch.randn(shape[1], generator=g)
    before = sell_gather.launches
    u = bt.spmv(p, x.to(cuda))
    torch.cuda.synchronize()
    tiers = (p.sell_gpack is not None) + (p.ovf_gpack is not None)
    assert sell_gather.launches == before + 2 * tiers
    a = (m.astype(torch.bfloat16) if not f32 else m).to_scipy().tocsr()
    want = a @ x.double().numpy()
    scale = abs(a) @ x.double().abs().numpy()
    assert (np.abs(u.cpu().double().numpy() - want) <= 1e-5 * scale).all()
