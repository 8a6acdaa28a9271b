"""The port's two kernels against the JAX package's Pallas kernels.

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
