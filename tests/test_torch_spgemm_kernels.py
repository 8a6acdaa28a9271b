"""The port's two SpGEMM kernels against the JAX package's Pallas kernels.

On the CPU each wrapper (numeric_sell, numeric_window) runs its plain
torch version, which is held against the Pallas kernel in interpret mode
on the same inputs: K-groups of depth 1, 2, 3 and 9, sentinel slots,
windows that run past the end of the operand table, tiles with fewer than
8 real chunks, float32 and bfloat16. Tolerance rtol = atol = 1e-5: the
products of bfloat16 values are exact in float32, so only the order of
the float32 sums differs.

Each kernel also runs a work table over several K-groups in one launch
(numeric_sell_groups, numeric_window_groups), built by the planner's
ops.spgemm._product_launches. On the CPU an interpreter of the work table,
reading slots the way csrc/spgemm_tiles.cuh does, must give the plain twin
(the per-group plain versions at their row offsets).

The cases marked `gpu` hold the CUDA kernels against the plain versions on
the card, at the slot-table shapes of the bench's SpGEMM cases and on
multi-group tables, and skip where there is none. They import no JAX:
    python -m pytest tests/test_torch_spgemm_kernels.py --noconftest -m gpu
"""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from bmsparse_tpu_torch.config import bucket_size
from bmsparse_tpu_torch.ops.cuda import spgemm_window_kernel as wk
from bmsparse_tpu_torch.ops.cuda.spgemm_kernel import (
    numeric_sell, numeric_sell_groups, numeric_sell_groups_plain,
    numeric_sell_plain, products_plain,
)
from bmsparse_tpu_torch.ops.cuda.spgemm_window_kernel import (
    _SENT_REL, TILE_CHUNKS, numeric_window, numeric_window_groups,
    numeric_window_groups_plain, numeric_window_plain,
)
from bmsparse_tpu_torch.ops.spgemm import _product_launches

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def ref():
    """The JAX package's kernels, imported here and not at module level so
    that the `gpu` cases run where JAX is not installed."""
    sell_j = pytest.importorskip("bmsparse_tpu.ops.pallas.spgemm_kernel")
    win_j = pytest.importorskip(
        "bmsparse_tpu.ops.pallas.spgemm_window_kernel")
    return SimpleNamespace(jnp=pytest.importorskip("jax.numpy"),
                           sell=sell_j, win=win_j)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _tables(nb_a, nb_b, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((nb_a, 64)).astype(np.float32),
            rng.standard_normal((nb_b, 64)).astype(np.float32))


def _sell_inputs(nb, ch, k, seed=0):
    """Slot tables with about a fifth of the slots on the sentinel nb."""
    a, b = _tables(nb, nb + 5, seed)
    rng = np.random.default_rng(seed + 1)
    ta = rng.integers(0, nb, (ch, k, 128)).astype(np.int32)
    tb = rng.integers(0, nb + 5, (ch, k, 128)).astype(np.int32)
    ta[rng.random(ta.shape) < 0.2] = nb
    tb[rng.random(tb.shape) < 0.2] = nb + 5
    return a, b, ta, tb


def _window_inputs(nb, ntiles, k, w, seed=0):
    """Window-relative tables: 128-aligned starts, the last window running
    past nb, sentinel slots on both sides."""
    a, b = _tables(nb, nb, seed)
    rng = np.random.default_rng(seed + 1)
    nb_pad = max(-(-(nb + 1) // 128) * 128, wk.W_MAX)
    starts = rng.integers(0, (nb_pad - w) // 128 + 1, (2, ntiles)) * 128
    starts[:, -1] = nb_pad - w
    ra, rb = (rng.integers(0, w, (ntiles, k, TILE_CHUNKS, 128))
              .astype(np.int32) for _ in range(2))
    ra[rng.random(ra.shape) < 0.2] = _SENT_REL
    rb[rng.random(rb.shape) < 0.2] = _SENT_REL
    return (a, b, ra, rb, starts[0].astype(np.int32),
            starts[1].astype(np.int32), nb_pad)


def _t(x, dtype=None, device=None):
    t = torch.from_numpy(np.ascontiguousarray(x))
    t = t if dtype is None else t.to(dtype)
    return t if device is None else t.to(device)


def _transposed(ref, x, dtype):
    """(nb, 64) tiles -> the TPU's (64, nb + 1) table, zero column last."""
    jnp = ref.jnp
    return jnp.concatenate([jnp.asarray(x, getattr(jnp, dtype)).T,
                            jnp.zeros((64, 1), getattr(jnp, dtype))], axis=1)


def _rounded(x, dtype):
    return _t(x, getattr(torch, dtype))


def multi_group(specs, nb, seed=0, device=None, dtype=torch.float32):
    """Operand tables and one launch over several K-groups, built by the
    planner's _product_launches. specs: per group (kg, ch) for a sell
    group, (kg, ch, t, w) for a window group (all of one kind); a group
    named "empty" reads only sentinels. Chunk keys are random, so the
    table interleaves the groups. The tables are scaled by 1/4 so that C
    stays near 1 at depth 40, where only the order of the float32 sums
    differs between kernel and twin. Returns (a, b, launch, rows,
    window)."""
    rng = np.random.default_rng(seed)
    a, b = (x / 4 for x in _tables(nb, nb, seed))
    nb_pad = max(-(-(nb + 1) // 128) * 128, wk.W_MAX)
    window = len(specs[0]) > 2 and specs[0][2] != "empty"
    groups, pwin, pws, tas, tbs = [], [], [], [], []
    c0 = 0
    for spec in specs:
        kg, ch = spec[:2]
        cap = bucket_size(ch, minimum=1)
        if window:
            t, w = spec[2:4]
            ntiles = -(-cap // t)
            shape = (ntiles, kg, TILE_CHUNKS, 128)
            ws = rng.integers(0, (nb_pad - w) // 128 + 1, (2, ntiles)) * 128
            ws[:, -1] = nb_pad - w       # a window past the table's end
            pwin.append((w, w, t, cap))
            pws.append(tuple(ws.astype(np.int32)))
            hi, sent = w, _SENT_REL
        else:
            shape = (cap, kg, 128)
            pwin.append(None)
            pws.append(None)
            hi, sent = nb, nb
        ta, tb = (rng.integers(0, hi, shape).astype(np.int32)
                  for _ in range(2))
        for x in (ta, tb):
            x[rng.random(shape) < 0.2] = sent
            if spec[-1] == "empty":
                x[...] = sent
        groups.append((kg, c0, c0 + ch))
        tas.append(_t(ta, device=device))
        tbs.append(_t(tb, device=device))
        c0 += ch
    amin = rng.integers(0, 4, c0)
    dev_ws = [None if w is None else tuple(_t(x, device=device) for x in w)
              for w in pws]
    launches, rows, _, _ = _product_launches(groups, pwin, dev_ws, pws, tas,
                                             tbs, amin)
    return (_t(a, dtype, device), _t(b, dtype, device),
            launches[0] if window else launches[1], rows, window)


MULTI = {
    # blockdense64k's shape: a shallow group, then K = 1 with padding chunks
    "sell_k1_padded": [(2, 3), (1, 100)],
    # deeper than one 16-deep slot slice, and an all-sentinel group
    "sell_deep": [(40, 5), (3, 7), (2, 4, "empty")],
    # band2M's shape: K = 3 / 2 / 1 windows, t_real < 8, caps that leave
    # padding slots in the last tile, windows past the table's end
    "window_band": [(3, 20, 8, 4096), (2, 33, 4, 2048), (1, 10, 1, 256)],
    "window_deep": [(24, 3, 2, 512), (1, 6, 8, 256)],
}


def run_table(a, b, launch, rows, window):
    """The work table read the way csrc/spgemm_tiles.cuh reads it: for
    each row, task k of lane l is slot row + k * stride, window-relative
    entries offset by the row's window start; rows no work row writes
    stay NaN."""
    out = torch.full((rows, 64), float("nan"), dtype=torch.float32)
    stride = TILE_CHUNKS if window else 1
    for kg, slot, wsa, wsb, oc in launch.work.tolist():
        at = slot + torch.arange(kg) * stride

        def absolute(slots, ws):
            r = slots[at].long().T                     # (128, kg)
            if window:
                r = torch.where(r == _SENT_REL, -1, ws + r)
            return r

        out[oc * 128:(oc + 1) * 128] = products_plain(
            a, b, absolute(launch.slots_a, wsa), absolute(launch.slots_b, wsb))
    return out


# ---------------------------------------------------------------------------
# plain versions (the CPU wrappers) against the Pallas kernels
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("k", [1, 2, 3, 9])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_numeric_sell_matches_pallas(ref, k, dtype):
    a, b, ta, tb = _sell_inputs(nb=300, ch=3, k=k, seed=k)
    jnp = ref.jnp
    want = np.asarray(ref.sell.numeric_sell_pallas(
        _transposed(ref, a, dtype), _transposed(ref, b, dtype),
        jnp.asarray(ta), jnp.asarray(tb)))
    got = numeric_sell(_rounded(a, dtype), _rounded(b, dtype), _t(ta), _t(tb))
    assert got.shape == (3 * 128, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("t_real", [8, 4, 1])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_numeric_window_matches_pallas(ref, t_real, k, dtype):
    w = 256
    a, b, ra, rb, wsa, wsb, nb_pad = _window_inputs(
        nb=300, ntiles=2, k=k, w=w, seed=t_real + k)
    jnp = ref.jnp
    want = np.asarray(ref.win.numeric_window_pallas(
        ref.win.pad_table(_transposed(ref, a, dtype), nb_pad),
        ref.win.pad_table(_transposed(ref, b, dtype), nb_pad),
        jnp.asarray(ra), jnp.asarray(rb), jnp.asarray(wsa),
        jnp.asarray(wsb), k, w, w, t_real=t_real))
    got = numeric_window(_rounded(a, dtype), _rounded(b, dtype), _t(ra),
                         _t(rb), _t(wsa), _t(wsb), k, t_real)
    assert got.shape == (2 * t_real * 128, 64)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_window_constants_match_jax(ref):
    for name in ("TILE_CHUNKS", "W_MAX", "_VMEM_WINDOW_BUDGET", "_SENT_REL"):
        assert getattr(wk, name) == getattr(ref.win, name), name
    for wa, wb, isz in ((256, 256, 4), (4096, 2048, 2), (4096, 4096, 4)):
        assert wk.window_vmem_bytes(wa, wb, isz) == \
            ref.win.window_vmem_bytes(wa, wb, isz)


def test_wrappers_reject_what_the_kernels_do_not_take():
    a, b, ta, tb = _sell_inputs(nb=40, ch=1, k=2)
    args = [_t(a), _t(b), _t(ta), _t(tb)]
    with pytest.raises(TypeError):
        numeric_sell(_t(a, torch.float64), _t(b, torch.float64), *args[2:])
    with pytest.raises(TypeError):
        numeric_sell(args[0], _t(b, torch.bfloat16), *args[2:])
    with pytest.raises(ValueError):
        numeric_sell(args[0][:, :32], *args[1:])
    with pytest.raises(ValueError):
        numeric_sell(*args[:2], args[2].long(), args[3])
    with pytest.raises(ValueError):
        numeric_sell(*args[:3], args[3][:, :1])
    with pytest.raises(ValueError, match="contiguous"):
        numeric_sell(*args[:2], torch.cat([args[2]] * 2, dim=2)[:, :, :128],
                     args[3])
    a, b, ra, rb, wsa, wsb, _ = _window_inputs(nb=40, ntiles=2, k=2, w=256)
    wargs = [_t(a), _t(b), _t(ra), _t(rb), _t(wsa), _t(wsb)]
    with pytest.raises(ValueError):
        numeric_window(*wargs, 3, 8)             # kg does not match ra
    with pytest.raises(ValueError):
        numeric_window(*wargs, 2, 9)             # t_real past the tile
    with pytest.raises(ValueError):
        numeric_window(*wargs[:4], wargs[4][:1], wargs[5], 2, 8)


def test_plain_versions_do_not_count_launches():
    before = (numeric_sell.launches, numeric_window.launches)
    a, b, ta, tb = _sell_inputs(nb=40, ch=1, k=2)
    numeric_sell(_t(a), _t(b), _t(ta), _t(tb))
    a, b, ra, rb, wsa, wsb, _ = _window_inputs(nb=40, ntiles=1, k=2, w=256)
    numeric_window(_t(a), _t(b), _t(ra), _t(rb), _t(wsa), _t(wsb), 2, 4)
    assert (numeric_sell.launches, numeric_window.launches) == before


def test_window_plain_is_sell_plain_on_absolute_slots():
    """numeric_window is numeric_sell on the slots the windows stand for;
    the plain versions must agree on that, sentinels and all."""
    a, b, ra, rb, wsa, wsb, _ = _window_inputs(nb=500, ntiles=3, k=3,
                                               w=512, seed=5)
    t_real = 4

    def absolute(r, ws):                 # -> (ntiles * t_real, K, 128)
        r = r[:, :, :t_real].astype(np.int64)
        x = np.where(r == _SENT_REL, 500, ws[:, None, None, None] + r)
        return np.minimum(x, 500).transpose(0, 2, 1, 3).reshape(
            -1, 3, 128).astype(np.int32)

    want = numeric_sell_plain(_t(a), _t(b), _t(absolute(ra, wsa)),
                              _t(absolute(rb, wsb)))
    got = numeric_window_plain(_t(a), _t(b), _t(ra), _t(rb), _t(wsa),
                               _t(wsb), 3, t_real)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("name", sorted(MULTI))
def test_work_table_reads_as_the_plain_twin(name):
    """The kernel's reading of a multi-group work table gives the plain
    twin exactly where the twin writes, and every row of c_rows."""
    a, b, launch, rows, window = multi_group(MULTI[name], nb=600, seed=3)
    twin = (numeric_window_groups_plain if window
            else numeric_sell_groups_plain)
    want = twin(a, b, launch, torch.full((rows, 64), float("nan")))
    got = run_table(a, b, launch, rows, window)
    assert not torch.isnan(want).any() and not torch.isnan(got).any()
    torch.testing.assert_close(got, want, **TOL)
    # the CPU wrapper is the twin, and counts no launch
    before = (numeric_sell.launches, numeric_window.launches)
    wrap = numeric_window_groups if window else numeric_sell_groups
    torch.testing.assert_close(wrap(a, b, launch, torch.empty(rows, 64)),
                               want, rtol=0, atol=0)
    assert (numeric_sell.launches, numeric_window.launches) == before
    # chunk rows in the table: each group's chunks once, padding included
    # for sell groups, the cap chunk slots for window groups
    oc = sorted(launch.work[:, 4].tolist())
    assert oc == list(range(rows // 128))


def test_group_launches_reject_what_the_kernels_do_not_take():
    a, b, launch, rows, _ = multi_group(MULTI["sell_k1_padded"], nb=200)
    with pytest.raises(ValueError, match="rows"):
        numeric_sell_groups(a, b, launch, torch.empty(rows - 128, 64))
    with pytest.raises(ValueError):
        numeric_sell_groups(a, b, launch, torch.empty(rows, 32))
    with pytest.raises(ValueError):
        numeric_sell_groups(a, b, launch._replace(work=launch.work[:, :4]),
                            torch.empty(rows, 64))
    with pytest.raises(ValueError):
        numeric_sell_groups(a, b, launch._replace(
            slots_b=launch.slots_b.long()), torch.empty(rows, 64))
    with pytest.raises(TypeError):
        numeric_sell_groups(a.double(), b.double(), launch,
                            torch.empty(rows, 64))


# ---------------------------------------------------------------------------
# the CUDA kernels against the plain versions, on the card
# ---------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 2, 3, 12])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_numeric_sell_kernel_on_card(cuda, k, dtype):
    # blockdense64k's operand tables (40,960 blocks), 64 chunks
    a, b, ta, tb = _sell_inputs(nb=40960, ch=64, k=k, seed=k)
    dt = getattr(torch, dtype)
    args = (_t(a, dt, cuda), _t(b, dt, cuda), _t(ta, device=cuda),
            _t(tb, device=cuda))
    before = numeric_sell.launches
    got = numeric_sell(*args)
    torch.cuda.synchronize()
    assert numeric_sell.launches == before + 1
    torch.testing.assert_close(got, numeric_sell_plain(*args), **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("t_real,w", [(8, 4096), (4, 2048), (1, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_numeric_window_kernel_on_card(cuda, t_real, w, dtype):
    # band2M's operand tables (about 330k blocks), 3-deep tasks
    a, b, ra, rb, wsa, wsb, _ = _window_inputs(
        nb=330_000, ntiles=40, k=3, w=w, seed=t_real)
    dt = getattr(torch, dtype)
    args = (_t(a, dt, cuda), _t(b, dt, cuda), _t(ra, device=cuda),
            _t(rb, device=cuda), _t(wsa, device=cuda), _t(wsb, device=cuda))
    before = numeric_window.launches
    got = numeric_window(*args, 3, t_real)
    torch.cuda.synchronize()
    assert numeric_window.launches == before + 1
    torch.testing.assert_close(
        got, numeric_window_plain(*args, 3, t_real), **TOL)


@pytest.mark.gpu
def test_spgemm_kernels_reject_mixed_devices_on_card(cuda):
    a, b, ta, tb = _sell_inputs(nb=40, ch=1, k=2)
    with pytest.raises(ValueError, match="on"):
        numeric_sell(_t(a, device=cuda), _t(b, device=cuda), _t(ta), _t(tb))


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(MULTI))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_kernels_on_card(cuda, name, dtype):
    """One launch over a multi-group table against the plain twin; the
    launch counter rises by one per product call."""
    a, b, launch, rows, window = multi_group(
        MULTI[name], nb=330_000, seed=11, device=cuda,
        dtype=getattr(torch, dtype))
    fn, counted = ((numeric_window_groups, numeric_window) if window
                   else (numeric_sell_groups, numeric_sell))
    twin = (numeric_window_groups_plain if window
            else numeric_sell_groups_plain)
    before = counted.launches
    got = fn(a, b, launch, torch.full((rows, 64), float("nan"), device=cuda))
    torch.cuda.synchronize()
    assert counted.launches == before + 1
    want = twin(a, b, launch, torch.empty((rows, 64), device=cuda))
    torch.testing.assert_close(got, want, **TOL)
    # an empty table launches nothing
    empty = launch._replace(work=launch.work[:0], parts=())
    fn(a, b, empty, torch.empty((0, 64), device=cuda))
    assert counted.launches == before + 1
