"""The port's two kernels against the JAX package's Pallas kernels.

On the CPU each wrapper (dia_spmv, sell_window) runs its plain torch
version, which is held against the Pallas kernel in interpret mode on the
same inputs: offsets beyond one 128-lane row in both directions, window
widths cw 8 and 64, k-groups deeper than the TPU kernel's k-slice, float32
and bfloat16, and the DIA kernel's column shift (the multi-device path's). Tolerance rtol = atol = 1e-5: only the order of the float32
sums differs.

The cases marked `gpu` hold the CUDA kernels against the plain versions on
the card and skip where there is none. They import no JAX, so they also
run on a machine without it:
    python -m pytest tests/test_torch_kernels.py --noconftest -m gpu
"""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from bmsparse_tpu_torch.ops.cuda import sell_kernel as sk
from bmsparse_tpu_torch.ops.cuda.sell_kernel import (
    sell_window, sell_window_plain,
)
from bmsparse_tpu_torch.ops.cuda.spmv_kernel import dia_spmv, dia_spmv_plain

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
    dense *= rng.random(dense.shape) < 0.1
    pad = rng.random((cap, kg, 128)) < 0.2
    rel[pad] = 0
    dense[:, pad.nonzero()[0], pad.nonzero()[1], :, pad.nonzero()[2]] = 0
    v = rng.standard_normal(n).astype(np.float32)
    return dense, rel, ws, v, n, ncu, ncu_pad


def _t(x, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t if dtype is None else t.to(dtype)


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
    dense_t = _t(dense, getattr(torch, dtype))
    got = sell_window(dense_t, _t(rel), _t(ws), _t(v), cw, n)
    assert got.shape == (3, 8, 128) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


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
    args = [_t(dense), _t(rel), _t(ws), _t(v)]
    with pytest.raises(ValueError):
        sell_window(*args, 64, n)
    with pytest.raises(ValueError):
        sell_window(*args, 8, v.shape[0] + 1)
    with pytest.raises(ValueError):
        sell_window(args[0], args[1].to(torch.int64), *args[2:], 8, n)
    with pytest.raises(ValueError, match="contiguous"):
        sell_window(args[0].transpose(3, 4).contiguous().transpose(3, 4),
                    *args[1:], 8, n)


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
    sell_window(_t(dense), _t(rel), _t(ws), _t(v), 8, n)
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
    args = (_t(dense, getattr(torch, dtype)).to(cuda), _t(rel).to(cuda),
            _t(ws).to(cuda), _t(v).to(cuda), cw, n)
    before = sell_window.launches
    got = sell_window(*args)
    torch.cuda.synchronize()
    assert sell_window.launches == before + 1
    torch.testing.assert_close(got, sell_window_plain(*args), **TOL)


@pytest.mark.gpu
def test_kernels_reject_mixed_devices_on_card(cuda):
    dia, v = _dia_inputs((0,))
    with pytest.raises(ValueError, match="dia on"):
        dia_spmv(_t(dia).to(cuda), _t(v), (0,))
