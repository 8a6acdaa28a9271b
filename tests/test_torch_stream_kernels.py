"""The stream tier's two kernels against the JAX package's Pallas kernels.

On the CPU each wrapper (window_product, rowwise_gather) runs its plain
torch version, which is held against the Pallas kernel in interpret mode
on the same inputs, exactly: both compute one product, or one copy, per
output. window_product runs on a real plan's tables (a webgraph's), and
rowwise_gather at the shapes of both routing stages with the sentinel
index W.

The cases marked `gpu` hold the CUDA kernels against the plain versions on
the card and skip where there is none. They import no JAX:
    python -m pytest tests/test_torch_stream_kernels.py --noconftest -m gpu
"""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from bmsparse_tpu_torch.ops import route
from bmsparse_tpu_torch.ops.cuda.shuffle_kernel import (
    rowwise_gather, rowwise_gather_plain, window_product, window_product_plain,
)
from bmsparse_tpu_torch.utils import testmats as tm

TOL = dict(rtol=0, atol=0)      # a product or a copy per output: exact


@pytest.fixture(scope="module")
def ref():
    """The JAX package's kernels, imported here and not at module level so
    that the `gpu` cases run where JAX is not installed."""
    shk = pytest.importorskip("bmsparse_tpu.ops.pallas.shuffle_kernel")
    return SimpleNamespace(jnp=pytest.importorskip("jax.numpy"), shk=shk)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _plan(n=4096, seed=3):
    """A webgraph's stream plan (the tables window_product reads)."""
    r, c, v, _ = tm.webgraph(n, 6, seed=seed)
    keep = np.bincount(r, minlength=n)[r] <= route.K_CAP
    return route.build_stream_plan(r[keep], c[keep], v[keep], n, n)


def _vtab(p, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(p.vtab_len).astype(np.float32)


def _gather_inputs(r, w, g, seed=0):
    """x (r, w) and idx (r, g, 128) with about a fifth of the slots on the
    sentinel w."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((r, w)).astype(np.float32)
    idx = rng.integers(0, w, (r, g, 128)).astype(np.int32)
    idx[rng.random(idx.shape) < 0.2] = w
    return x, idx


# (R, W, G): stage 2 (W = 128, G = S2 or 8) and stage 3 (W = w3, G = nahi)
GATHER_SHAPES = [(256, 128, 4), (64, 128, 8), (64, 384, 1), (32, 512, 2)]


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------------------
# plain versions (the CPU wrappers) against the Pallas kernels
# ---------------------------------------------------------------------------
def test_window_product_matches_pallas(ref):
    p = _plan()
    vtab = _vtab(p)
    jnp = ref.jnp
    want = np.asarray(ref.shk.window_product(
        *(jnp.asarray(getattr(p, f).numpy())
          for f in ("vals_grid", "rel_grid", "ws", "pp", "nxt")),
        jnp.asarray(vtab), w=p.w))
    args = (p.vals_grid, p.rel_grid, p.ws, _t(vtab), p.w)
    got = window_product(*args)
    assert got.shape == p.vals_grid.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_array_equal(got.numpy(),
                                  window_product_plain(*args).numpy())


@pytest.mark.parametrize("r,w,g", GATHER_SHAPES)
def test_rowwise_gather_matches_pallas(ref, r, w, g):
    x, idx = _gather_inputs(r, w, g)
    want = np.asarray(ref.shk.rowwise_gather(
        ref.jnp.asarray(x), ref.jnp.asarray(idx), g))
    got = rowwise_gather(_t(x), _t(idx), g)
    assert got.shape == (r, g, 128) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert not got.numpy()[idx == w].any(), "the sentinel reads 0"


def test_plain_versions_read_zero_outside():
    """Indices outside the window, or windows past the end of vtab, read
    0 (the planner builds neither; the kernels bound-check the same way)."""
    vals = torch.ones(route.TILE_R, 128)
    rel = torch.arange(route.TILE_R * 128, dtype=torch.int32).reshape(
        route.TILE_R, 128) % 1100 - 20
    vtab = torch.arange(2048, dtype=torch.float32)
    ws = torch.tensor([1024], dtype=torch.int32)
    out = window_product_plain(vals, rel, ws, vtab, 1024)
    r = rel.long()
    want = torch.where((r >= 0) & (r < 1024) & (r + 1024 < 2048),
                       (r + 1024).float(), 0.0)
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    x = torch.arange(8 * 128, dtype=torch.float32).reshape(8, 128)
    idx = torch.full((8, 1, 128), -1, dtype=torch.int32)
    assert not rowwise_gather_plain(x, idx, 1).any()


def test_wrappers_reject_what_the_kernels_do_not_take():
    p = _plan(1024, seed=1)
    vtab = _t(_vtab(p))
    args = [p.vals_grid, p.rel_grid, p.ws, vtab]
    with pytest.raises(ValueError):
        window_product(p.vals_grid[:-1], *args[1:], p.w)
    with pytest.raises(ValueError):
        window_product(args[0], args[1].long(), *args[2:], p.w)
    with pytest.raises(ValueError):
        window_product(*args[:2], args[2][:-1], vtab, p.w)
    with pytest.raises(TypeError):
        window_product(args[0].double(), *args[1:], p.w)
    with pytest.raises(ValueError):
        window_product(*args, vtab.shape[0] + 1)
    x, idx = _gather_inputs(32, 128, 2)
    with pytest.raises(ValueError):
        rowwise_gather(_t(x), _t(idx), 3)
    with pytest.raises(TypeError):
        rowwise_gather(_t(x).double(), _t(idx), 2)
    with pytest.raises(ValueError, match="contiguous"):
        rowwise_gather(_t(x).t().contiguous().t(), _t(idx), 2)


def test_plain_versions_do_not_count_launches():
    p = _plan(1024, seed=1)
    before = (window_product.launches, rowwise_gather.launches)
    window_product(p.vals_grid, p.rel_grid, p.ws, _t(_vtab(p)), p.w)
    rowwise_gather(*(_t(a) for a in _gather_inputs(32, 128, 2)), 2)
    route.stream_apply(p, _t(_vtab(p))[:1024])
    assert (window_product.launches, rowwise_gather.launches) == before


# ---------------------------------------------------------------------------
# the CUDA kernels against the plain versions, on the card
# ---------------------------------------------------------------------------
@pytest.mark.gpu
def test_window_product_kernel_on_card(cuda):
    p = _plan(65_536, seed=9).to(cuda)
    args = (p.vals_grid, p.rel_grid, p.ws, _t(_vtab(p)).to(cuda), p.w)
    before = window_product.launches
    got = window_product(*args)
    torch.cuda.synchronize()
    assert window_product.launches == before + 1
    torch.testing.assert_close(got, window_product_plain(*args), **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("r,w,g", GATHER_SHAPES + [(16384, 768, 2),
                                                   (40, 16384, 1),
                                                   (7, 128, 1)])
def test_rowwise_gather_kernel_on_card(cuda, r, w, g):
    x, idx = (_t(a).to(cuda) for a in _gather_inputs(r, w, g))
    before = rowwise_gather.launches
    got = rowwise_gather(x, idx, g)
    torch.cuda.synchronize()
    assert rowwise_gather.launches == before + 1
    torch.testing.assert_close(got, rowwise_gather_plain(x, idx, g), **TOL)


@pytest.mark.gpu
def test_stream_apply_kernels_on_card(cuda):
    p = _plan(65_536, seed=9).to(cuda)
    v = _t(_vtab(p, seed=5)).to(cuda)
    before = (window_product.launches, rowwise_gather.launches)
    got = route.stream_apply(p, v, kernels=True)
    torch.cuda.synchronize()
    assert (window_product.launches, rowwise_gather.launches) == (
        before[0] + 1, before[1] + 2)
    torch.testing.assert_close(got, route.stream_apply(p, v),
                               rtol=1e-5, atol=1e-5)
