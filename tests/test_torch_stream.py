"""The stream tier of the PyTorch port (ops/route.py, prepare(stream=...),
the tier in spmv) on the CPU, against the JAX package.

The cost model's constants are the H100's in the port and the TPU's in
the JAX package; they choose the depth cap k, the stage-2 slack and the
routing. The `jax_constants` fixture sets the port's to the JAX package's
values, and under them the port must build the JAX plans array for
array, statics included. Values: the port's spmv on its plain versions
against the JAX spmv(impl="pallas") (Pallas kernels in interpret mode)
and scipy in float64 at rtol = atol = 1e-4 (the JAX suite's own stream
tolerance)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

import bmsparse_tpu as bj
from bmsparse_tpu.ops import route as route_j
from bmsparse_tpu.ops.plan import prepare as prepare_j

import bmsparse_tpu_torch as bt
from bmsparse_tpu_torch.interop import prepared_from_numpy
from bmsparse_tpu_torch.ops import plan as plan_t
from bmsparse_tpu_torch.ops import route as route_t
from bmsparse_tpu_torch.ops.plan import cast_prepared as cast_t
from bmsparse_tpu_torch.ops.plan import prepare as prepare_t
from bmsparse_tpu_torch.utils import testmats as tm

from test_stream_tier import _web_coo
from test_torch_plan import assert_same_plan, jax_plan_arrays

STREAM_TOL = dict(rtol=1e-4, atol=1e-4)

# The JAX package's cost-model constants (its TPU measurements):
# bmsparse_tpu/ops/route.py:95-97 (BW, STEP, QSEL), :109 (the
# window_product tile step, written inline there), :152 and
# bmsparse_tpu/ops/plan.py:610 (RES_NS), plan.py:578-579 (G_NS; its BW is
# route.py's value).
JAX_ROUTE_CONSTANTS = dict(BW=819e9, TILE_STEP=0.4e-6, STEP=0.5e-6,
                           QSEL=10e-9, RES_NS=11.5e-9)
JAX_G_NS = 2.5e-9


@pytest.fixture
def jax_constants(monkeypatch):
    for name, value in JAX_ROUTE_CONSTANTS.items():
        monkeypatch.setattr(route_t, name, value)
    monkeypatch.setattr(plan_t, "G_NS", JAX_G_NS)


def _under_cap(rows, cols, vals, n):
    keep = np.bincount(rows, minlength=n)[rows] <= route_j.K_CAP
    return rows[keep], cols[keep], vals[keep]


def _tiny():
    return (np.array([0, 5], np.int32), np.array([3, 100], np.int32),
            np.array([2.0, -1.0], np.float32), 256)


def _empty():
    e = np.empty(0, np.int32)
    return e, e, np.empty(0, np.float32), 256


# the cases of tests/test_stream_tier.py
PLAN_CASES = {
    "web4096": lambda: (*_under_cap(*_web_coo(4096, 6, 0), 4096), 4096),
    "web16384": lambda: (*_under_cap(*_web_coo(16384, 8, 1), 16384), 16384),
    "tiny": _tiny,
    "empty": _empty,
}


def assert_same_stream(sj, st):
    assert (sj is None) == (st is None)
    if sj is None:
        return
    for f in route_t.StreamPlan.STATICS:
        assert getattr(sj, f) == getattr(st, f), f
    for f in route_t.StreamPlan.TENSORS:
        x, y = np.asarray(getattr(sj, f)), getattr(st, f).cpu().numpy()
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)


def stream_arrays(s) -> dict:
    """A JAX StreamPlan's fields on the host."""
    return {f: (np.asarray(getattr(s, f)) if f in route_t.StreamPlan.TENSORS
                else int(getattr(s, f)))
            for f in route_t.StreamPlan.TENSORS + route_t.StreamPlan.STATICS}


@pytest.mark.parametrize("name", sorted(PLAN_CASES))
@pytest.mark.parametrize("s2", [route_j.S2, 8])
def test_build_stream_plan_matches_jax(jax_constants, name, s2):
    rows, cols, vals, n = PLAN_CASES[name]()
    pj = route_j.build_stream_plan(rows, cols, vals, n, n, s2=s2)
    pt = route_t.build_stream_plan(rows, cols, vals, n, n, s2=s2)
    assert_same_stream(pj, pt)
    assert pt.idx2.shape[1] == s2
    if name == "web16384":
        # the network places nearly every slot; the residue is the tail
        assert pt.res_rows.shape[0] < 0.02 * len(rows)


def test_constants_and_tile_agree():
    """The network's shape constants are the JAX package's; the tile is
    defined once and the kernel wrapper takes it from route."""
    from bmsparse_tpu_torch.ops.cuda import shuffle_kernel as shk

    for name in ("W_STREAM", "S2", "S3", "TILE_R", "EXTRA_ROWS", "K_CAP"):
        assert getattr(route_t, name) == getattr(route_j, name), name
    assert shk.TILE_R is route_t.TILE_R


def test_stream_cost_estimate_matches_jax(jax_constants):
    for nnz in (0, 1, 5000, 522_577, 2_094_508, 4_014_142):
        for k in (1, 13, 24, 64):
            for n_rows in (256, 65_536, 262_144, 1_048_576):
                for s2, s3 in ((4, 1), (8, 1), (4, 2)):
                    assert route_t.stream_cost_estimate(
                        nnz, k, n_rows, s2, s3) == pytest.approx(
                        route_j.stream_cost_estimate(nnz, k, n_rows, s2, s3),
                        rel=1e-12)


def _hub_webgraph():
    """tests/test_stream_tier.py's webgraph with two hub rows heavier than
    K_CAP (they stay on the SELL tier)."""
    n = 16384
    rows, cols, _ = _web_coo(n, 8, seed=5)
    hub = np.concatenate([np.full(200, 7, np.int32),
                          np.full(150, 4000, np.int32)])
    hubc = np.arange(350, dtype=np.int32) * 45 % n
    rows = np.concatenate([rows, hub])
    cols = np.concatenate([cols, hubc])
    key = np.unique(rows.astype(np.int64) * n + cols)
    rows, cols = np.divmod(key, n)
    vals = np.random.default_rng(0).standard_normal(len(rows)).astype(
        np.float32)
    return rows.astype(np.int32), cols.astype(np.int32), vals, (n, n)


def _banded8192():
    """tests/test_stream_tier.py's banded case."""
    n = 8192
    rng = np.random.default_rng(1)
    rows = np.repeat(np.arange(n, dtype=np.int64), 4)
    cols = np.clip(rows + rng.integers(-20, 21, rows.shape[0]), 0, n - 1)
    key = np.unique(rows * n + cols)
    rows, cols = np.divmod(key, n)
    vals = rng.standard_normal(len(rows)).astype(np.float32)
    return rows.astype(np.int32), cols.astype(np.int32), vals, (n, n)


MATRICES = {
    "hub_webgraph": _hub_webgraph,
    "banded8192": _banded8192,
    "web65536": lambda: tm.webgraph(65_536, 8, seed=9),
    "road65536": lambda: tm.roadnet(65_536, seed=8),
}


def _both(name):
    r, c, v, shape = MATRICES[name]()
    return (bj.coo_to_bmsparse(r, c, v, shape, backend="host"),
            bt.coo_to_bmsparse(r, c, v, shape, device="cpu"))


def test_prepare_force_matches_jax(jax_constants):
    mj, mt = _both("hub_webgraph")
    pj = prepare_j(mj, stream="force")
    pt = prepare_t(mt, stream="force")
    assert pt.stream is not None and pt.sell_ks, "hubs stay on SELL"
    assert_same_plan(pj, pt)
    assert_same_stream(pj.stream, pt.stream)


@pytest.mark.parametrize("name,routed", [("banded8192", False),
                                         ("road65536", False),
                                         ("web65536", True)])
def test_prepare_auto_routing_matches_jax(jax_constants, name, routed):
    """prepare() with its default stream="auto": banded and road-like
    structures stay on the block tiers, the webgraph goes to the stream
    tier, in both packages, with the same plans."""
    mj, mt = _both(name)
    pj = prepare_j(mj)
    pt = prepare_t(mt)
    assert (pt.stream is not None) == routed
    assert_same_plan(pj, pt)
    assert_same_stream(pj.stream, pt.stream)
    assert_same_stream(pj.stream, plan_t.prepare_cached(mt).stream)


def test_stream_spmv_matches_jax_and_scipy(jax_constants):
    mj, mt = _both("hub_webgraph")
    pj = prepare_j(mj, stream="force")
    pt = prepare_t(mt, stream="force")
    v = np.random.default_rng(2).standard_normal(mt.num_cols).astype(
        np.float32)
    want = np.asarray(bj.spmv(pj, jnp.asarray(v), impl="pallas"))
    ref = mt.to_scipy() @ v.astype(np.float64)
    np.testing.assert_allclose(want, ref, **STREAM_TOL)
    arrays = jax_plan_arrays(pj)
    arrays["stream"] = stream_arrays(pj.stream)
    for p in (pt, prepared_from_numpy(mt, arrays)):
        assert p.stream is not None
        for impl in ("auto", "plain"):
            u = bt.spmv(p, torch.from_numpy(v), impl=impl)
            assert u.dtype == torch.float32 and u.shape == (mt.num_rows,)
            np.testing.assert_allclose(u.numpy(), want, **STREAM_TOL)
            np.testing.assert_allclose(u.numpy(), ref, **STREAM_TOL)


@pytest.mark.parametrize("name", ["web16384", "tiny", "empty"])
def test_stream_apply_matches_jax(jax_constants, name):
    rows, cols, vals, n = PLAN_CASES[name]()
    pt = route_t.build_stream_plan(rows, cols, vals, n, n)
    v = np.arange(n, dtype=np.float32) / n - 0.5
    u = route_t.stream_apply(pt, torch.from_numpy(v)).numpy()
    ref = np.zeros(n)
    np.add.at(ref, rows, vals.astype(np.float64) * v[cols])
    np.testing.assert_allclose(u, ref, **STREAM_TOL)
    pj = route_j.build_stream_plan(rows, cols, vals, n, n)
    np.testing.assert_allclose(
        u, np.asarray(route_j.stream_apply(pj, jnp.asarray(v))),
        rtol=1e-5, atol=1e-5)


def test_heavy_rows_are_rejected():
    k = route_t.K_CAP + 1
    with pytest.raises(ValueError, match="K_CAP"):
        route_t.build_stream_plan(
            np.zeros(k, np.int32), np.arange(k, dtype=np.int32) * 7,
            np.ones(k, np.float32), 128, 1024)


def test_stream_plan_moves_and_casts(jax_constants):
    _, mt = _both("hub_webgraph")
    p = prepare_t(mt, stream="force")
    assert_same_stream(p.stream, p.to("cpu").stream)
    # the stream tier keeps float32 when the block tiers are cast
    pb = cast_t(p, torch.bfloat16)
    assert pb.sell_gpack.vals.dtype == torch.bfloat16
    assert pb.stream is p.stream
    # plans in other types have no stream tier, as in the JAX package
    assert prepare_t(mt, dtype=torch.bfloat16, stream="force").stream is None
    assert prepare_t(mt, sell_unit=8, stream="force").stream is None
