"""Parity of the PyTorch port's execution plan with the JAX package's:
prepare(m, stream="off") must build the plan that the JAX package's
plan carries across to (interop.prepared_from_numpy, which cuts the
packs from the JAX slabs), bit for bit, in float32 and bfloat16, on
structures that exercise every block tier (the stream tier's plans:
tests/test_torch_stream.py)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

import bmsparse_tpu as bj
from bmsparse_tpu.ops.plan import cast_prepared as cast_j
from bmsparse_tpu.ops.plan import prepare as prepare_j
from bmsparse_tpu.utils import testmats as tm_j

import bmsparse_tpu_torch as bt
from bmsparse_tpu_torch.interop import prepared_from_numpy
from bmsparse_tpu_torch.ops.plan import Prepared
from bmsparse_tpu_torch.ops.plan import cast_prepared as cast_t
from bmsparse_tpu_torch.ops.plan import prepare as prepare_t
from bmsparse_tpu_torch.utils import testmats as tm_t
from bmsparse_tpu_torch.utils.testmats import make_stencil

from conftest import random_coo
from test_pallas_sell import _clustered_coo, _road_like_coo

PLAN_TENSORS = ("dia", "out_gather", "ovf_gather")
# the JAX plan's per-group arrays: its slabs, which the port keeps as packs
PLAN_GROUPS = ("sell_dense", "sell_bcol", "sell_ws", "sell_rel",
               "ovf_dense", "ovf_bcol")
PLAN_STATICS = ("plan_dtype", "dia_offsets", "sell_ks", "sell_rows",
                "ovf_ks", "ovf_rows")
# the port plan's own: chunk counts per group and the packs
PORT_STATICS = PLAN_STATICS + ("sell_chunks", "ovf_chunks")
PORT_PACKS = ("sell_gpack", "ovf_gpack")


def jax_plan_arrays(p) -> dict:
    """A JAX Prepared's arrays on the host, keyed by field name."""
    def host(x):
        return None if x is None else np.asarray(x)

    out = {f: getattr(p, f) for f in PLAN_STATICS}
    out.update({f: host(getattr(p, f)) for f in PLAN_TENSORS})
    out.update({f: tuple(host(x) for x in getattr(p, f))
                for f in PLAN_GROUPS})
    return out


def _bits(x):
    """Array as comparable numpy bits (bfloat16 through its int16 view)."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        x = x.cpu()
        return (x.view(torch.int16) if x.dtype == torch.bfloat16
                else x).numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


def _pack_pairs(name, x, y):
    """(field, a, b) of two packs (SellPack or GatherPack) or Nones."""
    assert (x is None) == (y is None), name
    if x is None:
        return []
    for f in x.STATICS:
        assert getattr(x, f) == getattr(y, f), f"{name}.{f}"
    return [(f"{name}.{f}", getattr(x, f), getattr(y, f))
            for f in x.TENSORS]


def assert_same_plan(pj, pt):
    """pt's plan arrays and packs equal pj's, bit for bit. pj: a JAX
    plan, carried across onto pt's matrix first, or another port plan."""
    if not isinstance(pj, Prepared):
        pj = prepared_from_numpy(pt.m, jax_plan_arrays(pj), device="cpu")
    for f in PORT_STATICS:
        assert getattr(pj, f) == getattr(pt, f), f
    pairs = [(f, getattr(pj, f), getattr(pt, f)) for f in PLAN_TENSORS]
    assert len(pj.sell_pack) == len(pt.sell_pack)
    for g, (x, y) in enumerate(zip(pj.sell_pack, pt.sell_pack)):
        pairs += _pack_pairs(f"sell_pack[{g}]", x, y)
    for f in PORT_PACKS:
        pairs += _pack_pairs(f, getattr(pj, f), getattr(pt, f))
    for name, x, y in pairs:
        x, y = _bits(x), _bits(y)
        if x is None or y is None:
            assert x is None and y is None, name
            continue
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)


def _banded(n, band, seed):
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n, dtype=np.int64), band)
    offs = rng.integers(-band // 2, band // 2 + 1, size=rows.shape[0])
    cols = np.clip(rows + offs, 0, n - 1)
    key = np.unique(rows * n + cols)
    rows, cols = np.divmod(key, n)
    vals = rng.standard_normal(rows.shape[0]).astype(np.float32)
    return rows.astype(np.int32), cols.astype(np.int32), vals, (n, n)


def _square(gen, n):
    return (*gen, (n, n))


def _depth_one(n=32768, per_row=3, seed=4):
    """Each row's entries in its own 64-column window, off the dense
    diagonals: one 64-column super-slot per block row, so these rows form
    depth-1 groups with a window plan in float32, which bfloat16 plans
    refuse to depth-1 groups. Every 300th row has one more entry 4,096
    columns on: these rows share chunks spread over the whole matrix, a
    group without a window."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n, dtype=np.int64), per_row)
    cols = rows // 64 * 64 + rng.integers(0, 64, rows.shape[0])
    far = np.arange(0, n, 300)
    rows = np.r_[rows, far]
    cols = np.r_[cols, (far // 64 * 64 + 4096) % n]
    key = np.unique(rows * n + cols)
    rows, cols = np.divmod(key, n)
    vals = rng.standard_normal(rows.shape[0]).astype(np.float32)
    return rows.astype(np.int32), cols.astype(np.int32), vals, (n, n)


# name -> (triplets, what the float32 plan must show)
CASES = {
    "stencil": (lambda: _square(make_stencil(
        4096, 4, seed=1), 4096), dict(dia=True, sell=False)),
    "banded": (lambda: _banded(4096, 24, seed=2), dict(dia=True)),
    "clustered": (lambda: _square(_clustered_coo(4096, 6, 48, 31), 4096),
                  dict(cw=64, windows=True)),
    "random": (lambda: _square(random_coo(4096, 4096, density=4 / 4096,
                                          seed=3), 4096),
               dict(cw=8, windows=False)),
    "road_like": (lambda: _square(_road_like_coo(32768, seed=11), 32768),
                  dict(overflow=True, windows=True)),
    "roadnet": (lambda: tm_t.roadnet(8192, seed=8),
                dict(dia=True, windows=True)),
    "fem2d": (lambda: tm_t.fem2d(64, seed=7), dict(dia=True)),
    "depth_one": (_depth_one, dict(cw=64, windows=True)),
}


def _matrices(name):
    r, c, v, shape = CASES[name][0]()
    return (bj.coo_to_bmsparse(r, c, v, shape, backend="host"),
            bt.coo_to_bmsparse(r, c, v, shape, device="cpu"))


def _check_features(p, pj, want):
    """p: the port's plan, equal to the JAX plan pj (whose slabs give the
    slot width cw)."""
    if "dia" in want:
        assert (p.dia is not None) == want["dia"]
    if "sell" in want:
        assert bool(p.sell_ks) == want["sell"]
    if "cw" in want:
        assert pj.sell_dense[0].shape[0] == want["cw"]
        assert all(pk.cw == want["cw"] for pk in p.sell_pack
                   if pk is not None)
    if "windows" in want:
        assert any(pk is not None for pk in p.sell_pack) == want["windows"]
    if "overflow" in want:
        assert bool(p.ovf_ks) == want["overflow"]


@pytest.mark.parametrize("gen,args", [("roadnet", (8192, 8)),
                                      ("fem2d", (64, 7))])
def test_generators_match_jax(gen, args):
    n, seed = args
    for a, b in zip(getattr(tm_t, gen)(n, seed=seed),
                    getattr(tm_j, gen)(n, seed=seed)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prepare_matches_jax(name, dtype):
    mj, mt = _matrices(name)
    pj = prepare_j(mj, dtype=getattr(jnp, dtype), stream="off")
    pt = prepare_t(mt, dtype=getattr(torch, dtype), stream="off")
    assert_same_plan(pj, pt)
    if dtype == "float32":
        _check_features(pt, pj, CASES[name][1])


@pytest.mark.parametrize("sell_unit", [8, 64])
def test_prepare_sell_unit_matches_jax(sell_unit):
    mj, mt = _matrices("clustered")
    pj = prepare_j(mj, sell_unit=sell_unit, stream="off")
    pt = prepare_t(mt, sell_unit=sell_unit)
    assert_same_plan(pj, pt)
    assert pj.sell_dense[0].shape[0] == sell_unit


@pytest.mark.parametrize("name", ["clustered", "roadnet", "depth_one"])
def test_cast_prepared_matches_jax(name):
    """depth_one's depth-1 groups lose their window under the cast: their
    packs' entries join the tier's gathered pack."""
    mj, mt = _matrices(name)
    pj = cast_j(prepare_j(mj, stream="off"), jnp.bfloat16)
    p32 = prepare_t(mt, stream="off")
    pt = cast_t(p32, torch.bfloat16)
    lost = [a is not None and b is None
            for a, b in zip(p32.sell_pack, pt.sell_pack)]
    assert any(lost) == (name == "depth_one")
    assert_same_plan(pj, pt)
    # and the cast equals a bf16 build, the windowed groups' packs too
    pb = prepare_t(mt, dtype=torch.bfloat16)
    assert_same_plan(pt, pb)
    assert [pk is None for pk in pt.sell_pack] == [
        rel is None for rel in pj.sell_rel]
    assert all(pk.vals.dtype == torch.bfloat16 for pk in pt.sell_pack
               if pk is not None)


def test_prepare_ragusa16_and_empty(ragusa16):
    r = ragusa16
    args = (r.row.astype(np.int32), r.col.astype(np.int32),
            r.data.astype(np.float32), r.shape)
    assert_same_plan(
        prepare_j(bj.coo_to_bmsparse(*args, backend="host"), stream="off"),
        prepare_t(bt.coo_to_bmsparse(*args, device="cpu")))
    e = np.empty(0, np.int32)
    ev = np.empty(0, np.float32)
    pt = prepare_t(bt.coo_to_bmsparse(e, e, ev, (16, 16), device="cpu"))
    assert_same_plan(
        prepare_j(bj.coo_to_bmsparse(e, e, ev, (16, 16), backend="host"),
                  stream="off"), pt)
    assert pt.dia is None and not pt.sell_ks


def test_plan_to_device_keeps_arrays():
    _, mt = _matrices("roadnet")
    pt = prepare_t(mt)
    assert_same_plan(pt, pt.to("cpu"))
    assert pt.num_rows == mt.num_rows and pt.m is mt
