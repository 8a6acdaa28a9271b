"""Persistence in the PyTorch port against the JAX package: the container
npz crosses between the packages in both directions (float32, transposed,
empty, bfloat16 bit for bit), and a plan saved with save_prepared loads
with load_prepared to an SpMV that is bitwise equal (block tiers, stream
tier, bfloat16), with a stale layout stamp refused."""

import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

import bmsparse_tpu as bj
from bmsparse_tpu.io import binary as bin_j

import bmsparse_tpu_torch as bt
from bmsparse_tpu_torch.format import bitmap as bm_t
from bmsparse_tpu_torch.io import binary as bin_t
from bmsparse_tpu_torch.ops import plan as plan_t
from bmsparse_tpu_torch.utils import testmats as tm

from conftest import random_coo
from test_plan_cache import _mixed_matrix
from test_torch_format import FIELDS, _assert_same_container


def _npz_arrays(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _case(name):
    if name == "empty":
        e = np.empty(0, np.int32)
        return e, e, np.empty(0, np.float32), (40, 24), False
    r, c, v = random_coo(200, 136, density=0.04, seed=5)
    return r, c, v, (200, 136), name == "transposed"


@pytest.mark.parametrize("name", ["float32", "transposed", "empty"])
def test_npz_crosses_both_ways(tmp_path, name):
    r, c, v, shape, tr = _case(name)
    mj = bj.coo_to_bmsparse(r, c, v, shape, transposed=tr, backend="host")
    mt = bt.coo_to_bmsparse(r, c, v, shape, transposed=tr, device="cpu")
    if name != "empty":
        # bit 31 of the hi word (address 0) must survive int64 storage
        assert int(mt.bmp_hi.max()) >= 2**31
    # JAX -> port: every array equal
    bin_j.save_bmsparse(str(tmp_path / "j"), mj)
    lt = bt.load_bmsparse(str(tmp_path / "j"), device="cpu")
    nb = int(mj.nb)
    for f in FIELDS:
        want = np.asarray(getattr(mj, f))[: nb if f != "values" else mj.nnz]
        got = getattr(lt, f)
        got = (bm_t.tensor_to_words_np(got)
               if f.startswith("bmp") else got.numpy())
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert (lt.nb, lt.nnz, lt.shape, lt.transposed) == (
        nb, mj.nnz, mj.shape, mj.transposed)
    # port -> JAX, and the two files hold equal arrays
    bt.save_bmsparse(str(tmp_path / "t"), mt)
    a_j = _npz_arrays(tmp_path / "j.npz")
    a_t = _npz_arrays(tmp_path / "t.npz")
    assert a_j.keys() == a_t.keys()
    for k in a_j:
        assert a_j[k].dtype == a_t[k].dtype, k
        np.testing.assert_array_equal(a_j[k], a_t[k], err_msg=k)
    lj = bin_j.load_bmsparse(str(tmp_path / "t.npz"))
    if name != "empty":
        _assert_same_container(lj, mt)


def test_npz_bf16_bitwise(tmp_path):
    r, c, v, shape, _ = _case("float32")
    mj = bj.coo_to_bmsparse(r, c, v, shape, backend="host").astype(
        jnp.bfloat16)
    bin_j.save_bmsparse(str(tmp_path / "j"), mj)
    assert np.load(tmp_path / "j.npz")["values"].dtype == np.dtype("V2")
    lt = bt.load_bmsparse(str(tmp_path / "j"), device="cpu")
    assert lt.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        lt.values.view(torch.int16).numpy().view(np.uint16),
        np.asarray(mj.values).view(np.uint16))
    bt.save_bmsparse(str(tmp_path / "t"), lt)
    members = [zipfile.ZipFile(tmp_path / f"{s}.npz").read("values.npy")
               for s in "jt"]
    assert members[0] == members[1]
    again = bt.load_bmsparse(str(tmp_path / "t.npz"), device="cpu")
    assert torch.equal(again.values.view(torch.int16),
                       lt.values.view(torch.int16))


def test_npz_version_checked(tmp_path):
    r, c, v, shape, _ = _case("float32")
    mt = bt.coo_to_bmsparse(r, c, v, shape, device="cpu")
    bt.save_bmsparse(str(tmp_path / "m.npz"), mt)
    a = _npz_arrays(tmp_path / "m.npz")
    a["version"] = np.int32(2)
    np.savez(tmp_path / "bad", **a)
    with pytest.raises(ValueError, match="version"):
        bt.load_bmsparse(str(tmp_path / "bad"), device="cpu")


def _spmv_pair(p, path, m):
    v = torch.from_numpy(np.random.default_rng(1).standard_normal(
        m.num_cols).astype(np.float32))
    bin_t.save_prepared(path, p)
    p2 = bin_t.load_prepared(path, m)
    assert p2 is not None and p2.m is m
    return bt.spmv(p, v), bt.spmv(p2, v), p2


def test_plan_roundtrip_block_tiers(tmp_path):
    _, rows, cols, vals = _mixed_matrix()
    n = 2048
    m = bt.coo_to_bmsparse(rows, cols, vals, (n, n), device="cpu")
    p = plan_t.prepare(m, stream="off")
    assert p.dia is not None and p.sell_ks and p.ovf_ks
    u, u2, p2 = _spmv_pair(p, str(tmp_path / "plan.pt"), m)
    assert torch.equal(u, u2)
    for f in ("sell_ks", "sell_chunks", "ovf_ks", "ovf_chunks",
              "dia_offsets", "plan_dtype"):
        assert getattr(p2, f) == getattr(p, f), f
    for f in ("dia", "out_gather", "ovf_gather"):
        assert torch.equal(getattr(p2, f), getattr(p, f)), f
    packs = [(f"sell_pack[{g}]", a, b)
             for g, (a, b) in enumerate(zip(p2.sell_pack, p.sell_pack))]
    packs += [(f, getattr(p2, f), getattr(p, f))
              for f in ("sell_gpack", "ovf_gpack")]
    assert len(p2.sell_pack) == len(p.sell_pack)
    for f, a, b in packs:
        assert (a is None) == (b is None), f
        for k in () if a is None else a.TENSORS:
            assert torch.equal(getattr(a, k), getattr(b, k)), (f, k)


def test_plan_roundtrip_stream_tier(tmp_path):
    rows, cols, vals, shape = tm.webgraph(4096, avg_deg=6, seed=9)
    m = bt.coo_to_bmsparse(rows, cols, vals, shape, device="cpu")
    p = plan_t.prepare(m, stream="force")
    assert p.stream is not None
    u, u2, p2 = _spmv_pair(p, str(tmp_path / "plan.pt"), m)
    assert torch.equal(u, u2)
    for f in p.stream.TENSORS:
        assert torch.equal(getattr(p2.stream, f), getattr(p.stream, f)), f
    for f in p.stream.STATICS:
        assert getattr(p2.stream, f) == getattr(p.stream, f), f


def test_plan_roundtrip_bf16(tmp_path):
    _, rows, cols, vals = _mixed_matrix(seed=3)
    m = bt.coo_to_bmsparse(rows, cols, vals, (2048, 2048),
                           device="cpu").astype(torch.bfloat16)
    p = plan_t.prepare(m)
    p.dense_flat                         # made and kept on first use
    u, u2, p2 = _spmv_pair(p, str(tmp_path / "plan.pt"), m)
    assert torch.equal(u, u2)
    assert p2.plan_dtype == "bfloat16" and p2.dense_flat_ is None
    assert p2.sell_gpack.vals.dtype == torch.bfloat16
    assert all(pk.vals.dtype == torch.bfloat16 for pk in p2.sell_pack
               if pk is not None)


def test_load_rejects_stale_layout(tmp_path, monkeypatch):
    _, rows, cols, vals = _mixed_matrix(n=256)
    m = bt.coo_to_bmsparse(rows, cols, vals, (256, 256), device="cpu")
    path = str(tmp_path / "plan.pt")
    bin_t.save_prepared(path, plan_t.prepare(m))
    assert plan_t.PLAN_LAYOUT_VERSION == 13
    monkeypatch.setattr(plan_t, "PLAN_LAYOUT_VERSION", 14)
    assert bin_t.load_prepared(path, m) is None
    with pytest.raises(TypeError, match="Prepared"):
        bin_t.save_prepared(path, m)


def test_load_refuses_layout_10_dump(tmp_path, monkeypatch):
    """A dump stamped with layout 10 (plans without packs) is refused, so
    a plan that predates the packs is rebuilt, not run without them."""
    _, rows, cols, vals = _mixed_matrix(n=256)
    m = bt.coo_to_bmsparse(rows, cols, vals, (256, 256), device="cpu")
    path = str(tmp_path / "plan.pt")
    with monkeypatch.context() as mp:
        mp.setattr(plan_t, "PLAN_LAYOUT_VERSION", 10)
        bin_t.save_prepared(path, plan_t.prepare(m))
        assert bin_t.load_prepared(path, m) is not None
    assert bin_t.load_prepared(path, m) is None


def test_load_refuses_layout_11_dump(tmp_path, monkeypatch):
    """A dump stamped with layout 11 (plans without the gathered groups'
    packs) loads as None, so such a plan is rebuilt."""
    m = bt.coo_to_bmsparse(*tm.roadnet(65536, seed=8), device="cpu")
    path = str(tmp_path / "plan.pt")
    with monkeypatch.context() as mp:
        mp.setattr(plan_t, "PLAN_LAYOUT_VERSION", 11)
        bin_t.save_prepared(path, plan_t.prepare(m, stream="off"))
        assert bin_t.load_prepared(path, m) is not None
    assert bin_t.load_prepared(path, m) is None


def test_load_refuses_layout_12_dump(tmp_path, monkeypatch):
    """A dump stamped with layout 12 (plans that carry the slabs) loads
    as None, so such a plan is rebuilt without them."""
    m = bt.coo_to_bmsparse(*tm.roadnet(65536, seed=8), device="cpu")
    path = str(tmp_path / "plan.pt")
    with monkeypatch.context() as mp:
        mp.setattr(plan_t, "PLAN_LAYOUT_VERSION", 12)
        bin_t.save_prepared(path, plan_t.prepare(m, stream="off"))
        assert bin_t.load_prepared(path, m) is not None
    assert bin_t.load_prepared(path, m) is None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plan_roundtrip_gathered_packs(tmp_path, dtype):
    """Both tiers' gathered packs (sell_gpack, ovf_gpack) come back field
    for field under layout 13, and the loaded plan's SpMV is bitwise
    equal."""
    m = bt.coo_to_bmsparse(*tm.roadnet(65536, seed=8), device="cpu")
    p = plan_t.prepare(m, dtype=getattr(torch, dtype), stream="off")
    assert p.sell_gpack is not None and p.ovf_gpack is not None
    u, u2, p2 = _spmv_pair(p, str(tmp_path / "plan.pt"), m)
    assert torch.equal(u, u2)
    for f in ("sell_gpack", "ovf_gpack"):
        a, b = getattr(p2, f), getattr(p, f)
        assert a.state().keys() == b.state().keys() and a.nnz == b.nnz
        for k in a.TENSORS:
            x, y = getattr(a, k), getattr(b, k)
            assert x.dtype == y.dtype and torch.equal(x, y), (f, k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plan_roundtrip_packs(tmp_path, dtype):
    """The windowed groups' packs come back field for field, and None
    where a group gathers."""
    m = bt.coo_to_bmsparse(*tm.roadnet(65536, seed=8), device="cpu")
    p = plan_t.prepare(m, dtype=getattr(torch, dtype), stream="off")
    assert any(pk is not None for pk in p.sell_pack)
    assert any(pk is None for pk in p.sell_pack)
    u, u2, p2 = _spmv_pair(p, str(tmp_path / "plan.pt"), m)
    assert torch.equal(u, u2)
    assert len(p2.sell_pack) == len(p.sell_pack)
    for a, b in zip(p2.sell_pack, p.sell_pack):
        assert (a is None) == (b is None)
        if a is None:
            continue
        for f in a.TENSORS:
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and torch.equal(x, y), f
        assert a.state().keys() == b.state().keys()
        assert (a.cw, a.nnz) == (b.cw, b.nnz)
