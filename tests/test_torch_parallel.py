"""The multi-device layer of the PyTorch port (bmsparse_tpu_torch/parallel)
against the JAX package's (bmsparse_tpu/parallel), on the CPU.

Plans, in this process: partition, prepare_sharded (halo included) and
prepare_sharded_product (slot tables, exchange plan, the three comm_bytes
counts) build the JAX package's arrays, array for array, at d = 2 and 8,
on the structures of tests/test_parallel.py: the skewed tridiagonal, the
halo band, the tall matrix, the non-ladder depth, the banded and random
products and the hub structure of the skew fallback.

Exchanges, in spawned gloo ranks (world 2 and 4; the rank bodies are in
tests/_torch_parallel_ranks.py and import the port only): sharded_spmv,
sharded_spmv_prepared (halo and all-gather), sharded_spgemm,
sharded_multiply (and a value update) and dryrun_multichip(d, "cpu")
against the JAX package's results on its 8-device CPU mesh, values at
rtol 1e-5 (float32 sums in another order), C's structure exactly.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

import bmsparse_tpu as bj
from bmsparse_tpu.parallel.mesh import make_mesh as make_mesh_j
from bmsparse_tpu.parallel.partition import partition as partition_j
from bmsparse_tpu.parallel.plan import prepare_sharded as prepare_sharded_j
from bmsparse_tpu.parallel.product import (
    prepare_sharded_product as prepare_product_j,
    sharded_multiply as sharded_multiply_j,
)
from bmsparse_tpu.parallel.spgemm import (
    estimate_bounds as estimate_bounds_j, sharded_spgemm as sharded_spgemm_j,
)
from bmsparse_tpu.parallel.spmv import (
    sharded_spmv as sharded_spmv_j,
    sharded_spmv_prepared as sharded_spmv_prepared_j,
)

import bmsparse_tpu_torch as bt
from bmsparse_tpu_torch.interop import pack_from_slabs, tensor_from_numpy
from bmsparse_tpu_torch.parallel import launch
from bmsparse_tpu_torch.parallel.mesh import make_mesh
from bmsparse_tpu_torch.parallel.partition import ShardedBmSparse, partition
from bmsparse_tpu_torch.parallel.plan import prepare_sharded
from bmsparse_tpu_torch.parallel.product import (
    local_multiply, prepare_sharded_product, shard_b_needed,
)
from bmsparse_tpu_torch.parallel.spgemm import estimate_bounds
from bmsparse_tpu_torch.parallel.spmv import (
    local_spmv_prepared, shard_window,
)

import _torch_parallel_ranks as ranks
from conftest import random_coo

PARITY = dict(rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# structures (tests/test_parallel.py's), as (rows, cols, vals, shape)
# ---------------------------------------------------------------------------
def _banded(n, lo, hi, seed):
    r = np.repeat(np.arange(n), hi - lo + 1)
    c = np.clip(r + np.tile(np.arange(lo, hi + 1), n), 0, n - 1)
    key = np.unique(r * n + c)
    rows, cols = np.divmod(key, n)
    vals = np.random.default_rng(seed).standard_normal(
        len(rows)).astype(np.float32)
    return rows.astype(np.int32), cols.astype(np.int32), vals, (n, n)


def _skewed():
    rng = np.random.default_rng(4)
    n = 1024
    r1 = np.repeat(np.arange(n), 3)
    c1 = np.clip(r1 + np.tile(np.arange(-1, 2), n), 0, n - 1)
    flat = rng.choice(n * n // 2, size=n * 2, replace=False)
    r2, c2 = np.divmod(flat, n)
    key = np.unique(np.concatenate([r1 * n + c1, r2 * n + c2]))
    rows, cols = np.divmod(key, n)
    vals = rng.standard_normal(len(rows)).astype(np.float32)
    return rows.astype(np.int32), cols.astype(np.int32), vals, (n, n)


def _tall():
    n_rows, n_cols = 2048, 256
    r = np.arange(n_rows)
    vals = np.random.default_rng(7).standard_normal(n_rows).astype(np.float32)
    return (r.astype(np.int32), (r % n_cols).astype(np.int32), vals,
            (n_rows, n_cols))


def _nonladder():
    n = 256
    rows = np.repeat(np.arange(n, dtype=np.int64), 5)
    cols = (np.tile(np.arange(5), n) * 48 + rows % 8) % n
    key = np.unique(rows * n + cols)
    rows, cols = np.divmod(key, n)
    vals = np.random.default_rng(3).standard_normal(
        rows.shape[0]).astype(np.float32)
    return rows.astype(np.int32), cols.astype(np.int32), vals, (n, n)


def _hubs():
    n = 512
    rng = np.random.default_rng(77)
    dense_rows = np.arange(0, n, 64)
    r1 = np.concatenate([np.full((n,), dr) for dr in dense_rows]
                        + [np.arange(n)])
    c1 = np.concatenate([np.arange(n)] * len(dense_rows) + [np.arange(n)])
    key = np.unique(r1.astype(np.int64) * n + c1)
    rows, cols = np.divmod(key, n)
    vals = rng.standard_normal(len(rows)).astype(np.float32)
    return rows.astype(np.int32), cols.astype(np.int32), vals, (n, n)


def _random(m, n, density, seed):
    return (*random_coo(m, n, density=density, seed=seed), (m, n))


CASES = {
    "spmv": _random(177, 203, 0.05, 37),
    "band": _banded(2048, -2, 2, 21),
    "skewed": _skewed(),
    "tall": _tall(),
    "nonladder": _nonladder(),
    "ga": _random(96, 80, 0.06, 43),
    "gb": _random(80, 112, 0.06, 44),
    "prod_band": _banded(512, -1, 1, 11),
    "prod_random": _random(256, 256, 0.03, 55),
    "hubs": _hubs(),
}
VECTORS = {
    "v_spmv": np.random.default_rng(5).standard_normal(203).astype(
        np.float32),
    "v_band": np.random.default_rng(22).standard_normal(2048).astype(
        np.float32),
    "v_skewed": np.random.default_rng(6).standard_normal(1024).astype(
        np.float32),
    "v_tall": np.random.default_rng(8).standard_normal(256).astype(
        np.float32),
}


def _both(name, transposed=False):
    r, c, v, shape = CASES[name]
    return (bj.coo_to_bmsparse(r, c, v, shape, transposed=transposed,
                               backend="host"),
            bt.coo_to_bmsparse(r, c, v, shape, transposed=transposed,
                               device="cpu"))


def _host(x):
    """Either package's array as numpy."""
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _eq(want, got, name, words=False):
    w, g = _host(want), _host(got)
    if words:
        w, g = (x.astype(np.int64).astype(np.uint32) for x in (w, g))
    assert w.shape == g.shape, (name, w.shape, g.shape)
    np.testing.assert_array_equal(g, w, err_msg=name)


def _host_tensor(x):
    return tensor_from_numpy(np.asarray(x))


def _same_coo(want, got):
    for x, y, what in zip(want, got, ("rows", "cols", "values")):
        if what == "values":
            np.testing.assert_allclose(y, x, **PARITY)
        else:
            np.testing.assert_array_equal(y, x, err_msg=what)


# ---------------------------------------------------------------------------
# plans: equal to the JAX package's, array for array
# ---------------------------------------------------------------------------
SHARDED_FIELDS = ("brow", "bcol", "offsets", "values", "nb")


def _same_sharded(sj, st):
    for f in SHARDED_FIELDS:
        _eq(getattr(sj, f), getattr(st, f), f)
    for f in ("bmp_hi", "bmp_lo"):
        _eq(getattr(sj, f), getattr(st, f), f, words=True)
    for f in ("num_rows", "num_cols", "nnz", "transposed",
              "rows_per_shard"):
        assert getattr(sj, f) == getattr(st, f), f


@pytest.mark.parametrize("d", [2, 8])
@pytest.mark.parametrize("name,align,transposed", [
    ("spmv", 1, False), ("skewed", 16, False), ("gb", 1, True),
    ("tall", 16, False)])
def test_partition_matches_jax(name, align, transposed, d):
    mj, mt = _both(name, transposed)
    sj, st = partition_j(mj, d, align=align), partition(mt, d, align=align)
    _same_sharded(sj, st)
    back = st.to_bmsparse()
    assert back.nb == int(mt.nb) and back.nnz == mt.nnz
    _same_coo(mt.generate_coo(), back.generate_coo())


@pytest.mark.parametrize("name,d", [("skewed", 2), ("skewed", 8),
                                    ("band", 8), ("tall", 8),
                                    ("nonladder", 2), ("spmv", 2)])
def test_prepare_sharded_matches_jax(name, d):
    mj, mt = _both(name)
    align = 1 if name == "nonladder" else 16
    pj = prepare_sharded_j(partition_j(mj, d, align=align))
    pt = prepare_sharded(partition(mt, d, align=align))
    assert pt.dia_offsets == pj.dia_offsets
    assert pt.sell_ks == pj.sell_ks and pt.sell_rows == pj.sell_rows
    assert pt.halo == pj.halo
    if pj.dia is None:
        assert pt.dia is None
    else:
        _eq(pj.dia, pt.dia, "dia")
    _eq(pj.out_gather, pt.out_gather, "out_gather")
    # each shard's pack holds the nonzeros of the JAX shard's slabs
    assert pt.sell_chunks == tuple(x.shape[2] for x in pj.sell_dense)
    assert len(pt.sell_gpack) == (d if pt.sell_ks else 0)
    for s, gk in enumerate(pt.sell_gpack):
        want = pack_from_slabs(
            [_host_tensor(x[s]) for x in pj.sell_dense],
            [_host_tensor(x[s]) for x in pj.sell_bcol],
            range(len(pt.sell_ks)), pt.sell_rows)
        assert gk.nnz == want.nnz
        for f in gk.TENSORS:
            _eq(getattr(want, f), getattr(gk, f), f"sell_gpack[{s}].{f}")
    if name == "band":
        assert pt.halo is not None
    if name == "tall":
        assert pt.dia_offsets and pt.halo is None


PRODUCT_ARRAYS = ("a_flat", "b_flat", "send_idx", "sig_off", "cbrow",
                  "cbcol", "c_offsets", "c_nb")
PRODUCT_STATICS = ("ks", "caps", "exchange", "nnz_pad", "nbc_pad",
                   "max_send", "num_rows", "num_cols", "rows_per_shard",
                   "comm_bytes_selective", "comm_bytes_useful",
                   "comm_bytes_allgather")


def _products(name, d):
    aj, at = _both(name)
    bj_, btt = _both(name, transposed=True)
    return (prepare_product_j(partition_j(aj, d, align=16),
                              partition_j(bj_, d, align=16)),
            prepare_sharded_product(partition(at, d, align=16),
                                    partition(btt, d, align=16)))


@pytest.mark.parametrize("name,d", [("prod_band", 2), ("prod_band", 8),
                                    ("prod_random", 4), ("hubs", 8)])
def test_sharded_product_plan_matches_jax(name, d):
    pj, pt = _products(name, d)
    for f in PRODUCT_STATICS:
        assert getattr(pt, f) == getattr(pj, f), f
    for f in PRODUCT_ARRAYS:
        _eq(getattr(pj, f), getattr(pt, f), f)
    for f in ("sig_hi", "sig_lo", "c_hi", "c_lo"):
        _eq(getattr(pj, f), getattr(pt, f), f, words=True)
    for g, (x, y) in enumerate(zip(pj.tas, pt.tas)):
        _eq(x, y, f"tas[{g}]")
    for g, (x, y) in enumerate(zip(pj.tbs, pt.tbs)):
        _eq(x, y, f"tbs[{g}]")
    assert pt.plan_seconds > 0
    if name == "hubs":
        assert pt.exchange == "allgather"
        assert pt.comm_bytes_selective >= pt.comm_bytes_allgather
        assert pt.comm_bytes_useful <= pt.comm_bytes_selective
    else:
        assert pt.comm_bytes_selective < pt.comm_bytes_allgather


@pytest.mark.parametrize("name,d", [("prod_band", 4), ("hubs", 8)])
def test_shard_bodies_without_ranks(name, d):
    """Each shard's local body on the window its exchange would deliver
    gives the single-device product's C (C's structure exactly), and the
    SpMV bodies the single-device u."""
    _, pt = _products(name, d)
    vals = [local_multiply(pt, s, shard_b_needed(pt, s), kernels=False)
            for s in range(d)]
    c = ShardedBmSparse(
        brow=pt.cbrow, bcol=pt.cbcol, bmp_hi=pt.c_hi, bmp_lo=pt.c_lo,
        offsets=pt.c_offsets, values=torch.stack(vals), nb=pt.c_nb,
        num_rows=pt.num_rows, num_cols=pt.num_cols, nnz=-1,
        rows_per_shard=pt.rows_per_shard).to_bmsparse()
    _, at = _both(name)
    _, btt = _both(name, transposed=True)
    _same_coo(bt.spgemm(at, btt).generate_coo(), c.generate_coo())
    _, mt = _both("band")
    sp = prepare_sharded(partition(mt, d, align=16))
    v = torch.from_numpy(VECTORS["v_band"])
    for ex in ("halo", "allgather"):
        u = torch.cat([local_spmv_prepared(sp, s, shard_window(sp, v, s, ex),
                                           ex, kernels=False)
                       for s in range(d)])[:mt.num_rows]
        np.testing.assert_allclose(u.numpy(), bt.spmv(mt, v).numpy(),
                                   **PARITY)


def test_estimate_bounds_and_errors():
    (aj, at), (bj_, btt) = _both("ga"), _both("gb", transposed=True)
    for d in (2, 4):
        assert estimate_bounds(partition(at, d), partition(btt, d)) == \
            estimate_bounds_j(partition_j(aj, d), partition_j(bj_, d))
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(2, "cpu")
    with pytest.raises(ValueError, match="align=16"):
        prepare_sharded(partition(at, 2))
    with pytest.raises(ValueError, match="impl"):
        prepare_sharded_product(partition(at, 2, align=16),
                                partition(btt, 2, align=16), impl="xla")


# ---------------------------------------------------------------------------
# exchanges: spawned gloo ranks against the JAX package's mesh
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def world(request):
    d = request.param
    got = launch.run_ranks(ranks.workload, d, "cpu", CASES | VECTORS,
                           timeout=600)
    return d, got


def _jax_matrix(name, transposed=False):
    r, c, v, shape = CASES[name]
    return bj.coo_to_bmsparse(r, c, v, shape, transposed=transposed,
                              backend="host")


def test_ranks_import_only_the_port(world):
    d, got = world
    assert [g["rank"] for g in got] == list(range(d))
    for g in got:
        assert g["imported_jax"] == []


def test_ranks_agree(world):
    """Every rank returns the whole result, the same on each."""
    _, got = world
    for g in got[1:]:
        for k in ("spmv", "band_halo", "skewed_allgather"):
            np.testing.assert_array_equal(g[k], got[0][k], err_msg=k)
        _same_coo(got[0]["prod_band"], g["prod_band"])


def test_sharded_spmv_matches_jax(world):
    d, got = world
    mesh = make_mesh_j(d)
    want = np.asarray(sharded_spmv_j(
        partition_j(_jax_matrix("spmv"), d),
        jnp.asarray(VECTORS["v_spmv"]), mesh))
    np.testing.assert_allclose(got[0]["spmv"], want, **PARITY)


@pytest.mark.parametrize("name", ["band", "skewed", "tall"])
def test_sharded_spmv_prepared_matches_jax(world, name):
    d, got = world
    mesh = make_mesh_j(d)
    sp = prepare_sharded_j(partition_j(_jax_matrix(name), d, align=16))
    v = jnp.asarray(VECTORS["v_" + name])
    r, c, vals, shape = CASES[name]
    ref = np.zeros(shape[0])
    np.add.at(ref, r, vals.astype(np.float64) * VECTORS["v_" + name][c])
    ran = 0
    for ex in ("halo", "allgather"):
        if ex == "halo" and sp.halo is None:
            assert f"{name}_halo" not in got[0]
            continue
        want = np.asarray(sharded_spmv_prepared_j(sp, v, mesh,
                                                  dia_impl="xla",
                                                  exchange=ex))
        np.testing.assert_allclose(got[0][f"{name}_{ex}"], want, **PARITY)
        np.testing.assert_allclose(got[0][f"{name}_{ex}"], ref, **PARITY)
        ran += 1
    assert ran == 1 + (sp.halo is not None)
    assert (name != "band") or sp.halo is not None


def test_sharded_spgemm_matches_jax(world):
    d, got = world
    sa = partition_j(_jax_matrix("ga"), d)
    sb = partition_j(_jax_matrix("gb", transposed=True), d)
    c = sharded_spgemm_j(sa, sb, make_mesh_j(d), **estimate_bounds_j(sa, sb))
    np.testing.assert_array_equal(got[0]["spgemm_nb"], np.asarray(c.nb))
    _same_coo(c.to_bmsparse().generate_coo(), got[0]["spgemm"])


@pytest.mark.parametrize("name", ["prod_band", "prod_random"])
def test_sharded_multiply_matches_jax(world, name):
    d, got = world
    a = _jax_matrix(name)
    sa = partition_j(a, d, align=16)
    sb = partition_j(_jax_matrix(name, transposed=True), d, align=16)
    spp = prepare_product_j(sa, sb)
    assert got[0][name + "_exchange"] == spp.exchange
    mesh = make_mesh_j(d)
    _same_coo(sharded_multiply_j(spp, mesh).to_bmsparse().generate_coo(),
              got[0][name])
    spp2 = dataclasses.replace(spp, a_flat=spp.a_flat * 2.0)
    _same_coo(sharded_multiply_j(spp2, mesh).to_bmsparse().generate_coo(),
              got[0][name + "_x2"])


def test_dryrun_matches_jax(world):
    d, got = world
    import __graft_entry__ as ge

    out = got[0]["dryrun"]
    a, b, v = ge._sample_matrices(shape=(128, 128), density=0.05, seed=1)
    mesh = make_mesh_j(d)
    sa, sb = partition_j(a, d), partition_j(b, d)
    c = sharded_spgemm_j(sa, sb, mesh, **estimate_bounds_j(sa, sb))
    np.testing.assert_allclose(out["u"], np.asarray(
        sharded_spmv_j(c, v, mesh)), **PARITY)
    sa16, sb16 = partition_j(a, d, align=16), partition_j(b, d, align=16)
    np.testing.assert_allclose(out["u2"], np.asarray(sharded_spmv_prepared_j(
        prepare_sharded_j(sa16), v, mesh, dia_impl="xla")), **PARITY)
    spp = prepare_product_j(sa16, sb16)
    _same_coo(sharded_multiply_j(spp, mesh).to_bmsparse().generate_coo(),
              out["c"])
    assert (out["comm_bytes_selective"], out["comm_bytes_allgather"]) == (
        spp.comm_bytes_selective, spp.comm_bytes_allgather)
    assert out["err3"] < 1e-5 and out["halo"] is not None
