"""Parity of the PyTorch port's format layer with the JAX package:
bitmap algebra, the host COO converter, decompression, generate_coo,
padding and compare(). Structure arrays must be equal exactly."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

import bmsparse_tpu as bj
from bmsparse_tpu.format import bitmap as bm_j

import bmsparse_tpu_torch as bt
from bmsparse_tpu_torch.format import bitmap as bm_t
from bmsparse_tpu_torch.interop import bmsparse_from_numpy

from conftest import random_coo

FIELDS = ("brow", "bcol", "bmp_hi", "bmp_lo", "offsets", "values")


def _jax_arrays(m):
    out = {f: np.asarray(getattr(m, f)) for f in FIELDS}
    out["nb"] = int(m.nb)
    return out


def _port_arrays(m):
    out = {f: getattr(m, f).numpy() for f in FIELDS}
    out["bmp_hi"] = bm_t.tensor_to_words_np(m.bmp_hi)
    out["bmp_lo"] = bm_t.tensor_to_words_np(m.bmp_lo)
    out["nb"] = m.nb
    return out


def _assert_same_container(mj, mt):
    a, b = _jax_arrays(mj), _port_arrays(mt)
    assert a["nb"] == b["nb"]
    for f in FIELDS:
        assert a[f].dtype == b[f].dtype, f
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    assert (mj.num_rows, mj.num_cols, mj.nnz, mj.transposed) == (
        mt.num_rows, mt.num_cols, mt.nnz, mt.transposed)


def _cases(ragusa16):
    r = ragusa16
    yield "ragusa16", (r.row.astype(np.int32), r.col.astype(np.int32),
                       r.data.astype(np.float32), r.shape)
    for shape, density, seed in (((24, 24), 0.15, 1), ((100, 64), 0.05, 2),
                                 ((333, 217), 0.03, 3)):
        yield f"random{shape}", (*random_coo(*shape, density=density,
                                             seed=seed), shape)


# ---------------------------------------------------------------------------
# bitmap algebra
# ---------------------------------------------------------------------------
def test_bitmap_ops_match_jax(rng):
    words = rng.integers(0, 2**32, size=(64, 2), dtype=np.uint32)
    words[0] = 0
    words[1] = 0xFFFFFFFF
    hj, lj = jnp.asarray(words[:, 0]), jnp.asarray(words[:, 1])
    ht, lt = (bm_t.words_to_tensor(words[:, 0]),
              bm_t.words_to_tensor(words[:, 1]))
    bits_j = np.asarray(bm_j.expand_bits(hj, lj))
    bits_t = bm_t.expand_bits(ht, lt)
    np.testing.assert_array_equal(bits_t.numpy(), bits_j)
    np.testing.assert_array_equal(
        bm_t.popcount(ht, lt).numpy(), np.asarray(bm_j.popcount(hj, lj)))
    np.testing.assert_array_equal(
        bm_t.prefix_popcount(bits_t).numpy(),
        np.asarray(bm_j.prefix_popcount(jnp.asarray(bits_j))))
    h2, l2 = bm_t.pack_bits(bits_t)
    np.testing.assert_array_equal(bm_t.tensor_to_words_np(h2), words[:, 0])
    np.testing.assert_array_equal(bm_t.tensor_to_words_np(l2), words[:, 1])
    u64 = bm_t.words_to_u64_np(words[:, 0], words[:, 1])
    np.testing.assert_array_equal(
        u64, bm_j.words_to_u64_np(words[:, 0], words[:, 1]))
    for a, b in zip(bm_t.u64_to_words_np(u64), bm_j.u64_to_words_np(u64)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the host converter, decompression, generate_coo
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", range(4))
@pytest.mark.parametrize("transposed", [False, True])
def test_host_converter_matches_jax(ragusa16, case, transposed):
    _, (r, c, v, shape) = list(_cases(ragusa16))[case]
    mj = bj.coo_to_bmsparse(r, c, v, shape, transposed=transposed,
                            backend="host")
    mt = bt.coo_to_bmsparse(r, c, v, shape, transposed=transposed,
                            device="cpu")
    _assert_same_container(mj, mt)
    # the JAX device converter agrees on the valid blocks
    md = bj.coo_to_bmsparse(r, c, v, shape, transposed=transposed)
    nb = int(md.nb)
    assert nb == mt.nb
    for f in ("brow", "bcol", "offsets"):
        np.testing.assert_array_equal(np.asarray(getattr(md, f))[:nb],
                                      getattr(mt, f).numpy(), err_msg=f)
    np.testing.assert_array_equal(np.asarray(md.bmp_hi)[:nb],
                                  bm_t.tensor_to_words_np(mt.bmp_hi))


@pytest.mark.parametrize("case", range(4))
@pytest.mark.parametrize("transposed", [False, True])
def test_decompress_and_coo_match_jax(ragusa16, case, transposed):
    _, (r, c, v, shape) = list(_cases(ragusa16))[case]
    mj = bj.coo_to_bmsparse(r, c, v, shape, transposed=transposed,
                            backend="host")
    mt = bt.coo_to_bmsparse(r, c, v, shape, transposed=transposed,
                            device="cpu")
    np.testing.assert_array_equal(mt.decompress_blocks_flat().numpy(),
                                  np.asarray(mj.decompress_blocks_flat()))
    np.testing.assert_array_equal(mt.block_nnz().numpy(),
                                  np.asarray(mj.block_nnz()))
    for order in ("rowcol", "any"):
        for a, b in zip(mt.generate_coo(order=order),
                        mj.generate_coo(order=order)):
            np.testing.assert_array_equal(a, b)
    # the reference contract: row-major sorted triplets equal to the input
    rows, cols, vals = mt.generate_coo()
    o = np.lexsort((c, r))
    np.testing.assert_array_equal(rows, r[o])
    np.testing.assert_array_equal(cols, c[o])
    np.testing.assert_array_equal(vals, v[o].astype(np.float64))


def test_interop_container_roundtrip(ragusa16):
    r = ragusa16
    args = (r.row.astype(np.int32), r.col.astype(np.int32),
            r.data.astype(np.float32), r.shape)
    mj = bj.coo_to_bmsparse(*args, backend="host")
    mt = bmsparse_from_numpy(_jax_arrays(mj), mj.num_rows, mj.num_cols,
                             mj.nnz, mj.transposed, device="cpu")
    _assert_same_container(mj, mt)
    _assert_same_container(mj, bt.coo_to_bmsparse(*args, device="cpu"))


def test_duplicates_and_empty_match_jax():
    r = np.array([0, 3, 0, 9, 3], np.int32)
    c = np.array([1, 2, 1, 9, 2], np.int32)
    v = np.array([1.0, 2.0, 3.0, 4.0, 5.0], np.float32)
    _assert_same_container(bj.coo_to_bmsparse(r, c, v, (16, 16),
                                              backend="host"),
                           bt.coo_to_bmsparse(r, c, v, (16, 16), device="cpu"))
    e = np.empty(0, np.int32)
    ev = np.empty(0, np.float32)
    mt = bt.coo_to_bmsparse(e, e, ev, (20, 20), device="cpu")
    _assert_same_container(bj.coo_to_bmsparse(e, e, ev, (20, 20),
                                              backend="host"), mt)
    assert mt.generate_coo()[0].shape == (0,)


def test_padding_blocks_are_identity():
    r, c, v = random_coo(80, 80, density=0.05, seed=21)
    mt = bt.coo_to_bmsparse(r, c, v, (80, 80), device="cpu")
    mp = mt.pad_to(mt.nb_pad + 33, mt.nnz_pad + 8)
    mj = bj.coo_to_bmsparse(r, c, v, (80, 80), backend="host")
    mjp = mj.pad_to(mj.nb_pad + 33, mj.nnz_pad + 8)
    _assert_same_container(mjp, mp)
    for a, b in zip(mp.generate_coo(), mt.generate_coo()):
        np.testing.assert_array_equal(a, b)
    dense = mp.decompress_blocks_flat().numpy()
    assert not dense[mt.nb_pad:].any()


def test_mmread_and_compare_match_jax(ragusa16):
    from conftest import data_path

    path = data_path("A_matrix.mtx")
    mt = bt.mmread_bmsparse(path, device="cpu")
    mj = bj.mmread_bmsparse(path)
    _assert_same_container(mj, mt)
    assert mt.compare(ragusa16) == pytest.approx(mj.compare(ragusa16),
                                                 abs=0)
    # a perturbed value is charged as the JAX package charges it
    pert = ragusa16.copy()
    pert.data = pert.data.copy()
    pert.data[3] *= 1.5
    assert mt.compare(pert) == pytest.approx(mj.compare(pert), rel=1e-12)
    assert mt.compare(pert) > 0
    np.testing.assert_allclose(mt.to_scipy().toarray(), ragusa16.toarray())


def test_entry_points_default_to_the_card():
    """The entry points that make a container run on the card unless the
    caller asks for the CPU; with no card, a call that names no device
    fails with torch's own error and does not drop to the CPU."""
    import inspect

    from conftest import data_path

    for fn in (bt.coo_to_bmsparse, bt.mmread_bmsparse, bmsparse_from_numpy):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    r, c, v = random_coo(40, 40, density=0.1, seed=5)
    if torch.cuda.is_available():
        assert bt.coo_to_bmsparse(r, c, v, (40, 40)).device.type == "cuda"
        return
    with pytest.raises((AssertionError, RuntimeError)):
        bt.coo_to_bmsparse(r, c, v, (40, 40))
    with pytest.raises((AssertionError, RuntimeError)):
        bt.mmread_bmsparse(data_path("A_matrix.mtx"))
