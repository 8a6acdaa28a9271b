"""The PyTorch port's converters against the JAX package: the device
converter (run here on the CPU) against JAX's coo_to_bmsparse(backend=
"device") and the port's host converter, with compact True/False, nb_pad,
both layouts and empty input; transpose, CSRMatrix, csr_to_bmsparse,
bmsparse_to_csr and csr_spmv; the bitmap helpers addr_grid,
coords_to_words and bits_to_dense_bool; decompress_blocks, valid_mask and
print_matrix. Structure and values must be equal exactly, csr_spmv within
rtol 1e-6."""

import io

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

import jax.numpy as jnp

import bmsparse_tpu as bj
from bmsparse_tpu.format import bitmap as bm_j

import bmsparse_tpu_torch as bt
from bmsparse_tpu_torch.format import bitmap as bm_t

from conftest import random_coo
from test_torch_format import FIELDS, _assert_same_container, _port_arrays


def _jax_padded(m):
    out = {f: np.asarray(getattr(m, f)) for f in FIELDS}
    out["nb"] = int(m.nb)
    return out


CASES = {
    "square": ((96, 96), 0.08, 1),
    "wide": ((100, 264), 0.03, 2),
    "odd": ((333, 217), 0.03, 3),
}


def _coo(case):
    shape, density, seed = CASES[case]
    return (*random_coo(*shape, density=density, seed=seed), shape)


@pytest.mark.parametrize("mode", ["compact", "padded", "nb_pad"])
@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_device_converter_matches_jax(case, transposed, mode):
    r, c, v, shape = _coo(case)
    # the input in an order of its own: the converter sorts
    perm = np.random.default_rng(7).permutation(len(r))
    r, c, v = r[perm], c[perm], v[perm]
    kw = {"compact": mode != "padded"}
    if mode == "nb_pad":
        kw["nb_pad"] = len(r) - 3
    mj = bj.coo_to_bmsparse(r, c, v, shape, transposed=transposed, **kw)
    md = bt.coo_to_bmsparse(r, c, v, shape, transposed=transposed,
                            backend="device", device="cpu", **kw)
    mh = bt.coo_to_bmsparse(r, c, v, shape, transposed=transposed,
                            device="cpu")
    want = _jax_padded(mj)
    got = _port_arrays(md)
    assert int(got["nb"]) == want["nb"] == mh.nb
    assert isinstance(md.nb, int) == (mode != "padded")
    for f in FIELDS:
        assert got[f].dtype == want[f].dtype, f
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    host = _port_arrays(mh)
    nb = mh.nb
    for f in FIELDS:
        k = len(r) if f == "values" else nb
        np.testing.assert_array_equal(got[f][:k], host[f], err_msg=f)
    assert (md.nnz, md.shape, md.transposed) == (mj.nnz, mj.shape,
                                                 mj.transposed)
    # padding is an identity element: the same COO and the same SpMV
    for a, b in zip(md.generate_coo(), mh.generate_coo()):
        np.testing.assert_array_equal(a, b)
    if not transposed:
        x = torch.from_numpy(np.random.default_rng(3).standard_normal(
            shape[1]).astype(np.float32))
        assert torch.equal(bt.spmv(md, x), bt.spmv(mh, x))


def test_device_converter_empty_and_errors():
    e = np.empty(0, np.int32)
    mj = bj.coo_to_bmsparse(e, e, np.empty(0, np.float32), (20, 30))
    md = bt.coo_to_bmsparse(e, e, np.empty(0, np.float32), (20, 30),
                            backend="device", device="cpu")
    _assert_same_container(mj, md)
    r, c, v, shape = _coo("square")
    with pytest.raises(ValueError, match="duplicate"):
        bt.coo_to_bmsparse(np.r_[r, r[:2]], np.r_[c, c[:2]], np.r_[v, v[:2]],
                           shape, backend="device", device="cpu")
    with pytest.raises(ValueError, match="nb_pad"):
        bt.coo_to_bmsparse(r, c, v, shape, backend="device", device="cpu",
                           compact=False, nb_pad=len(r))
    with pytest.raises(ValueError, match="nb_pad"):
        bt.coo_to_bmsparse(r, c, v, shape, device="cpu", nb_pad=len(r))
    with pytest.raises(ValueError, match="backend"):
        bt.coo_to_bmsparse(r, c, v, shape, backend="xla", device="cpu")


def test_device_converter_tensor_inputs():
    """Tensors in (bf16 values included) give what numpy inputs give."""
    r, c, v, shape = _coo("odd")
    ref = bt.coo_to_bmsparse(r, c, v, shape, device="cpu").astype(
        torch.bfloat16)
    vt = torch.from_numpy(v).to(torch.bfloat16)
    for backend in ("host", "device"):
        m = bt.coo_to_bmsparse(torch.from_numpy(r), torch.from_numpy(c), vt,
                               shape, backend=backend, device="cpu")
        assert m.dtype == torch.bfloat16
        for f in FIELDS:
            a = getattr(m, f)[: ref.nb if f != "values" else m.nnz]
            assert torch.equal(a, getattr(ref, f)), (backend, f)


@pytest.mark.parametrize("out_layout", [None, False, True])
@pytest.mark.parametrize("transposed", [False, True])
def test_transpose_matches_jax(transposed, out_layout):
    r, c, v, shape = _coo("wide")
    mj = bj.coo_to_bmsparse(r, c, v, shape, transposed=transposed,
                            backend="host")
    mt = bt.coo_to_bmsparse(r, c, v, shape, transposed=transposed,
                            device="cpu")
    tj = bj.transpose(mj, transposed=out_layout)
    tt = bt.transpose(mt, transposed=out_layout)
    assert tt.shape == (shape[1], shape[0])
    _assert_same_container(tj, tt)
    # bf16 goes through float32 and comes back bitwise
    tb = bt.transpose(mt.astype(torch.bfloat16), transposed=out_layout)
    assert tb.dtype == torch.bfloat16
    assert torch.equal(tb.values, tt.values.to(torch.bfloat16))


def test_csr_matches_jax():
    r, c, v, shape = _coo("odd")
    s = sp.csr_matrix((v, (r, c)), shape=shape)
    cj = bj.CSRMatrix.from_scipy(s)
    ct = bt.CSRMatrix.from_scipy(s, device="cpu")
    assert (ct.nnz, ct.shape) == (cj.nnz, cj.shape)
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(ct, f).numpy(),
                                      np.asarray(getattr(cj, f)), err_msg=f)
    np.testing.assert_array_equal(ct.row_ids().numpy(),
                                  np.asarray(cj.row_ids()))
    assert (ct.to_scipy() != s).nnz == 0
    for tr in (False, True):
        for backend in ("device", "host"):
            _assert_same_container(
                bj.csr_to_bmsparse(cj, transposed=tr, backend=backend),
                bt.csr_to_bmsparse(ct, transposed=tr, backend=backend))
    mt = bt.coo_to_bmsparse(r, c, v, shape, device="cpu")
    back_t = bt.bmsparse_to_csr(mt)
    back_j = bj.bmsparse_to_csr(bj.coo_to_bmsparse(r, c, v, shape,
                                                   backend="host"))
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(back_t, f).numpy(),
                                      np.asarray(getattr(back_j, f)))
    back_b = bt.bmsparse_to_csr(mt.astype(torch.bfloat16))
    assert back_b.data.dtype == torch.bfloat16
    assert torch.equal(back_b.data, back_t.data.to(torch.bfloat16))
    x = np.random.default_rng(5).standard_normal(shape[1]).astype(np.float32)
    uj = np.asarray(bj.csr_spmv(cj, jnp.asarray(x)))
    ut = bt.csr_spmv(ct, torch.from_numpy(x))
    assert ut.dtype == torch.float32
    np.testing.assert_allclose(ut.numpy(), uj, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ut.numpy(), s @ x.astype(np.float64),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("transposed", [False, True])
def test_bitmap_helpers_match_jax(transposed):
    np.testing.assert_array_equal(bm_t.addr_grid(transposed),
                                  bm_j.addr_grid(transposed))
    ri, rj = np.divmod(np.arange(64, dtype=np.int32), 8)
    hj, lj = bm_j.coords_to_words(jnp.asarray(ri), jnp.asarray(rj),
                                  transposed)
    ht, lt = bm_t.coords_to_words(torch.from_numpy(ri), torch.from_numpy(rj),
                                  transposed)
    np.testing.assert_array_equal(bm_t.tensor_to_words_np(ht), np.asarray(hj))
    np.testing.assert_array_equal(bm_t.tensor_to_words_np(lt), np.asarray(lj))
    bits = np.random.default_rng(1).integers(0, 2, (5, 64), dtype=np.int32)
    np.testing.assert_array_equal(
        bm_t.bits_to_dense_bool(torch.from_numpy(bits), transposed).numpy(),
        np.asarray(bm_j.bits_to_dense_bool(jnp.asarray(bits), transposed)))


def test_container_helpers_match_jax():
    r, c, v, shape = _coo("square")
    for tr in (False, True):
        mj = bj.coo_to_bmsparse(r, c, v, shape, transposed=tr)
        mt = bt.coo_to_bmsparse(r, c, v, shape, transposed=tr,
                                backend="device", device="cpu")
        np.testing.assert_array_equal(mt.decompress_blocks().numpy(),
                                      np.asarray(mj.decompress_blocks()))
        np.testing.assert_array_equal(mt.valid_mask().numpy(),
                                      np.asarray(mj.valid_mask()))
        outs = []
        for m in (mj, mt):
            buf = io.StringIO()
            m.print_matrix(buf, max_entries=20)
            outs.append(buf.getvalue())
        assert outs[0] == outs[1] and "more)" in outs[0]
