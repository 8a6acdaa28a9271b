"""The port's user surfaces on the card: the device converter against the
host converter, container and plan persistence onto the card, CSR and
csr_spmv, the SpMV and SpGEMM CLIs with --device cuda (float64 too, which
impl="auto" runs on the plain path), float64 plans and operands under
impl="auto" and "cuda", and the scaling report's measured d = 1 row over
NCCL. Every case is marked
`gpu` and skips without a CUDA device; they import no JAX, so they run on
a machine without it:
    python -m pytest tests/test_torch_surfaces.py --noconftest -m gpu
"""

import contextlib
import io
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import bmsparse_tpu_torch as bt
from bmsparse_tpu_torch.io import binary
from bmsparse_tpu_torch.utils import testmats as tm

DATA = str(Path(__file__).resolve().parents[1] / "data" / "real")
FIELDS = ("brow", "bcol", "bmp_hi", "bmp_lo", "offsets")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _road(n=8192):
    return tm.roadnet(n, seed=3)


@pytest.mark.gpu
@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("compact", [True, False])
def test_device_converter_on_card(cuda, transposed, compact):
    r, c, v, shape = _road()
    mh = bt.coo_to_bmsparse(r, c, v, shape, transposed=transposed,
                            device="cpu")
    md = bt.coo_to_bmsparse(r, c, v, shape, transposed=transposed,
                            compact=compact, backend="device", device=cuda)
    assert md.values.is_cuda and isinstance(md.nb, int) == compact
    nb = int(md.nb)
    assert nb == mh.nb
    for f in FIELDS:
        assert torch.equal(getattr(md, f)[:nb].cpu(), getattr(mh, f)), f
    assert torch.equal(md.values.cpu(), mh.values)


@pytest.mark.gpu
def test_persistence_on_card(cuda, tmp_path):
    r, c, v, shape = _road()
    m = bt.coo_to_bmsparse(r, c, v, shape, device=cuda)
    bt.save_bmsparse(str(tmp_path / "m"), m)
    m2 = bt.load_bmsparse(str(tmp_path / "m"), device=cuda)
    for f in FIELDS + ("values",):
        assert torch.equal(getattr(m2, f), getattr(m, f)), f
    p = bt.prepare(m2, stream="off")
    binary.save_prepared(str(tmp_path / "p"), p)
    p2 = binary.load_prepared(str(tmp_path / "p"), m2)
    assert p2.m is m2 and p2.dia.is_cuda
    x = torch.randn(shape[1], device=cuda)
    assert torch.equal(bt.spmv(p, x), bt.spmv(p2, x))


@pytest.mark.gpu
def test_csr_spmv_on_card(cuda):
    import scipy.sparse as sp

    r, c, v, shape = _road()
    s = sp.csr_matrix((v, (r, c)), shape=shape)
    a = bt.CSRMatrix.from_scipy(s, device=cuda)
    x = np.random.default_rng(0).standard_normal(shape[1]).astype(np.float32)
    u = bt.csr_spmv(a, torch.from_numpy(x).to(cuda))
    np.testing.assert_allclose(u.cpu().numpy(), s @ x.astype(np.float64),
                               rtol=1e-5, atol=1e-5)
    m = bt.csr_to_bmsparse(a, backend="device")
    assert m.values.is_cuda
    back = bt.bmsparse_to_csr(m)
    for f in ("indptr", "indices", "data"):
        assert torch.equal(getattr(back, f), getattr(a, f)), f


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
def test_cli_spgemm_on_card(cuda, dtype):
    from bmsparse_tpu_torch.cli.spgemm import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main([DATA, "A_matrix", "B_matrix", "--check", "--dtype", dtype])
    out = buf.getvalue()
    assert rc == 0
    assert "C blocks: 9" in out and "C nnz: 255" in out
    assert float(re.search(r"Final: (\S+)", out).group(1)) < 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("impl", ["auto", "plain"])
def test_cli_spmv_float64_on_card(cuda, impl):
    """float64 under impl="auto" runs the plain path on the card (the
    kernels take float32 and bfloat16), as the JAX package runs XLA."""
    from bmsparse_tpu_torch.cli.spmv import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main([DATA, "A_matrix", "--check", "--dtype", "float64",
                   "--impl", impl])
    assert rc == 0
    assert float(re.search(r"Final: (\S+)", buf.getvalue()).group(1)) < 1e-12


@pytest.mark.gpu
def test_float64_auto_plain_and_cuda_raises_on_card(cuda):
    r, c, v, shape = _road()
    m = bt.coo_to_bmsparse(r, c, v.astype(np.float64), shape, device=cuda)
    p = bt.prepare(m)
    x = torch.ones(shape[1], dtype=torch.float64, device=cuda)
    ref = m.to_scipy() @ np.ones(shape[1])
    np.testing.assert_allclose(bt.spmv(p, x).cpu().numpy(), ref, rtol=1e-12,
                               atol=1e-12)
    with pytest.raises(NotImplementedError, match="float64"):
        bt.spmv(p, x, impl="cuda")
    mt = bt.coo_to_bmsparse(r, c, v.astype(np.float64), shape,
                            transposed=True, device=cuda)
    cm = bt.spgemm(m, mt)
    assert cm.values.dtype == torch.float64
    assert bt.mean_relative_error(cm, (m.to_scipy() @ mt.to_scipy()).tocsr()
                                  ) < 1e-12
    with pytest.raises(NotImplementedError, match="float64"):
        bt.spgemm(m, mt, impl="cuda")


@pytest.mark.gpu
def test_measured_row_on_the_card(cuda):
    """d = 1 over NCCL on the card: checked against scipy, timed by CUDA
    events; the model names this card."""
    from bmsparse_tpu_torch.cli import scaling

    mt = bt.coo_to_bmsparse(*scaling.synthetic("band", 65536), device="cpu")
    v = np.random.default_rng(1).standard_normal(65536).astype(np.float32)
    rep = scaling.build_report(mt, [1, 2], v, iters=3, device="cuda")
    ms = rep["spmv"][0]["measured"]
    assert ms["ok"] and ms["max_rel_err"] < 1e-4
    assert ms["backend"] == "nccl" and ms["seconds"] > 0
    assert ms["device"] == torch.cuda.get_device_name(0)
    assert rep["spgemm"][0]["d"] == 1 and rep["spgemm"][0]["measured"]["ok"]
    assert rep["model"]["card"] == torch.cuda.get_device_name(0)
    assert ("measured" in rep["spmv"][1]) == (torch.cuda.device_count() >= 2)
