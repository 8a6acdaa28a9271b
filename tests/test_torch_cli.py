"""The PyTorch port's MatrixMarket layer and reference command lines on the CPU:
the native parser (csrc/mmparse.cpp, built with g++ at first use) against
scipy on the repo's files and on symmetric, pattern and skew-symmetric
ones, its errors on garbage and missing files and on a failed build;
write_matrix_market; mmread_bmsparse's converter keywords against the JAX
package's; cli.spgemm against the JAX CLI on data/real A*B (the same
"C blocks" and "C nnz", "Final" below 1e-5); cli.batch for both
operations, a bad matrix included; and --device cuda without a card."""

import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.io
import scipy.sparse as sp

torch = pytest.importorskip("torch")

import bmsparse_tpu as bj

import bmsparse_tpu_torch as bt
from bmsparse_tpu_torch.io import _native
from bmsparse_tpu_torch.io.matrix_market import (
    read_matrix_market, write_matrix_market,
)

from test_torch_format import _assert_same_container

REPO = Path(__file__).resolve().parents[1]
DATA = str(REPO / "data" / "real")


def _sorted(r, c, v):
    k = np.lexsort((c, r))
    return r[k], c[k], v[k]


# ---------------------------------------------------------------------------
# native parser
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["A_matrix", "B_matrix"])
def test_native_parser_matches_scipy(name):
    path = os.path.join(DATA, name + ".mtx")
    r1, c1, v1, s1 = read_matrix_market(path, native=True)
    r2, c2, v2, s2 = read_matrix_market(path, native=False)
    assert s1 == s2
    assert r1.dtype == r2.dtype == np.int32 and v1.dtype == np.float32
    for a, b in zip(_sorted(r1, c1, v1), _sorted(r2, c2, v2)):
        np.testing.assert_array_equal(a, b)


def test_native_parser_symmetric_pattern_skew(tmp_path):
    m = sp.random(40, 40, 0.08, random_state=0)
    m = (m + m.T).tocoo()
    p = tmp_path / "sym.mtx"
    scipy.io.mmwrite(str(p), m, symmetry="symmetric")
    r, c, v, s = read_matrix_market(str(p), native=True)
    np.testing.assert_allclose(
        sp.coo_matrix((v, (r, c)), shape=s).toarray(), m.toarray(),
        rtol=1e-6)
    rs, cs, vs, _ = read_matrix_market(str(p), native=False)
    for a, b in zip(_sorted(r, c, v), _sorted(rs, cs, vs)):
        np.testing.assert_array_equal(a, b)

    p = tmp_path / "pat.mtx"
    p.write_text("%%MatrixMarket matrix coordinate pattern general\n"
                 "3 3 2\n1 2\n3 3\n")
    r, c, v, s = read_matrix_market(str(p), native=True)
    assert list(v) == [1.0, 1.0] and s == (3, 3)
    assert list(r) == [0, 2] and list(c) == [1, 2]

    p = tmp_path / "skew.mtx"
    p.write_text("%%MatrixMarket matrix coordinate real skew-symmetric\n"
                 "3 3 2\n2 1 5.0\n3 2 -1.5\n")
    r, c, v, s = read_matrix_market(str(p), native=True)
    a = sp.coo_matrix((v, (r, c)), shape=s).toarray()
    np.testing.assert_allclose(a, -a.T)
    np.testing.assert_allclose(a, sp.coo_matrix(
        scipy.io.mmread(str(p))).toarray())


def test_native_parser_rejects_garbage(tmp_path):
    p = tmp_path / "bad.mtx"
    p.write_text("not a matrix market file\n")
    with pytest.raises(ValueError):
        read_matrix_market(str(p), native=True)
    with pytest.raises(FileNotFoundError):
        read_matrix_market(str(tmp_path / "missing_file"), native=True)


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """native=True never falls back to scipy: a failed build raises with
    the compiler's output."""
    src = tmp_path / "mmparse.cpp"
    src.write_text("#error deliberately broken\n")
    monkeypatch.setattr(_native, "SOURCE", src)
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_native, "_module", None)
    with pytest.raises(RuntimeError, match="deliberately broken"):
        read_matrix_market(os.path.join(DATA, "A_matrix.mtx"), native=True)
    assert not list((tmp_path / "build").glob("*"))


def test_native_build_is_cached():
    so = _native.build()
    assert so.exists() and so.parent == _native.BUILD_DIR
    assert _native.build() == so
    assert _native.load_mmparse() is _native.load_mmparse()


def test_write_matrix_market_roundtrip(tmp_path):
    r, c, v, s = read_matrix_market(os.path.join(DATA, "A_matrix.mtx"))
    path = str(tmp_path / "w.mtx")
    write_matrix_market(path, r, c, v, s)
    for native in (True, False):
        r2, c2, v2, s2 = read_matrix_market(str(tmp_path / "w"),
                                            native=native)
        assert s2 == s
        for a, b in zip(_sorted(r, c, v), _sorted(r2, c2, v2)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kw", [{}, {"backend": "device"},
                                {"backend": "device", "compact": False},
                                {"backend": "host", "compact": False}])
@pytest.mark.parametrize("transposed", [False, True])
def test_mmread_convert_kw_matches_jax(kw, transposed):
    path = os.path.join(DATA, "B_matrix.mtx")
    mj = bj.mmread_bmsparse(path, transposed=transposed, **kw)
    mt = bt.mmread_bmsparse(path, transposed=transposed, device="cpu", **kw)
    if not kw.get("compact", True) and kw.get("backend") == "device":
        mt = dataclasses.replace(mt, nb=int(mt.nb))
    _assert_same_container(mj, mt)


def test_helpers_match_jax():
    from bmsparse_tpu.oracle import scipy_oracle as so_j
    from bmsparse_tpu.utils import roofline as rl_j

    from bmsparse_tpu_torch.oracle import scipy_oracle as so_t
    from bmsparse_tpu_torch.utils import roofline as rl_t
    from bmsparse_tpu_torch.utils.timing import sync

    for nnz, vb in ((0, 4), (12345, 4), (777, 2)):
        assert (rl_t.spmv_min_bytes_values_only(nnz, vb)
                == rl_j.spmv_min_bytes_values_only(nnz, vb))
    a = bt.mmread_bmsparse(os.path.join(DATA, "A_matrix"), device="cpu")
    b = bt.mmread_bmsparse(os.path.join(DATA, "B_matrix"), transposed=True,
                           device="cpu")
    aj = bj.mmread_bmsparse(os.path.join(DATA, "A_matrix"))
    bj_ = bj.mmread_bmsparse(os.path.join(DATA, "B_matrix"), transposed=True)
    np.testing.assert_array_equal(so_t.dense_oracle_spgemm(a, b),
                                  so_j.dense_oracle_spgemm(aj, bj_))
    assert sync(a) is a and sync(None) is None


# ---------------------------------------------------------------------------
# command lines
# ---------------------------------------------------------------------------
def _blocks_nnz(out):
    return (re.search(r"^C blocks: .*$", out, re.M).group(0),
            re.search(r"^C nnz: .*$", out, re.M).group(0))


def _final(out):
    return float(re.search(r"Final: (\S+)", out).group(1))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cli_spgemm_matches_jax(capsys, dtype):
    from bmsparse_tpu.cli.spgemm import main as main_j

    from bmsparse_tpu_torch.cli.spgemm import main as main_t

    argv = [DATA, "A_matrix", "B_matrix", "0", "5", "0", "--check",
            "--dtype", dtype]
    assert main_j(argv) == 0
    out_j = capsys.readouterr().out
    assert main_t(argv + ["--device", "cpu"]) == 0
    out_t = capsys.readouterr().out
    for label in ("Parsing data:", "bmSparse execution:"):
        assert re.search(rf"^{label} \d+$", out_t, re.M), label
    assert _blocks_nnz(out_t) == _blocks_nnz(out_j) == ("C blocks: 9",
                                                        "C nnz: 255")
    assert _final(out_t) < 1e-5


def test_cli_spgemm_impl_plain(capsys):
    from bmsparse_tpu_torch.cli.spgemm import main

    assert main([DATA, "A_matrix", "A_matrix", "--impl", "plain",
                 "--dtype", "float32", "--check", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert _final(out) < 1e-5


@pytest.mark.parametrize("op", ["spgemm", "spmv"])
def test_cli_batch(tmp_path, op):
    from bmsparse_tpu_torch.cli.batch import main

    lst = tmp_path / "list.txt"
    lst.write_text("# the two test matrices\nA_matrix\nB_matrix\n")
    out_file = tmp_path / "out.txt"
    rc = main([op, DATA, str(lst), str(out_file),
               "--args", "--device cpu --check"])
    assert rc == 0
    text = out_file.read_text()
    assert "==== A_matrix ====" in text and "==== B_matrix ====" in text
    label = ("bmSparse execution:" if op == "spgemm"
             else "bmSparse SpMV execution:")
    assert text.count(label) == 2 and text.count("rc=0)") == 2
    assert all(float(x) < 1e-5 for x in re.findall(r"Final: (\S+)", text))


def test_cli_batch_survives_bad_matrix(tmp_path):
    from bmsparse_tpu_torch.cli.batch import main

    lst = tmp_path / "list.txt"
    lst.write_text("A_matrix\nno_such_matrix\n")
    out_file = tmp_path / "out.txt"
    rc = main(["spmv", DATA, str(lst), str(out_file),
               "--args", "--device cpu"])
    assert rc == 1
    text = out_file.read_text()
    assert "==== A_matrix ====" in text and "ERROR:" in text
    assert "rc=0)" in text and "rc=1)" in text


def _run(args):
    return subprocess.run([sys.executable, *args], cwd=REPO,
                          capture_output=True, text=True, timeout=120)


@pytest.mark.parametrize("module,argv", [
    ("cli.spgemm", ["data/real", "A_matrix", "B_matrix"]),
    ("examples.cg", ["64", "2"]),
    ("examples.matrix_powers", ["64", "2"]),
    ("examples.amg_setup", ["12", "3", "1"]),
])
def test_cuda_without_card_is_an_error(module, argv):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = _run(["-m", f"bmsparse_tpu_torch.{module}", *argv,
                "--device", "cuda"])
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr
