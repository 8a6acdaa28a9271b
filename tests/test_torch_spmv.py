"""The SpMV slice of the PyTorch port as a whole, on the CPU, against the
JAX package: the port's spmv on the plan it builds and on the JAX plan
carried across (interop.prepared_from_numpy), against the JAX spmv with
impl="pallas" (Pallas kernels in interpret mode) and impl="xla" at
rtol = atol = 1e-5 (only the order of the float32 sums differs), and
against the scipy float64 oracle at rtol 1e-4, atol 1e-5 (the JAX suite's
own tolerance). Also the raw-container path, the CLI, the errors of what
is not ported, and the rule that the port never imports JAX."""

import dataclasses
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

import bmsparse_tpu as bj
from bmsparse_tpu.ops import spmv as spmv_j
from bmsparse_tpu.ops.plan import prepare as prepare_j

import bmsparse_tpu_torch as bt
from bmsparse_tpu_torch.interop import prepared_from_numpy
from bmsparse_tpu_torch.ops.cuda.sell_gather_kernel import sell_gather_plain
from bmsparse_tpu_torch.ops.plan import prepare as prepare_t
from bmsparse_tpu_torch.ops.spmv import sell_apply
from bmsparse_tpu_torch.oracle.scipy_oracle import oracle_spmv
from bmsparse_tpu_torch.utils import testmats as tm
from bmsparse_tpu_torch.utils.testmats import make_stencil

from conftest import data_path, random_coo
from test_pallas_sell import _clustered_coo, _road_like_coo
from test_torch_kernels import _expand, _kronecker, _same_bits
from test_torch_plan import jax_plan_arrays

REPO = Path(__file__).resolve().parents[1]
PARITY = dict(rtol=1e-5, atol=1e-5)
ORACLE = dict(rtol=1e-4, atol=1e-5)


def _ragusa():
    r, c, v, shape = bt.read_matrix_market(data_path("A_matrix.mtx"))
    return r, c, v, shape


# name -> triplets. roadnet(65536) runs every tier of the main path at a
# small size: DIA, windowed and gathered SELL groups, overflow. The
# road-like case needs n > 8192 for overflow (its rows' far links must
# leave a 128-unit window of 64-column units).
CASES = {
    "ragusa16": _ragusa,
    "stencil": lambda: (*make_stencil(4096, 4, seed=1), (4096, 4096)),
    "clustered": lambda: (*_clustered_coo(4096, 6, 48, 31), (4096, 4096)),
    "random": lambda: (*random_coo(2048, 2048, density=4 / 2048, seed=3),
                       (2048, 2048)),
    "road_like": lambda: (*_road_like_coo(12288, seed=11), (12288, 12288)),
    "roadnet": lambda: tm.roadnet(65536, seed=8),
}


def _v(n, seed=0):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


@pytest.mark.parametrize("name", sorted(CASES))
def test_spmv_matches_jax_and_oracle(name):
    r, c, vals, shape = CASES[name]()
    mj = bj.coo_to_bmsparse(r, c, vals, shape, backend="host")
    mt = bt.coo_to_bmsparse(r, c, vals, shape, device="cpu")
    pj = prepare_j(mj, stream="off")
    pt = prepare_t(mt, stream="off")
    v = _v(shape[1])
    u_pallas = np.asarray(bj.spmv(pj, jnp.asarray(v), impl="pallas"))
    u_xla = np.asarray(bj.spmv(pj, jnp.asarray(v), impl="xla"))
    ref = oracle_spmv(mt, v.astype(np.float64))
    for p in (pt, prepared_from_numpy(mt, jax_plan_arrays(pj))):
        for impl in ("auto", "plain"):
            u = bt.spmv(p, torch.from_numpy(v), impl=impl)
            assert u.dtype == torch.float32 and u.shape == (shape[0],)
            np.testing.assert_allclose(u.numpy(), u_pallas, **PARITY)
            np.testing.assert_allclose(u.numpy(), u_xla, **PARITY)
            np.testing.assert_allclose(u.numpy(), ref, **ORACLE)


def test_main_path_tiers_all_run():
    """The roadnet case reaches every tier, so the test above covers the
    whole tiered path."""
    r, c, vals, shape = CASES["roadnet"]()
    p = prepare_t(bt.coo_to_bmsparse(r, c, vals, shape, device="cpu"),
                  stream="off")
    windowed = [pk is not None for pk in p.sell_pack]
    assert p.dia is not None and any(windowed) and not all(windowed)
    assert p.ovf_ks


@pytest.mark.parametrize("name", ["road_like", "roadnet"])
def test_road_packs_and_spmv_match_jax(name):
    """On road-like matrices the routing is the JAX package's (K-groups,
    chunk counts, windows, row map), each windowed group's pack expands to
    the JAX plan's slab bit for bit and equals the pack built from the
    JAX plan carried across, and spmv equals the JAX package's to 1e-5
    relative."""
    r, c, vals, shape = CASES[name]()
    mj = bj.coo_to_bmsparse(r, c, vals, shape, backend="host")
    mt = bt.coo_to_bmsparse(r, c, vals, shape, device="cpu")
    pj = prepare_j(mj, stream="off")
    pt = prepare_t(mt, stream="off")
    assert pt.sell_ks == tuple(pj.sell_ks)
    assert pt.sell_chunks == tuple(d.shape[1] for d in pj.sell_dense)
    np.testing.assert_array_equal(pt.out_gather.numpy(),
                                  np.asarray(pj.out_gather))
    for g, pk in enumerate(pt.sell_pack):
        assert (pk is None) == (pj.sell_rel[g] is None)
        if pk is not None:
            np.testing.assert_array_equal(pk.ws.numpy(),
                                          np.asarray(pj.sell_ws[g]))
    carried = prepared_from_numpy(mt, jax_plan_arrays(pj))
    windowed = [g for g, pk in enumerate(pt.sell_pack) if pk is not None]
    assert windowed and all(pt.sell_pack[g].cw == 64 for g in windowed)
    for g in windowed:
        pk = pt.sell_pack[g]
        _same_bits(_expand(pk, np.asarray(pj.sell_rel[g]), pt.sell_ks[g]),
                   torch.from_numpy(np.array(pj.sell_dense[g])))
        for f in pk.TENSORS:
            assert torch.equal(getattr(pk, f),
                               getattr(carried.sell_pack[g], f)), f
        assert pk.vals.numel() <= 1.5 * pk.nnz
    v = _v(shape[1])
    want = np.asarray(bj.spmv(pj, jnp.asarray(v), impl="pallas"))
    for p in (pt, carried):
        u = bt.spmv(p, torch.from_numpy(v)).numpy()
        assert np.abs(u - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("name", ["clustered", "roadnet"])
def test_bf16_plan_matches_jax(name):
    r, c, vals, shape = CASES[name]()
    mj = bj.coo_to_bmsparse(r, c, vals, shape, backend="host")
    mt = bt.coo_to_bmsparse(r, c, vals, shape, device="cpu")
    pj = prepare_j(mj, dtype=jnp.bfloat16, stream="off")
    pt = prepare_t(mt, dtype=torch.bfloat16)
    assert any(pk is not None for pk in pt.sell_pack)
    v = _v(shape[1])
    u = bt.spmv(pt, torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(
        u, np.asarray(bj.spmv(pj, jnp.asarray(v), impl="pallas")), **PARITY)
    np.testing.assert_allclose(
        u, np.asarray(bj.spmv(pj, jnp.asarray(v), impl="xla")), **PARITY)
    # the oracle sees the values the plan holds: rounded to bfloat16
    ref = mt.astype(torch.bfloat16).to_scipy() @ v.astype(np.float64)
    np.testing.assert_allclose(u, ref, **ORACLE)


def _scattered_scalar_rows(n=4096, seed=6):
    """Scalar rows 1 and 6 of every block row, 40 scattered entries each:
    block rows with empty scalar rows, and no column window."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n)[np.isin(np.arange(n) % 8, (1, 6))], 40)
    key = np.unique(rows.astype(np.int64) * n + rng.integers(0, n, len(rows)))
    r, c = np.divmod(key, n)
    vals = rng.standard_normal(len(r)).astype(np.float32)
    return r.astype(np.int32), c.astype(np.int32), vals, (n, n)


# name -> (triplets, prepare's arguments): plans whose SELL tiers have
# groups without a window plan, read from the tier's GatherPack
GATHER_CASES = {
    # hub rows on the SELL tier (cw = 8), the rest on the stream tier, as
    # in the PageRank cell; vertex 0's row has 2,500 entries: 3 segments
    "power_law": lambda: (_kronecker(12, seed=2, hub=2500),
                          dict(stream="force")),
    "empty_scalar_rows": lambda: (_scattered_scalar_rows(),
                                  dict(stream="off")),
    "road_overflow": lambda: (
        (*_road_like_coo(12288, seed=11), (12288, 12288)),
        dict(stream="off")),
    # n = 32,768: hub rows span more than a column window
    "bf16": lambda: (_kronecker(15, edgefactor=4, seed=2, hub=2500),
                     dict(dtype=torch.bfloat16)),
}


def _gather_plan(name):
    """The port's plan of a GATHER_CASES case and the JAX package's."""
    (r, c, vals, shape), kw = GATHER_CASES[name]()
    m = bt.coo_to_bmsparse(r, c, vals, shape, device="cpu")
    p = prepare_t(m, **kw)
    kw_j = dict(kw, dtype=getattr(jnp, str(kw.get("dtype", torch.float32))
                                  .removeprefix("torch.")))
    pj = prepare_j(bj.coo_to_bmsparse(r, c, vals, shape, backend="host"),
                   **kw_j)
    if name == "power_law":
        assert p.stream is not None
        assert np.diff(p.sell_gpack.row_seg.numpy()).max() >= 3
    if name == "road_overflow":
        assert p.ovf_gpack is not None
        assert any(pk is not None for pk in p.sell_pack)
    if name == "bf16":
        assert p.sell_gpack.vals.dtype == torch.bfloat16
    return m, p, pj


def _tiers(p, pj):
    """Each SELL tier of plan p with a gathered pack: (chunks, out_gather,
    windowed packs, gathered pack, rows) beside the JAX plan pj's
    (slabs, column arrays, out_gather) of the same tier."""
    return [t for t in (
        (p.sell_chunks, p.out_gather, p.sell_pack, p.sell_gpack,
         p.sell_rows, pj.sell_dense, pj.sell_bcol, pj.out_gather),
        (p.ovf_chunks, p.ovf_gather, (), p.ovf_gpack, p.ovf_rows,
         pj.ovf_dense, pj.ovf_bcol, pj.ovf_gather),
    ) if t[3] is not None]


def _stacked(chunks, groups):
    """The stacked scalar rows of `groups` of a tier."""
    bases = np.cumsum([0] + [c * 128 for c in chunks])
    return np.concatenate([np.arange(bases[g] * 8, bases[g + 1] * 8)
                           for g in groups] + [np.zeros(0, np.int64)])


def _gathered(chunks, packs):
    return [g for g in range(len(chunks))
            if g >= len(packs) or packs[g] is None]


@pytest.mark.parametrize("name", sorted(GATHER_CASES))
def test_gathered_pack_matches_slab_gather(name):
    """sell_apply on the tiers' packs (sell_window_plain and
    sell_gather_plain) equals the JAX package's sell_apply over its slabs
    (XLA's per-slot gather), and sell_gather_plain writes the gathered
    groups' rows and the zero row and nothing else; spmv meets the
    oracle."""
    m, p, pj = _gather_plan(name)
    n = p.block_cols * 8
    v = _v(m.num_cols)
    vpad = torch.zeros(n)
    vpad[: m.num_cols] = torch.from_numpy(v)
    tiers = _tiers(p, pj)
    assert tiers
    for chunks, og, packs, gk, rows_total, dense, bcol, og_j in tiers:
        got = sell_apply(chunks, og, vpad, packs=packs, gpack=gk)
        want = np.asarray(spmv_j.sell_apply(
            dense, bcol, og_j, jnp.asarray(vpad.numpy()), p.block_cols))
        np.testing.assert_allclose(got.numpy(), want, **PARITY)
        out = torch.full(((rows_total + 1) * 8,), float("nan"))
        sell_gather_plain(gk, vpad, n, out)
        written = np.zeros(out.numel(), bool)
        written[_stacked(chunks, _gathered(chunks, packs))] = True
        written[rows_total * 8:] = True
        assert out[torch.from_numpy(~written)].isnan().all()
        assert not out[torch.from_numpy(written)].isnan().any()
        assert not out[rows_total * 8:].any()
    ref = m.astype(torch.bfloat16).to_scipy() if name == "bf16" else \
        m.to_scipy()
    u = bt.spmv(p, torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(u, ref @ v.astype(np.float64), **ORACLE)


@pytest.mark.parametrize("name", sorted(GATHER_CASES))
def test_gathered_pack_expands_to_slab(name):
    """Each tier's gathered pack holds the nonzeros of the JAX plan's
    slabs of its groups without a window, bit for bit, sorted by (row,
    column), and its rows are exactly those groups' stacked rows and the
    zero row."""
    m, p, pj = _gather_plan(name)
    for chunks, og, packs, gk, rows_total, dense, bcol, _ in _tiers(p, pj):
        dense = [torch.from_numpy(np.array(d).view(np.int16)).view(
            torch.bfloat16) if np.asarray(d).dtype.name == "bfloat16"
            else torch.from_numpy(np.array(d)) for d in dense]
        gathered = _gathered(chunks, packs)
        want_rows = np.r_[_stacked(chunks, gathered),
                          np.arange(rows_total * 8, rows_total * 8 + 8)]
        np.testing.assert_array_equal(gk.rows.numpy(), want_rows)
        seg_rows = np.repeat(np.arange(gk.rows.shape[0]),
                             np.diff(gk.row_seg.numpy()))
        row = np.repeat(seg_rows, np.diff(gk.seg_off.numpy()))
        col = gk.cols[:gk.nnz].numpy().astype(np.int64)
        assert (np.diff(row * m.num_cols + col) > 0).all()
        st = gk.rows.numpy().astype(np.int64)[row]
        brow, i = np.divmod(st, 8)
        bases = np.cumsum([0] + [c * 128 for c in chunks])
        grp = np.searchsorted(bases, brow, "right") - 1
        cw = dense[0].shape[0]
        vals = gk.vals[:gk.nnz]
        for g in gathered:
            sel = grp == g
            c, lane = np.divmod(brow[sel] - bases[g], 128)
            u, w = np.divmod(col[sel], cw)
            cap, kg = dense[g].shape[1:3]
            b = np.asarray(bcol[g]).reshape(cap, kg, 128)
            k = np.argmax(b[c, :, lane] == u[:, None], axis=1)
            assert (b[c, k, lane] == u).all()
            slab = torch.zeros_like(dense[g])
            idx = tuple(torch.from_numpy(x) for x in (w, c, k, i[sel], lane))
            slab[idx] = vals[torch.from_numpy(np.nonzero(sel)[0])]
            _same_bits(slab, dense[g])


def _tier_tensors(p):
    """(name, tensor) of every tensor of the plan's SELL and overflow
    tiers, their packs' fields included: every field of the plan but the
    container, the DIA and stream tiers."""
    for f in dataclasses.fields(p):
        if f.name in ("m", "dense_flat_", "dia", "stream"):
            continue
        x = getattr(p, f.name)
        for y in x if isinstance(x, tuple) else (x,):
            if isinstance(y, torch.Tensor):
                yield f.name, y
            elif hasattr(y, "TENSORS"):
                yield from ((k, getattr(y, k)) for k in y.TENSORS)


# the tiers' row maps: the plan's and the packs' row, segment and window
# tables (everything but the entries' values and columns)
ROW_MAPS = ("out_gather", "ovf_gather", "rows", "seg_off", "row_seg",
            "slice_off", "ws")
NO_SLAB_CASES = {
    "road_overflow": lambda: GATHER_CASES["road_overflow"]()[0],
    "webgraph": lambda: tm.webgraph(16384, 8, seed=9),
}


@pytest.mark.parametrize("name", sorted(NO_SLAB_CASES))
def test_sell_tiers_hold_no_slab(name):
    """The SELL and overflow tiers hold their nonzeros once and their row
    maps, and no dense slab: their tensors' bytes stay under 1.5 x (the
    tiers' nonzeros) x (itemsize + 4), plus the row maps' bytes."""
    r, c, vals, shape = NO_SLAB_CASES[name]()
    m = bt.coo_to_bmsparse(r, c, vals, shape, device="cpu")
    p = prepare_t(m, stream="off")
    packs = [pk for pk in (*p.sell_pack, p.sell_gpack, p.ovf_gpack)
             if pk is not None]
    nnz = sum(pk.nnz for pk in packs)
    assert 0 < nnz <= m.nnz and p.sell_ks
    total = maps = 0
    for f, t in _tier_tensors(p):
        b = t.numel() * t.element_size()
        total += b
        maps += b if f in ROW_MAPS else 0
    itemsize = getattr(torch, p.plan_dtype).itemsize
    assert total <= 1.5 * nnz * (itemsize + 4) + maps, (total, nnz, maps)


@pytest.mark.parametrize("shape,density", [((24, 24), 0.15), ((64, 64), 0.1),
                                           ((100, 52), 0.07),
                                           ((333, 217), 0.03)])
def test_raw_container_path_matches_jax(shape, density):
    r, c, vals = random_coo(*shape, density=density, seed=sum(shape))
    mj = bj.coo_to_bmsparse(r, c, vals, shape)
    mt = bt.coo_to_bmsparse(r, c, vals, shape, device="cpu")
    v = _v(shape[1], seed=1)
    want = np.asarray(bj.spmv(mj, jnp.asarray(v)))
    ref = mt.to_scipy() @ v.astype(np.float64)
    for m in (mt, mt.pad_to(mt.nb_pad + 33, mt.nnz_pad + 8)):
        u = bt.spmv(m, torch.from_numpy(v)).numpy()
        np.testing.assert_allclose(u, want, **PARITY)
        np.testing.assert_allclose(u, ref, **ORACLE)


def test_float64_plan_runs_plain_on_cpu():
    r, c, vals = _clustered_coo(1024, 4, 20, 9)
    mt = bt.coo_to_bmsparse(r, c, vals.astype(np.float64), (1024, 1024),
                            device="cpu")
    p = prepare_t(mt)
    assert p.plan_dtype == "float64"
    assert all(pk is None for pk in p.sell_pack)
    v = torch.from_numpy(_v(1024).astype(np.float64))
    u = bt.spmv(p, v)
    assert u.dtype == torch.float64
    np.testing.assert_allclose(u.numpy(), mt.to_scipy() @ v.numpy(),
                               rtol=1e-12, atol=1e-12)


def test_errors():
    r, c, vals = random_coo(64, 64, density=0.1, seed=4)
    mt = bt.coo_to_bmsparse(r, c, vals, (64, 64), device="cpu")
    p = prepare_t(mt)
    v = torch.ones(64)
    with pytest.raises(ValueError, match="CUDA"):
        bt.spmv(p, v, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        bt.spmv(mt, v, impl="cuda")
    with pytest.raises(ValueError, match="impl"):
        bt.spmv(p, v, impl="pallas")
    with pytest.raises(ValueError, match="shape"):
        bt.spmv(p, torch.ones(65))
    with pytest.raises(ValueError, match="untransposed"):
        bt.spmv(bt.coo_to_bmsparse(r, c, vals, (64, 64), transposed=True,
                                   device="cpu"), v)
    with pytest.raises(ValueError, match="stream"):
        prepare_t(mt, stream="on")
    with pytest.raises(ValueError, match="backend"):
        bt.coo_to_bmsparse(r, c, vals, (64, 64), backend="xla", device="cpu")
    with pytest.raises(ValueError, match="duplicate"):
        bt.coo_to_bmsparse(np.r_[r, r[:1]], np.r_[c, c[:1]],
                           np.r_[vals, vals[:1]], (64, 64),
                           backend="device", device="cpu")


def test_empty_and_tiny():
    e = np.empty(0, np.int32)
    u = bt.spmv(prepare_t(bt.coo_to_bmsparse(
        e, e, np.empty(0, np.float32), (16, 16), device="cpu")),
        torch.ones(16))
    assert u.shape == (16,) and not u.any()
    b = bt.coo_to_bmsparse(np.zeros(5, np.int32),
                           np.arange(5, dtype=np.int32) * 7,
                           np.ones(5, np.float32), (1, 40), device="cpu")
    for m in (b, prepare_t(b)):
        u = bt.spmv(m, torch.ones(40))
        assert u.shape == (1,) and u.item() == 5.0


def _run(args, **kw):
    return subprocess.run([sys.executable, *args], cwd=REPO,
                          capture_output=True, text=True, timeout=120, **kw)


def test_cli_spmv_cpu():
    res = _run(["-m", "bmsparse_tpu_torch.cli.spmv", "data/real",
                "A_matrix", "--check", "--device", "cpu"])
    assert res.returncode == 0, res.stderr
    out = res.stdout
    for label in ("Parsing data:", "Execution plan:",
                  "bmSparse SpMV execution:"):
        assert label in out
    err = float(re.search(r"Final: (\S+)", out).group(1))
    assert err < 1e-6


def test_cli_spmv_cuda_without_card_is_an_error():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = _run(["-m", "bmsparse_tpu_torch.cli.spmv", "data/real",
                "A_matrix", "--device", "cuda"])
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import bmsparse_tpu_torch, bmsparse_tpu_torch.interop\n"
        "import bmsparse_tpu_torch.cli.spmv, bmsparse_tpu_torch.ops.cuda.build\n"
        "import bmsparse_tpu_torch.utils.timing, bmsparse_tpu_torch.utils.roofline\n"
        "import bmsparse_tpu_torch.oracle.scipy_oracle\n"
        "import bmsparse_tpu_torch.io.binary, bmsparse_tpu_torch.io._native\n"
        "import bmsparse_tpu_torch.cli.spgemm, bmsparse_tpu_torch.cli.batch\n"
        "import bmsparse_tpu_torch.examples.cg\n"
        "import bmsparse_tpu_torch.examples.matrix_powers\n"
        "import bmsparse_tpu_torch.parallel.mesh, bmsparse_tpu_torch.parallel.launch\n"
        "import bmsparse_tpu_torch.parallel.partition, bmsparse_tpu_torch.parallel.plan\n"
        "import bmsparse_tpu_torch.parallel.spmv, bmsparse_tpu_torch.parallel.spgemm\n"
        "import bmsparse_tpu_torch.parallel.product, bmsparse_tpu_torch.parallel.dryrun\n"
        "import bmsparse_tpu_torch.cli.scaling\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'bmsparse_tpu' or m.startswith('bmsparse_tpu.')]\n"
        "assert not bad, bad\n"
    )
    res = _run(["-c", code])
    assert res.returncode == 0, res.stderr
    pat = re.compile(r"^\s*(import jax|from jax|import bmsparse_tpu\b(?!_)"
                     r"|from bmsparse_tpu\b(?!_))", re.M)
    paths = [*(REPO / "bmsparse_tpu_torch").rglob("*.py"),
             REPO / "chip_smoke.py"]
    for path in paths:
        assert not pat.search(path.read_text()), path
