"""The scaling report of the PyTorch port (bmsparse_tpu_torch/cli/scaling.py)
against the JAX package's (bmsparse_tpu/cli/scaling.py), on the CPU.

The same numpy inputs go to both `build_report`s (JAX with run_sim=False
on this process's 8-device CPU mesh; the port with device="cpu" and no
ranks): the plan-time quantities — exchange choice, halo or all-gather
bytes per GPU, the product's max_send and byte counts — are equal at d =
1, 2, 4, 8 on a band, a stencil and a hub matrix that takes the
all-gather fallbacks; the projected times follow the H100 constants
(compute_s is JAX's times 819 / 3350, the link terms the port's bytes
over 450 GB/s) to rtol 1e-12. Measured entries come from one spawned gloo
world of 2 ranks (the card's measured d = 1 row is a `gpu` case of
tests/test_torch_surfaces.py, which runs where JAX is not installed).
"""

import contextlib
import io
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

import bmsparse_tpu as bj
from bmsparse_tpu.cli import scaling as scaling_j
from bmsparse_tpu.parallel.mesh import make_mesh as make_mesh_j
from bmsparse_tpu.parallel.partition import partition as partition_j

import bmsparse_tpu_torch as bt
from bmsparse_tpu_torch.cli import scaling

from conftest import random_coo

SIZES = [1, 2, 4, 8]
JAX_HBM, JAX_ICI = 819.0, 90.0     # the JAX package's v5e constants
H100_HBM, NVLINK, NET = 3350.0, 450.0, 50.0
RTOL = dict(rtol=1e-12, atol=0)


def _hubs():
    """Dense rows every 64 rows: no shard's window fits a halo, and the
    product's padded selective exchange exceeds the all-gather at d = 8."""
    n = 512
    dense_rows = np.arange(0, n, 64)
    r = np.concatenate([np.full((n,), dr) for dr in dense_rows]
                       + [np.arange(n)])
    c = np.concatenate([np.arange(n)] * len(dense_rows) + [np.arange(n)])
    key = np.unique(r.astype(np.int64) * n + c)
    rows, cols = np.divmod(key, n)
    vals = np.random.default_rng(77).standard_normal(
        len(rows)).astype(np.float32)
    return rows.astype(np.int32), cols.astype(np.int32), vals, (n, n)


CASES = {
    "band": lambda: scaling.synthetic("band", 2048),
    "stencil": lambda: scaling.synthetic("stencil", 2048),
    "hubs": _hubs,
}


def _both(case):
    r, c, v, shape = case
    mj = bj.coo_to_bmsparse(r, c, v, shape, backend="host")
    mt = bt.coo_to_bmsparse(r, c, v, shape, backend="host", device="cpu")
    vec = np.random.default_rng(1).standard_normal(shape[1]).astype(
        np.float32)
    return mj, mt, vec


@pytest.fixture(scope="module")
def reports():
    """Both packages' reports per case, at d = 1, 2, 4, 8 (and the port's
    multi-node rows at d = 16 on the band)."""
    out = {}
    for name, make in CASES.items():
        mj, mt, v = _both(make())
        rj = scaling_j.build_report(mj, SIZES, jnp.asarray(v), make_mesh_j,
                                    iters=1, run_sim=False)
        sizes = SIZES + [16] if name == "band" else SIZES
        rt = scaling.build_report(mt, sizes, v, device="cpu")
        out[name] = (mj, mt, rj, rt)
    return out


# ---------------------------------------------------------------------------
# matrices and estimates
# ---------------------------------------------------------------------------
def _capture(monkeypatch, module):
    got = {}

    def fake(m, sizes, v, *a, **kw):
        got["m"], got["v"] = m, np.asarray(v)
        return {"model": {"note": ""}, "spmv": [], "spgemm": []}

    monkeypatch.setattr(module, "build_report", fake)
    return got


@pytest.mark.parametrize("kind", ["band", "stencil", "web"])
def test_synthetic_matrices_match_jax(kind, monkeypatch):
    """Both CLIs build the same matrix and v from --synthetic."""
    gj = _capture(monkeypatch, scaling_j)
    gt = _capture(monkeypatch, scaling)
    argv = ["--synthetic", kind, "--n", "2048", "--devices", "1"]
    assert scaling_j.main(argv + ["--cpu-sim"]) == 0
    assert scaling.main(argv + ["--device", "cpu"]) == 0
    mj, mt = gj["m"], gt["m"]
    assert mj.shape == mt.shape and mj.nnz == mt.nnz
    nb = int(mj.nb)
    assert nb == int(mt.nb)
    for f in ("brow", "bcol", "offsets"):
        np.testing.assert_array_equal(np.asarray(getattr(mj, f))[:nb],
                                      getattr(mt, f)[:nb].numpy())
    for f in ("bmp_hi", "bmp_lo"):
        np.testing.assert_array_equal(
            np.asarray(getattr(mj, f))[:nb].astype(np.int64),
            getattr(mt, f)[:nb].numpy())
    np.testing.assert_array_equal(np.asarray(mj.values)[:mj.nnz],
                                  mt.values[:mt.nnz].numpy())
    np.testing.assert_array_equal(gj["v"], gt["v"])


@pytest.mark.parametrize("name", list(CASES))
def test_estimate_spgemm_tasks_matches_jax(name):
    mj, mt, _ = _both(CASES[name]())
    assert (scaling._estimate_spgemm_tasks(mt)
            == scaling_j._estimate_spgemm_tasks(mj) > 0)


# ---------------------------------------------------------------------------
# the report: plan-time fields exact, projections by the H100 constants
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(CASES))
def test_spmv_rows_match_jax(reports, name):
    mj, _, rj, rt = reports[name]
    assert rt["matrix"] == rj["matrix"]
    by_d = {r["d"]: r for r in rt["spmv"]}
    for row_j in rj["spmv"]:
        d = row_j["d"]
        pj, pt = row_j["projected"], by_d[d]["projected"]
        assert pt["exchange"] == pj["exchange"], d
        assert pt["nvlink_bytes_per_gpu"] == pj["ici_bytes_per_chip"], d
        np.testing.assert_allclose(
            pt["compute_s"], pj["compute_s"] * JAX_HBM / H100_HBM, **RTOL)
        np.testing.assert_allclose(
            pt["nvlink_s"], pt["nvlink_bytes_per_gpu"] / (NVLINK * 1e9)
            if pt["exchange"] == "halo"
            else mj.num_cols * 4 * (d - 1) / d / (NVLINK * 1e9), **RTOL)
        np.testing.assert_allclose(pt["nvlink_s"] * NVLINK,
                                   pj["ici_s"] * JAX_ICI, **RTOL)
        t_c, t_n = pt["compute_s"], pt["nvlink_s"]
        np.testing.assert_allclose(pt["efficiency_serialized"],
                                   t_c / (t_c + t_n), **RTOL)
        nbs = np.asarray(partition_j(mj, d, align=16).nb)
        assert by_d[d]["shard_imbalance"] == float(nbs.max() / nbs.mean())
        assert "measured" not in by_d[d]
    exchanges = {r["projected"]["exchange"] for r in rt["spmv"]
                 if r["d"] > 1}
    assert exchanges == ({"allgather"} if name == "hubs" else {"halo"})


@pytest.mark.parametrize("name", list(CASES))
def test_spgemm_rows_match_jax(reports, name):
    _, _, rj, rt = reports[name]
    by_d = {r["d"]: r for r in rt["spgemm"]}
    assert [r["d"] for r in rj["spgemm"]] == [2, 4, 8]
    for row_j in rj["spgemm"]:
        row_t = by_d[row_j["d"]]
        for k in ("exchange", "max_send", "selective_wire_bytes_total",
                  "selective_useful_bytes_total", "allgather_bytes_total",
                  "selective_fraction", "padding_overhead"):
            assert row_t[k] == row_j[k], (row_j["d"], k)
        pj, pt = row_j["projected"], row_t["projected"]
        np.testing.assert_allclose(
            pt["compute_s"], pj["compute_s"] * JAX_HBM / H100_HBM, **RTOL)
        np.testing.assert_allclose(pt["nvlink_s"] * NVLINK,
                                   pj["ici_s"] * JAX_ICI, **RTOL)
    if name == "hubs":
        assert by_d[8]["exchange"] == "allgather"
    assert "spgemm_skipped" not in rt


def test_multinode_rows_follow_the_rail_model(reports):
    """d = 16 on the band: two nodes; the halo's larger side crosses the
    node boundary at 50 GB/s, the product's off-node pair shares leave
    through each GPU's own port."""
    _, mt, _, rt = reports["band"]
    row = next(r for r in rt["spmv"] if r["d"] == 16)
    mn, pr = row["projected_multinode"], row["projected"]
    assert mn["nodes"] == 2 and mn["gpus_per_node"] == 8
    from bmsparse_tpu_torch.parallel.partition import partition
    from bmsparse_tpu_torch.parallel.plan import prepare_sharded

    halo = prepare_sharded(partition(mt, 16, align=16)).halo
    assert mn["network_bytes_per_gpu"] == max(halo) * 4
    np.testing.assert_allclose(mn["worst_gpu_comm_s"],
                               max(halo) * 4 / (NET * 1e9), **RTOL)
    t_c = pr["compute_s"]
    np.testing.assert_allclose(
        mn["efficiency_serialized"],
        t_c / (t_c + mn["worst_gpu_comm_s"]), **RTOL)
    g = next(r for r in rt["spgemm"] if r["d"] == 16)
    wire = (g["selective_wire_bytes_total"] if g["exchange"] == "selective"
            else g["allgather_bytes_total"])
    per_pair = wire / (16 * 15)
    np.testing.assert_allclose(
        g["projected_multinode"]["worst_gpu_comm_s"],
        max(per_pair * 8 / (NET * 1e9), per_pair * 7 / (NVLINK * 1e9)),
        **RTOL)
    assert not any("projected_multinode" in r for r in rt["spmv"]
                   if r["d"] <= 8)


def test_model_takes_the_cards_row():
    sxm = scaling.link_model("NVIDIA H100 80GB HBM3")
    assert (sxm["figures"], sxm["link_gbps"], sxm["hbm_gbps"]) == (
        "H100 SXM5", NVLINK, H100_HBM)
    pcie = scaling.link_model("NVIDIA H100 PCIe")
    assert (pcie["figures"], pcie["link_gbps"], pcie["hbm_gbps"]) == (
        "H100 PCIe", 64.0, 2000.0)
    none = scaling.link_model(None)
    assert none["figures"] == "H100 SXM5" and none["card"] is None
    assert "no CUDA device" in none["note"]
    other = scaling.link_model("NVIDIA A100-SXM4-80GB")
    assert other["figures"] == "H100 SXM5"
    assert "not in the table" in other["note"]
    for m in (sxm, pcie, none):
        assert m["gpus_per_node"] == 8 and m["network_gbps_per_gpu"] == NET
        assert "not measurements" in m["note"]


def test_report_model_on_the_cpu(reports):
    model = reports["band"][3]["model"]
    assert model["card"] is None and model["figures"] == "H100 SXM5"
    assert model["link_gbps"] == NVLINK and model["hbm_gbps"] == H100_HBM


# ---------------------------------------------------------------------------
# the task budget, failures, devices
# ---------------------------------------------------------------------------
def test_scaling_report_task_budget_guard():
    """The port of the JAX package's test: SpGEMM planning whose A@A task
    volume exceeds the budget is refused with a recorded reason."""
    r, c, v = random_coo(512, 512, density=0.02, seed=5)
    m = bt.coo_to_bmsparse(r, c, v, (512, 512), device="cpu")
    est = scaling._estimate_spgemm_tasks(m)
    assert est > 0
    vec = np.random.default_rng(0).standard_normal(512).astype(np.float32)
    rep = scaling.build_report(m, [2], vec, iters=1, device="cpu",
                               spgemm_task_budget=1)
    assert rep["spgemm"] == []
    assert rep["spgemm_skipped"]["estimated_tasks"] == est
    rep2 = scaling.build_report(m, [2], vec, iters=1, device="cpu")
    assert rep2["spgemm"] and "spgemm_skipped" not in rep2


def test_spgemm_failure_raises(monkeypatch):
    """No swallowed failure: an error in the SpGEMM section propagates."""
    import bmsparse_tpu_torch.parallel.product as product

    def boom(*a, **kw):
        raise RuntimeError("planner failed")

    monkeypatch.setattr(product, "prepare_sharded_product", boom)
    _, mt, v = _both(scaling.synthetic("band", 1024))
    with pytest.raises(RuntimeError, match="planner failed"):
        scaling.build_report(mt, [2], v, device="cpu")


def test_cuda_without_card_is_an_error():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, mt, v = _both(scaling.synthetic("band", 1024))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        scaling.build_report(mt, [1], v)
    with pytest.raises(SystemExit) as e:
        scaling.main(["--synthetic", "band", "--n", "1024"])
    assert e.value.code != 0


# ---------------------------------------------------------------------------
# measured rows: the CLI on spawned gloo ranks
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """One run of the CLI over a gloo world of 2 ranks, which measures d =
    1 (on a subgroup) and 2; d = 4 and 16 are beyond the ranks."""
    out = tmp_path_factory.mktemp("scaling") / "scaling.json"
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        rc = scaling.main(["--synthetic", "band", "--n", "4096", "--devices",
                           "1,2,4,16", "--iters", "1", "--device", "cpu",
                           "--cpu-ranks", "2", "--report", str(out)])
    return rc, out, text.getvalue()


def test_measured_rows_on_gloo_ranks(cli_run):
    rep = json.loads(cli_run[1].read_text())
    spmv = {r["d"]: r for r in rep["spmv"]}
    for d in (1, 2):
        ms = spmv[d]["measured"]
        assert ms["ok"] and ms["max_rel_err"] < 1e-3
        assert ms["world"] == d and ms["backend"] == "gloo"
        # the plan proves a halo at every d; at d = 1 it has no peer
        assert ms["exchange"] == "halo"
        assert ms["cpu_seconds_UNREPRESENTATIVE"] > 0
        assert "seconds" not in ms
    assert "measured" not in spmv[4] and "measured" not in spmv[16]
    gem = {r["d"]: r for r in rep["spgemm"]}
    assert sorted(gem) == [1, 2, 4, 16]
    assert set(gem[1]) == {"d", "measured"}
    for d in (1, 2):
        assert gem[d]["measured"]["ok"]
        assert gem[d]["measured"]["max_rel_err"] < 1e-3
    assert "measured" not in gem[4]


def test_cli_main_on_cpu_ranks(cli_run):
    rc, out, text = cli_run
    assert rc == 0
    rep = json.loads(out.read_text())
    assert [r["d"] for r in rep["spmv"]] == [1, 2, 4, 16]
    assert "projected_multinode" in rep["spmv"][3]
    assert "spmv d=  2: projected eff" in text
    assert "NVLink" in text and "ICI" not in text
    assert "multinode (2 nodes x 8 GPUs, rail model)" in text
    assert "CPU, unrepresentative" in text
    assert f"wrote {out}" in text
