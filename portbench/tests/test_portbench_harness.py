"""The harness end to end on the CPU at small sizes: the result line, the
comparison (sound runs pass; the timed path broken underneath, or the
control in its place, fails), the lookup of new files by name, and the
refusals (no card, JAX loaded)."""

import dataclasses
import hashlib
import json
import os
import shutil
import subprocess
import sys
import time
import types
from pathlib import Path

import pytest
import torch

import bmsparse_tpu_torch
import bmsparse_tpu_torch.ops.spmv as spmv_mod
from bmsparse_tpu_torch.ops.product import PreparedProduct
from portbench import calibrate, harness

PB = Path(__file__).resolve().parents[1]
SMALL = {"hpcg-208.cg": {"config": {"nx": 10, "ny": 9, "nz": 8}},
         "hpcg-104.a2": {"config": {"nx": 8, "ny": 8, "nz": 6}},
         "graph500-s20.pagerank": {"config": {"scale": 10}}}
CELLS = sorted(SMALL)
SEED = 2**33 + 12345


def run(workload, traced=False, seed=SEED, seconds=0.3):
    return harness.run_cell(workload, seed, seconds, traced,
                            time.perf_counter(), device="cpu",
                            overrides=SMALL[workload])


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct_and_the_line_keeps_the_contract(workload):
    res, log = run(workload)
    assert res["correct"], log
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]     # compared numbers last
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    bench = harness.load_json(harness.CHECKOUT / "BENCHMARK.json")
    want = {m["name"] for m in harness.for_cell(bench["end_to_end"],
                                                workload)}
    assert set(res["metrics"]) == want
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    assert log[-len(res["checks"]):] == [
        f"check {k} {c['value']!r} limit {c['limit']!r}"
        for k, c in res["checks"].items()]


def test_traced_line_carries_per_layer_metrics():
    res, _ = run("hpcg-208.cg", traced=True)
    assert res["correct"]
    # the CPU has no device trace: only the host-clock metrics read
    assert set(res["metrics"]) == {"plan_s", "spmv_dispatch_us"}
    assert res["metrics"]["spmv_dispatch_us"]["unit"] == "us"


def _spmv_fault(kind):
    orig = spmv_mod.spmv

    def faulty(m, v, impl=None):
        if kind == "unchanged":                  # the step returns its state
            return v.clone()
        u = orig(m, v, impl)
        if kind == "half":                       # half left out, mean kept
            h = u.numel() // 2
            u = torch.cat([u[:h] * 2, torch.zeros_like(u[h:])])
        else:                                    # one answer altered
            u = u.clone()
            u[u.numel() // 3] += 1e-2 * u.abs().max()
        return u

    return faulty


def _product_fault(kind):
    orig = PreparedProduct.__call__

    def faulty(self, a=None, b=None):
        if kind == "unchanged":                  # new values ignored
            return orig(self)
        c = orig(self, a, b)
        vals = c.values.clone()
        if kind == "half":
            h = vals.numel() // 2
            vals[:h] *= 2
            vals[h:] = 0
        else:
            vals[vals.numel() // 3] += 1e-2 * vals.abs().max()
        return dataclasses.replace(c, values=vals)

    return faulty


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_timed_path_is_not_correct(workload, fault, monkeypatch):
    seconds = 0.3
    if workload == "hpcg-104.a2":
        monkeypatch.setattr(PreparedProduct, "__call__",
                            _product_fault(fault))
        # long enough for a request of value set 1 on a loaded host: an
        # unchanged product is right for set 0's
        seconds = 6.0
    else:
        f = _spmv_fault(fault)
        monkeypatch.setattr(spmv_mod, "spmv", f)
        monkeypatch.setattr(bmsparse_tpu_torch, "spmv", f)
    res, log = run(workload, seconds=seconds)
    assert res["correct"] is False, log


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_a_limit(workload):
    limits = harness.load_json(PB / "cells" / f"{workload}.json")["limits"]
    got = calibrate.readings(workload, [], [SEED, SEED + 1, SEED + 2], 0.0,
                             device="cpu", overrides=SMALL[workload])
    for nums in got["control"]:
        assert not harness.passes(harness.checks(nums, limits)), nums


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    rc = harness.main(["--workload", "hpcg-208.cg", "--seed", "1",
                       "--seconds", "1"], time.perf_counter())
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA" in out.err


def test_jax_loaded_no_result(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    res, log = run("graph500-s20.pagerank")
    assert res is None and "jax" in log[-1]


def _digests(root: Path) -> dict:
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_config_traffic_metric_and_cell_are_found_by_name(tmp_path):
    co = tmp_path / "checkout"
    shutil.copytree(PB, co / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(co / "portbench")
    bench = harness.load_json(harness.CHECKOUT / "BENCHMARK.json")
    bench["configs"].append({
        "name": "dummy-cfg", "source": "a test", "reduced": [],
        "file": "portbench/configs/dummy-cfg.json", "why": "a test"})
    bench["workloads"].append({
        "name": "dummy-cfg.dummymix", "config": "dummy-cfg",
        "traffic": "dummymix", "chips": 1, "why": "a test"})
    for name in ("dummy_metric", "dummy_metric.kind"):
        bench["per_layer"].append({
            "name": name, "unit": "s", "better": "lower",
            "source": "host_clock", "layer": "test", "moves": "setup_s",
            "workloads": ["dummy-cfg.dummymix"]})
    (co / "BENCHMARK.json").write_text(json.dumps(bench))
    new = {
        "configs/dummy-cfg.json": json.dumps({
            "generator": "dummygen", "nx": 6, "ny": 5, "nz": 4,
            "diagonal": 26.0, "off_diagonal": -1.0,
            "off_diagonal_range": [-1.5, -0.5]}),
        "generators/dummygen.py":
            "from portbench.generators.hpcg27 import generate  # noqa\n",
        "traffic/dummymix.json": json.dumps({
            "request": "cg", "iterations": 5, "right_hand_sides": 2,
            "check_sample": 2,
            "metrics": {"solve_gnnz_s": "rate"}}),
        "layers/dummy_metric.py":
            "def read(rec):\n    return 2 * rec.span('plan')\n",
        "cells/dummy-cfg.dummymix.json": json.dumps({"limits": {
            "x_gap": {"limit": 1e-4}, "res_gap": {"limit": 1e-4},
            "spmv_gap": {"limit": 1e-4}}}),
    }
    for rel, text in new.items():
        (co / "portbench" / rel).write_text(text)
    code = (
        "import sys, time, json\n"
        f"sys.path[:0] = [{str(co)!r}]\nsys.path.append({str(PB.parent)!r})\n"
        "from portbench import harness\n"
        "assert harness.CHECKOUT == __import__('pathlib').Path("
        f"{str(co)!r})\n"
        "res, log = harness.run_cell('dummy-cfg.dummymix', 5, 0.2, True,"
        " time.perf_counter(), device='cpu')\n"
        "print(json.dumps(res))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=co,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.splitlines()[-1])
    assert res["correct"]
    for name in ("dummy_metric", "dummy_metric.kind"):     # the stem's reader
        assert res["metrics"][name]["value"] == pytest.approx(
            2 * res["metrics"]["plan_s"]["value"])
    after = _digests(co / "portbench")
    assert {k: v for k, v in after.items() if k in before} == before


def test_every_per_layer_metric_has_a_reader():
    bench = harness.load_json(harness.CHECKOUT / "BENCHMARK.json")
    for m in bench["per_layer"]:
        assert harness.reader_path(m["name"]).is_file(), m["name"]
    assert (harness.reader_path("idle_share.solve")
            == harness.reader_path("idle_share.product")
            == PB / "layers" / "idle_share.py")


@pytest.mark.gpu
def test_traced_windows_pass_their_checks_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    res, log = harness.run_cell(
        "hpcg-208.cg", SEED, 1.0, True, time.perf_counter(),
        device="cuda", overrides={"config": {"nx": 64, "ny": 64, "nz": 64}})
    assert res["correct"], log
    assert {"spmv_roofline", "idle_share.solve"} <= set(res["metrics"]), log
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
