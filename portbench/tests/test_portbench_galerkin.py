"""The cell hpcg-sa-amg.galerkin on the CPU at small sizes: sound runs
are correct, a broken timed path or the control is not, and the
configuration's stated sizes are the generator's."""

import dataclasses
import time

import pytest
import torch

from bmsparse_tpu_torch.ops.galerkin import PreparedGalerkin
from portbench import calibrate, harness
from portbench.generators import hpcg_sa

CELL = "hpcg-sa-amg.galerkin"
SMALL = {"config": {"nx": 12, "ny": 12, "nz": 12}}
SEED = 2**33 + 4321


def run(traced=False, seconds=0.5):
    return harness.run_cell(CELL, SEED, seconds, traced,
                            time.perf_counter(), device="cpu",
                            overrides=SMALL)


@pytest.mark.parametrize("traced", [False, True])
def test_sound_run_is_correct(traced):
    res, log = run(traced)
    assert res["correct"], log
    bench = harness.load_json(harness.CHECKOUT / "BENCHMARK.json")
    # the CPU has no device trace: only the host-clock metric reads
    want = ({"plan_s"} if traced else {
        m["name"] for m in harness.for_cell(bench["end_to_end"], CELL)})
    assert set(res["metrics"]) == want
    assert res["checks"]["c_structure"]["value"] == 0


def _scaled(c, kind):
    vals = c.values.clone()
    if kind == "half":
        h = vals.numel() // 2
        vals[:h] *= 2
        vals[h:] = 0
    else:
        vals[vals.numel() // 3] += 1e-2 * vals.abs().max()
    return dataclasses.replace(c, values=vals)


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    orig = PreparedGalerkin.__call__

    def faulty(self, a):
        if fault == "unchanged":                 # new values ignored
            return orig(self, self.ap.plan.a)
        return _scaled(orig(self, a), fault)

    monkeypatch.setattr(PreparedGalerkin, "__call__", faulty)
    res, log = run(seconds=1.0)
    assert res["correct"] is False, log


def test_the_control_fails_a_limit():
    limits = harness.load_json(harness.PB / "cells" / f"{CELL}.json")[
        "limits"]
    got = calibrate.readings(CELL, [], [SEED, SEED + 1], 0.0,
                             device="cpu", overrides=SMALL)
    for nums in got["control"]:
        assert not harness.passes(harness.checks(nums, limits)), nums


def test_configuration_sizes_are_the_generators():
    """Levels 1-2 of the stated hierarchy, from the generator on the
    coarse grid of level 1 (35^3: the coarse operators keep the 27-point
    pattern, so these levels are the full configuration's); level 0's
    sizes are the same rules at 104^3, checked on the card."""
    cfg = harness.load_json(harness.CHECKOUT / "portbench" / "configs"
                            / "hpcg-sa-amg.json")
    sizes = cfg["sizes"]
    assert sizes["nnz_of_the_six_products"] == sum(
        sizes["nnz_ap"]) + sum(sizes["nnz_a"][1:])
    p = hpcg_sa.generate({**cfg, "nx": 35, "ny": 35, "nz": 35,
                          "levels": 3}, "cpu")
    assert [lv["nnz_a"] for lv in p.levels] == sizes["nnz_a"][1:3]
    assert [lv["nnz_p"] for lv in p.levels] == sizes["nnz_p"][1:]
    assert [lv["nnz_ap"] for lv in p.levels] == sizes["nnz_ap"][1:]
    assert [lv["nnz_c"] for lv in p.levels] == sizes["nnz_a"][2:]
    assert [g[0] ** 3 for g in p.grids] == sizes["n"][1:]
    assert all(torch.equal(q.vals, q.vals.float()) for q in p.p)
