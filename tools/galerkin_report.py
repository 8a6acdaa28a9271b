#!/usr/bin/env python3
"""Where one AMG re-set-up's time goes, level by level, on the card: the
cell hpcg-sa-amg.galerkin's inputs and plans as the benchmark builds them
(portbench harness), then for each level's PreparedGalerkin

  * the plans of its two products: tasks, C's blocks and nonzeros, the
    K-groups and how many have a tile window, the compress mode;
  * the product kernels each call launches (the program's counters);
  * device ms per call (CUDA events, median of --calls);
  * one call under the profiler: device ms per program span
    (portbench/spans.py: `bmsp.galerkin`, `bmsp.product`,
    `bmsp.product.decompress`, `bmsp.galerkin.relayout`,
    `bmsp.spgemm.products`, `bmsp.spgemm.compress`);

and the peak device memory of set-up and of the calls.

    python3 tools/galerkin_report.py --seed <n> [--calls 20] [--out FILE]
        [--overrides JSON]

Prints one JSON line and writes it to FILE. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from portbench import harness, spans  # noqa: E402

CELL = "hpcg-sa-amg.galerkin"


def plan_stats(pp) -> dict:
    p = pp.plan
    win, sell = p.launches
    return {"tasks": p.num_tasks, "alive": p.num_alive,
            "c_blocks": p.num_c_blocks, "c_nnz": p.num_c_nnz,
            "groups": len(p.groups),
            "window_groups": sum(w is not None for w in p.pwin),
            "launch_window": win is not None, "launch_sell": sell is not None,
            "compress": p.compress_mode, "a_shape": list(p.a.shape),
            "b_shape": list(p.b.shape)}


def counters() -> dict:
    from bmsparse_tpu_torch.ops.cuda import bitmap_compress_kernel as bk
    from bmsparse_tpu_torch.ops.cuda import compress_kernel as ck
    from bmsparse_tpu_torch.ops.cuda import spgemm_kernel as sk
    from bmsparse_tpu_torch.ops.cuda import spgemm_window_kernel as wk

    return {"numeric_sell": sk.numeric_sell.launches,
            "numeric_window": wk.numeric_window.launches,
            "segment_compress_class": ck.segment_compress_class.launches,
            "bitmap_compress": bk.bitmap_compress.launches}


def level_spans(fn) -> dict:
    """{span: device ms} of one call of fn under the profiler."""
    from torch.profiler import ProfilerActivity, profile, record_function

    label = "galerkin_report.level"
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(label):
            fn()
            torch.cuda.synchronize()
    prog = spans.read(list(prof.profiler.kineto_results.events()), label)
    return {n: {"count": d["count"], "device_ms": d["device_s"] * 1e3,
                "host_ms": d["host_s"] * 1e3}
            for n, d in sorted(prog.spans.items())}


def report(seed: int, calls: int, overrides: dict) -> dict:
    t0 = time.perf_counter()
    from bmsparse_tpu_torch.ops.cuda import build

    build.load()
    _, cfg, traffic, _ = harness.load_cell(
        CELL, harness.CHECKOUT / "BENCHMARK.json", overrides)
    run = harness.Run("cuda", torch.cuda.get_device_name(0))
    drv = harness.build(cfg, traffic, run)
    drv.set_seed(seed)
    harness.warm(drv, traffic)
    torch.cuda.synchronize()
    setup_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    levels, a = [], drv.a0[1 % drv.sets]
    for lvl, (gal, lv) in enumerate(zip(drv.gals, drv.problem.levels)):
        before = counters()
        out = gal(a)
        torch.cuda.synchronize()
        launched = {k: v - before[k] for k, v in counters().items()}
        ms = []
        for _ in range(calls):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            gal(a)
            e.record()
            e.synchronize()
            ms.append(s.elapsed_time(e))
        levels.append({
            "level": lvl, "sizes": lv, "a_p": plan_stats(gal.ap),
            "r_ap": plan_stats(gal.rap), "launches_per_call": launched,
            "device_ms": statistics.median(ms), "device_ms_all": ms,
            "spans": level_spans(lambda: gal(a))})
        a = out
    return {"cell": CELL, "seed": seed, "card": run.card,
            "power_limit_w": harness.power_limit_w(),
            "torch": torch.__version__, "omega": drv.problem.omega,
            "chain_nnz": drv.problem.chain_nnz(),
            "least_request_ms": drv.least_request_s() * 1e3,
            "setup_spans_s": run.spans, "memory_peak_setup_bytes": setup_peak,
            "memory_peak_calls_bytes": torch.cuda.max_memory_allocated(),
            "levels": levels, "seconds": time.perf_counter() - t0}


def main(argv) -> int:
    ap = argparse.ArgumentParser(prog="galerkin_report",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--calls", type=int, default=20)
    ap.add_argument("--out")
    ap.add_argument("--overrides", type=json.loads, default={})
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("galerkin_report: needs a CUDA device", file=sys.stderr)
        return 2
    line = json.dumps(report(args.seed, args.calls, args.overrides))
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
