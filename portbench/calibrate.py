"""Readings for the limits of a cell's comparison, at the cell's own sizes,
in one process: the program's numbers over many seeds (each a short
window at the cell's load, its held answers and checked output judged as
a run judges them), and the control's over a few: the plain reference
computed in bfloat16, one precision step below the configuration's
float32, put in the program's place for the same requests.

    python3 portbench/calibrate.py --workload <cell> --seconds 3 \
        --seeds 1 2 3 ... --control-seeds 101 102 103

Prints one JSON line per seed and side, then per number the lower reading
(the largest of the program's) and the upper (the smallest of the
control's). The benchmark's own runs never run this.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from portbench import harness  # noqa: E402


def readings(workload: str, seeds: list, control_seeds: list,
             seconds: float, device="cuda", overrides=None) -> dict:
    """{"program": [numbers per seed], "control": [...]}; prints each."""
    _, cfg, traffic, _ = harness.load_cell(
        workload, harness.CHECKOUT / "BENCHMARK.json", overrides or {})
    cuda = torch.device(device).type == "cuda"
    run = harness.Run(device, torch.cuda.get_device_name(device)
                      if cuda else "cpu")
    if cuda:
        from bmsparse_tpu_torch.ops.cuda import build as kernels

        kernels.load()
    drv = harness.build(cfg, traffic, run)
    sample = int(traffic["check_sample"])
    out = {"program": [], "control": []}
    for seed in seeds:
        drv.set_seed(seed)
        harness.warm(drv, traffic)
        win = harness.window(drv, seconds, sample, seed)
        nums = harness.judge_all(drv, win["held"], drv.check_output())
        out["program"].append(nums)
        print(json.dumps({"side": "program", "seed": seed,
                          "requests": len(win["latencies"]),
                          "failed": win["failed"], "numbers": nums}),
              flush=True)
    classes = getattr(drv, "classes", 1)
    for seed in control_seeds:
        drv.set_seed(seed)
        held = [(i, drv.control(i)) for i in range(sample * classes)]
        nums = harness.judge_all(drv, held, drv.control_check_output())
        out["control"].append(nums)
        print(json.dumps({"side": "control", "seed": seed,
                          "numbers": nums}), flush=True)
    for k in out["program"][0] if out["program"] else []:
        lo = max(n[k] for n in out["program"])
        hi = min((n[k] for n in out["control"]), default=None)
        print(json.dumps({"number": k, "lower": lo, "upper": hi}),
              flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    readings(args.workload, args.seeds, args.control_seeds, args.seconds)
    print(f"calibrate {time.perf_counter() - T0:.1f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
