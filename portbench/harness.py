"""The benchmark's harness: one run of one cell of BENCHMARK.json.

Everything is found by name. The cell names a configuration (its file, in
BENCHMARK.json) and a traffic mix (traffic/<mix>.json); the configuration
names its generator (generators/<generator>.py), the mix its request kind
(requests/<request>.py); each per-layer metric has its reader
(layers/<metric>.py, or layers/<stem>.py for the metrics <stem>.<kind>
that share one), each of the program's kernels its file under
kernels/, and each cell the limits of its comparison (cells/<cell>.json).
A new configuration, mix, metric or cell is a new file.

One run:
  1. set-up (`setup_s`, from the process's start): import the program,
     load its kernel library (built on a checkout's first run), generate
     the inputs on the device, convert and plan them through the program,
     and run the mix's warm-up requests;
  2. the window: one caller, closed loop; each request starts when the
     previous one has synchronised, whole requests until `--seconds` have
     passed; a sample of the answers, drawn from the seed, is held;
  3. with --trace 1: the request kind's probes and a traced window of
     whole requests, read by the per-layer metrics;
  4. the comparison: the program's state is freed, and the plain reference
     judges the held answers and one output of the timed plan;
  5. the result: one JSON line on stdout, the numbers compared (each with
     its limit) last there and last on stderr.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import math
import random
import subprocess
import sys
import time
import traceback
from contextlib import contextmanager
from pathlib import Path

import torch

from portbench import trace
from portbench.seeds import derive

PB = Path(__file__).resolve().parent
CHECKOUT = PB.parent
# top-level module names that may not be loaded in a run (the JAX package
# and JAX itself); compared whole, since the program's name begins with
# the JAX package's
BANNED = frozenset({"jax", "jaxlib", "flax", "bmsparse_tpu"})
# whole requests in the traced window that the per-layer metrics read
TRACE_REQUESTS = 4


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def load_module(path: Path, name: str):
    """Import the file at `path` as a module called `name`."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def by_name(entries: list, name: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"{name!r} is not in BENCHMARK.json")


def banned_modules() -> list:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in BANNED)


def for_cell(metrics: list, workload: str) -> list:
    """The metrics of BENCHMARK.json that a cell reports."""
    return [m for m in metrics if workload in m.get("workloads", [workload])]


class Run:
    """What one run records: host-clock spans and traced windows."""

    def __init__(self, device, card: str):
        self.device = torch.device(device)
        self.card = card
        self.spans: dict = {}
        self.windows: dict = {}
        self.specs = trace.kernel_specs()

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextmanager
    def span(self, name: str):
        """Host seconds of the block, synchronised at both ends."""
        self.sync()
        t0 = time.perf_counter()
        yield
        self.sync()
        self.spans[name] = time.perf_counter() - t0

    def capture(self, name: str, fn, calls: int, least_s) -> None:
        """A traced window (trace.capture) of `calls` calls, each taking
        at least least_s() seconds; nothing on a host with no card, whose
        profile has no device to read."""
        if self.device.type == "cuda":
            self.windows[name] = trace.capture(name, fn, calls, self.specs,
                                               least_s())


class Record:
    """What a per-layer reader reads: the run's spans, and its traced
    windows that passed their check (None for one that did not)."""

    def __init__(self, run: Run):
        self.spans = run.spans
        self._windows = run.windows

    def span(self, name: str):
        return self.spans.get(name)

    def window(self, name: str):
        w = self._windows.get(name)
        return w if w is not None and w.ok else None


class Reservoir:
    """A uniform sample of k answers of each class of requests (request i
    is of class i mod `classes`), drawn from the seed, whatever their
    number (reservoir sampling)."""

    def __init__(self, k: int, seed: int, classes: int = 1):
        self.k = k
        self.rng = random.Random(derive(seed, "reservoir"))
        self.kept = [[] for _ in range(classes)]
        self.seen = [0] * classes

    def offer(self, i: int, out) -> None:
        c = i % len(self.kept)
        kept = self.kept[c]
        if len(kept) < self.k:
            kept.append((i, out))
        else:
            j = self.rng.randrange(self.seen[c] + 1)
            if j < self.k:
                kept[j] = (i, out)
        self.seen[c] += 1

    @property
    def items(self) -> list:
        return [x for kept in self.kept for x in kept]


def window(drv, seconds: float, sample: int, seed: int) -> dict:
    """The measured window: closed loop, one caller, whole requests until
    `seconds` have passed. A request that raises ends the window."""
    held = Reservoir(sample, seed, getattr(drv, "classes", 1))
    lat, failed, i = [], 0, 0
    t_start = t_last = time.perf_counter()
    while time.perf_counter() - t_start < seconds:
        t0 = time.perf_counter()
        try:
            out = drv.request(i)
        except Exception:                       # the program failed
            traceback.print_exc()
            failed += 1
            break
        t_last = time.perf_counter()
        lat.append(t_last - t0)
        held.offer(i, out)
        i += 1
    return {"latencies": lat, "span": t_last - t_start, "failed": failed,
            "attempted": i + failed, "held": held.items}


def p95(xs: list) -> float:
    """Nearest-rank 95th percentile."""
    s = sorted(xs)
    return s[max(math.ceil(0.95 * len(s)) - 1, 0)]


def end_to_end(name: str, how: str, win: dict, work: float):
    """An end-to-end metric of the window, by the mix's rule for it:
    "rate" is the work of every completed request (in the request kind's
    unit: billions of nonzeros for the solve and product kinds) over the
    window's start to the last completion; "p95_ms" the 95th percentile of
    every request's time, in ms."""
    lat = win["latencies"]
    if not lat:
        return None
    if how == "rate":
        return work * len(lat) / win["span"]
    if how == "p95_ms":
        return p95(lat) * 1e3
    raise ValueError(f"unknown end-to-end rule {how!r} for {name}")


def reader_path(metric: str) -> Path:
    """A per-layer metric's reader: layers/<metric>.py, else the reader
    of its stem, layers/<stem>.py for <stem>.<kind>."""
    own = PB / "layers" / f"{metric}.py"
    return own if own.exists() else PB / "layers" / f"{metric.split('.')[0]}.py"


def power_limit_w():
    """The card's power limit (nvidia-smi), or None where it cannot be
    read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=20, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def load_cell(workload: str, bench_path: Path, overrides: dict):
    bench = load_json(bench_path)
    cell = by_name(bench["workloads"], workload)
    cfg = load_json(CHECKOUT / by_name(bench["configs"],
                                       cell["config"])["file"])
    cfg.update(overrides.get("config", {}))
    traffic = load_json(PB / "traffic" / f"{cell['traffic']}.json")
    traffic.update(overrides.get("traffic", {}))
    limits = load_json(PB / "cells" / f"{workload}.json")["limits"]
    return bench, cfg, traffic, limits


def build(cfg: dict, traffic: dict, run: Run):
    """Generate the inputs and hand them to the request kind, which
    converts and plans them through the program."""
    gen = load_module(PB / "generators" / f"{cfg['generator']}.py",
                      f"portbench_gen_{cfg['generator']}")
    kind = load_module(PB / "requests" / f"{traffic['request']}.py",
                       f"portbench_req_{traffic['request']}")
    with run.span("generate"):
        problem = gen.generate(cfg, run.device)
    return kind.Driver(problem, traffic, run)


def warm(drv, traffic: dict) -> None:
    """Every shape the window will use: the mix's first requests."""
    for i in range(int(traffic.get("warmup_requests", 1))):
        drv.request(i)


def checks(numbers: dict, limits: dict) -> dict:
    """{name: {"value", "limit"}}; a number with no limit has limit None
    and fails."""
    return {k: {"value": v, "limit": limits.get(k, {}).get("limit")}
            for k, v in numbers.items()}


def passes(chk: dict) -> bool:
    return all(c["limit"] is not None and math.isfinite(c["value"])
               and c["value"] <= c["limit"] for c in chk.values())


def judge_all(drv, held: list, check_out) -> dict:
    """The numbers compared: the held answers' and the checked output's."""
    numbers = {}
    if held:
        numbers.update(drv.judge(held))
    if check_out is not None:
        numbers.update(drv.judge_check(check_out))
    return numbers


def run_cell(workload: str, seed: int, seconds: float, traced: bool,
             t0: float, device="cuda", overrides: dict | None = None,
             bench_path: Path | None = None):
    """One run. Returns (result dict, the stderr lines of the run); the
    result is None where a banned module was loaded."""
    overrides = overrides or {}
    bench, cfg, traffic, limits = load_cell(
        workload, bench_path or CHECKOUT / "BENCHMARK.json", overrides)
    cuda = torch.device(device).type == "cuda"
    card = torch.cuda.get_device_name(device) if cuda else "cpu"
    run = Run(device, card)
    if cuda:
        from bmsparse_tpu_torch.ops.cuda import build as kernels

        with run.span("load"):
            kernels.load()
    drv = build(cfg, traffic, run)
    with run.span("inputs"):
        drv.set_seed(seed)
    with run.span("warm"):
        warm(drv, traffic)
    setup_s = time.perf_counter() - t0

    win = window(drv, seconds, int(traffic["check_sample"]), seed)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    log = [f"{drv.problem.shape[0]} rows, {drv.problem.nnz} nonzeros",
           f"set-up {setup_s:.3f} s: " + ", ".join(
               f"{k} {v:.3f}" for k, v in run.spans.items()),
           f"window: {len(win['latencies'])} requests in "
           f"{win['span']:.3f} s, failed {win['failed']}"]

    metrics = {}
    if traced and not win["failed"]:
        drv.probes(run)
        n = TRACE_REQUESTS
        run.capture("requests", lambda: [drv.request(i) for i in range(n)],
                    n, drv.least_request_s)
        rec = Record(run)
        for m in for_cell(bench["per_layer"], workload):
            reader = load_module(reader_path(m["name"]),
                                 f"portbench_layer_{m['name']}")
            value = reader.read(rec)
            if value is None:
                log.append(f"not measured: {m['name']}")
            else:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        log += [f"traced window {w.name}: {'ok' if w.ok else w.why}; "
                f"busy {w.busy_s:.6f} s of {w.wall_s:.6f} s, launches "
                f"{w.launches}, counted {w.counted}"
                for w in run.windows.values()]
    elif not traced:
        rules = traffic["metrics"]
        for m in for_cell(bench["end_to_end"], workload):
            if m["name"] == "setup_s":
                value = setup_s
            elif m["name"] in rules:
                value = end_to_end(m["name"], rules[m["name"]], win,
                                   drv.work)
            else:
                value = None
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # the comparison, once the program's state is freed
    check_out = drv.check_output() if not win["failed"] else None
    drv.free()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers = judge_all(drv, win["held"], check_out)
    log.append(f"reference {time.perf_counter() - t_ref:.3f} s, "
               f"{len(win['held'])} answers compared")
    chk = checks(numbers, limits)

    bad = banned_modules()
    if bad:
        return None, log + ["loaded in this process: " + ", ".join(bad)]
    dev = {"platform": "gpu" if cuda else "cpu", "kind": card,
           "count": 1, "memory_peak_bytes": peak,
           "power_limit_w": power_limit_w() if cuda else None}
    result = {"correct": bool(win["attempted"] and not win["failed"]
                              and chk and passes(chk)),
              "attempted": win["attempted"], "failed": win["failed"],
              "metrics": metrics, "device": dev}
    w = run.windows.get("requests")
    if traced and w is not None:
        dev["busy_s"], dev["window_s"] = w.busy_s, w.wall_s
        result["breakdown"] = {"device_ops": trace.top(w.device_ops),
                               "idle_gaps": trace.top(w.idle_gaps)}
    result["checks"] = chk
    log += [f"check {k} {c['value']!r} limit {c['limit']!r}"
            for k, c in chk.items()]
    return result, log


def parse(argv):
    ap = argparse.ArgumentParser(prog="portbench",
                                 description="one run of one cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, t0: float) -> int:
    args = parse(argv)
    chips = by_name(load_json(CHECKOUT / "BENCHMARK.json")["workloads"],
                    args.workload)["chips"]
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"portbench: needs {chips} CUDA device(s), found {found}",
              file=sys.stderr)
        return 2
    result, log = run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), t0)
    for line in log:
        print(line, file=sys.stderr)
    if result is None:
        return 3
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
