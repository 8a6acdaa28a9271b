#!/usr/bin/env python3
"""One traced run of a benchmark cell with the program's spans read out,
on the card.

    python3 tools/span_report.py --workload <cell> --seed <n> --seconds <s> \\
        [--out FILE] [--overrides JSON]

Runs the cell as `portbench/run.py --trace 1` does (harness.run_cell),
keeps the profile of each traced window, and reads the program's
`bmsp.*` spans from it (portbench/spans.py): per window its length, busy
and device seconds, each span's count, host and device seconds and its
largest device operations, the self-check, and the span metrics (device
ms: spmv_dia_ms, spmv_sell_ms, spmv_stream_ms, spmv_glue_ms,
cg_vector_ms, product_decompress_ms, product_compress_ms), beside the
run's own result line. A checkout whose
program opens no spans reads no span and no metric. --overrides: the
harness's overrides of the configuration and the traffic, as JSON, e.g.
'{"config": {"scale": 16}}'. Prints one JSON line and writes it to FILE.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

T0 = time.perf_counter()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from portbench import harness, spans, trace  # noqa: E402


def product_kernels(w) -> float:
    """The device seconds of the product kernels in window w, as
    product_kernels_ms reads them."""
    reader = harness.load_module(harness.reader_path("product_kernels_ms"),
                                 "span_report_product_kernels")
    return w.kernel_seconds(reader.KERNEL)


def by_span(events, label: str, n: int = 6) -> dict:
    """{span: [[device operation, seconds]]}, the n largest operations of
    each span of the window (inclusive of nested spans)."""
    ranges, launches, device = spans.collect(events, label)
    ops = {}
    for c, sec, name in device:
        ops.setdefault(trace.short_name(name), []).append((c, sec))
    out = {}
    for op, dev in ops.items():
        for span, d in spans.attribute(ranges, launches, dev).items():
            if d["device_s"]:
                out.setdefault(span, {})[op] = d["device_s"]
    return {span: trace.top(d, n) for span, d in out.items()}


def traced_run(workload: str, seed: int, seconds: float,
               overrides: dict) -> dict:
    """harness.run_cell with --trace 1, each window's profile read for
    spans on the way."""
    windows = {}
    profile = torch.profiler.profile
    kept = []

    class Keeping(profile):
        def __exit__(self, *exc):
            out = super().__exit__(*exc)
            kept.append(self)
            return out

    capture = trace.capture

    def capture_and_read(name, fn, calls, specs, least_s=None):
        torch.profiler.profile = Keeping
        try:
            w = capture(name, fn, calls, specs, least_s)
        finally:
            torch.profiler.profile = profile
        events = list(kept.pop().profiler.kineto_results.events())
        prog = spans.read(events, f"portbench.{name}")
        kinds = {}
        for e in events:
            if e.name().startswith(spans.PREFIX):
                k = str(e.device_type())
                kinds[k] = kinds.get(k, 0) + 1
        ops = by_span(events, f"portbench.{name}") if prog.ok else {}
        windows[name] = (w, prog, kinds, ops)
        return w

    trace.capture = capture_and_read
    try:
        result, log = harness.run_cell(workload, seed, seconds, True, T0,
                                       overrides=overrides)
    finally:
        trace.capture = capture
    for line in log:
        print(line, file=sys.stderr)

    out, programs = {}, {}
    for name, (w, prog, kinds, ops) in windows.items():
        kernel_s = None
        if "bmsp.spgemm.products" in prog.spans:
            kernel_s = product_kernels(w)
        if not w.ok:
            prog.ok, prog.why = False, f"its window failed: {w.why}"
        spans.check(name, prog, kernel_s)
        programs[name] = prog
        out[name] = {
            "ok": w.ok, "why": w.why, "calls": w.calls, "wall_s": w.wall_s,
            "busy_s": w.busy_s, "device_s": prog.device_s,
            "unmatched_s": prog.unmatched_s, "product_kernels_s": kernel_s,
            "program_ok": prog.ok, "program_why": prog.why,
            "program": prog.spans, "span_ops": ops, "span_events": kinds,
            "spans_in_device_ops": sorted(
                n for n in w.device_ops if n.startswith(spans.PREFIX)),
            "idle_gaps": trace.top(w.idle_gaps, 20)}
    return {"workload": workload, "seed": seed,
            "card": torch.cuda.get_device_name(0),
            "power_limit_w": harness.power_limit_w(),
            "torch": torch.__version__, "result": result, "windows": out,
            "span_metrics": {n: spans.metric(n, programs)
                             for n in spans.NAMES}}


def main(argv) -> int:
    ap = argparse.ArgumentParser(prog="span_report",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out")
    ap.add_argument("--overrides", type=json.loads, default={})
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("span_report: needs a CUDA device", file=sys.stderr)
        return 2
    rep = traced_run(args.workload, args.seed, args.seconds, args.overrides)
    line = json.dumps(rep)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
