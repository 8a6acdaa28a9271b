"""The program's spans in a traced window: the `bmsp.<name>` ranges that
bmsparse_tpu_torch opens on the profiler's timeline while a profiler
records (utils/timing.py::span), read into device seconds per span, with
the self-check that gates the metrics read from them.

A device operation belongs to every span that was open on the traced
thread when the runtime call that launched it started (the call and the
operation share a correlation id), so a span's device seconds include
its nested spans'. The window's device operations are the device's
events inside it, each clipped to the window, less the copies of the
benchmark's and the program's ranges, as trace.py reads them. Events are
told apart by name, since kineto events of torch 2.11 carry no activity
type: a runtime call's name begins with "cu" (cudaLaunchKernel,
cudaMemcpyAsync, cuLaunchKernel, ...), an operator's with its namespace.

The self-check: the work a window times lies inside the span that names
it (`bmsp.spmv` in the window "spmv"; `bmsp.cg` or `bmsp.product`, where
the window holds one, in "requests"), at least SHARE of the window's
device seconds; and the products' span agrees with the product kernels'
own time within AGREE. A window that fails it reads no span metric.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

import torch

from portbench.trace import _merge

PREFIX = "bmsp."
# the names of the runtime and driver calls that launch device work
LAUNCH = "cu"
SHARE = 0.99
AGREE = 0.02
# the span that names each window's whole work (one of them, in "requests")
WHOLE = {"spmv": ("bmsp.spmv",), "requests": ("bmsp.cg", "bmsp.product")}
SPMV_TIERS = ("bmsp.spmv.dia", "bmsp.spmv.sell", "bmsp.spmv.overflow",
              "bmsp.spmv.stream")

# metric: (window, spans summed, span whose count divides), device ms
METRICS = {
    "spmv_dia_ms": ("spmv", ("bmsp.spmv.dia",), "bmsp.spmv"),
    "spmv_sell_ms": ("spmv", ("bmsp.spmv.sell", "bmsp.spmv.overflow"),
                     "bmsp.spmv"),
    "spmv_stream_ms": ("spmv", ("bmsp.spmv.stream",), "bmsp.spmv"),
    "cg_vector_ms": ("requests", ("bmsp.cg.update",), "bmsp.cg.update"),
    "product_decompress_ms": ("requests", ("bmsp.product.decompress",),
                              "bmsp.product"),
    "product_compress_ms": ("requests", ("bmsp.spgemm.compress",),
                            "bmsp.product"),
}


@dataclass
class Program:
    """A window's spans: {name: {"count", "host_s", "device_s"}}, the
    window's device seconds (all its operations), those no launch of the
    traced window could be found for, and the self-check."""
    spans: dict = field(default_factory=dict)
    device_s: float = 0.0
    unmatched_s: float = 0.0
    ok: bool = True
    why: str = ""


def attribute(ranges, launches, device) -> dict:
    """{name: {"count", "host_s", "device_s"}} of the spans.

    ranges: (start, end, name) of the spans' occurrences on the traced
    thread, in ns; launches: (correlation, start) of the runtime calls,
    start in ns; device: (correlation, seconds) of the device operations.
    An operation counts in each span with an occurrence open at its
    launch's start (ends included); one with no launch counts in none."""
    at = dict(launches)
    occ = {}
    for s, e, n in ranges:
        occ.setdefault(n, []).append((s, e))
    out = {}
    for n, iv in occ.items():
        merged = _merge(iv)
        starts = [s for s, _ in merged]
        dev = 0.0
        for corr, sec in device:
            t = at.get(corr)
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= merged[i][1]:
                dev += sec
        out[n] = {"count": len(iv),
                  "host_s": sum(e - s for s, e in iv) * 1e-9,
                  "device_s": dev}
    return out


def collect(events, label: str):
    """(ranges, launches, device) of the window `label` (trace.capture's
    own range) in a profile's kineto events, as attribute() takes them,
    device as (correlation, seconds, name); None where the trace lacks
    the window's range."""
    cpu = torch.autograd.DeviceType.CPU
    win = [e for e in events if e.name() == label and e.device_type() == cpu]
    if not win:
        return None
    a0, a1 = win[0].start_ns(), win[0].end_ns()
    thread = win[0].start_thread_id()
    ranges, launches, device = [], [], []
    for e in events:
        s = e.start_ns()
        if e.device_type() == cpu:
            if not a0 <= s <= a1:
                continue
            if (e.name().startswith(PREFIX)
                    and e.start_thread_id() == thread):
                ranges.append((s, e.end_ns(), e.name()))
            elif e.name().startswith(LAUNCH):
                launches.append((e.correlation_id(), s))
        elif e.device_type() == torch.autograd.DeviceType.CUDA:
            if e.name().startswith(("portbench.", PREFIX)):
                continue
            t = min(e.end_ns(), a1)
            s = max(s, a0)
            if t > s:
                device.append((e.correlation_id(), (t - s) * 1e-9, e.name()))
    return ranges, launches, device


def read(events, label: str) -> Program:
    """The spans of the window `label` in a profile's kineto events."""
    got = collect(events, label)
    if got is None:
        return Program(ok=False, why=f"no range {label} in the trace")
    ranges, launches, device = got
    device = [(c, sec) for c, sec, _ in device]
    known = {c for c, _ in launches}
    return Program(spans=attribute(ranges, launches, device),
                   device_s=sum(sec for _, sec in device),
                   unmatched_s=sum(sec for c, sec in device
                                   if c not in known))


def check(window: str, prog: Program, kernel_s: float | None = None
          ) -> Program:
    """The self-check of `prog`, the spans of the window `window`; sets
    prog.ok and prog.why and returns prog. kernel_s: the device seconds
    of the product kernels in the window, where it holds products."""
    if not prog.ok:
        return prog
    bad = []
    whole = [n for n in WHOLE.get(window, ()) if n in prog.spans]
    if window == "spmv" and not whole:
        bad.append("no bmsp.spmv span")
    for n in whole:
        share = (prog.spans[n]["device_s"] / prog.device_s
                 if prog.device_s else 0.0)
        if share < SHARE:
            bad.append(f"{n} holds {share:.4%} of the window's device "
                       f"seconds, under {SHARE:.0%} (unmatched "
                       f"{prog.unmatched_s:.6f} s)")
    products = prog.spans.get("bmsp.spgemm.products")
    if products is not None and kernel_s is not None:
        if abs(products["device_s"] - kernel_s) > AGREE * kernel_s:
            bad.append(f"bmsp.spgemm.products {products['device_s']:.6f} s"
                       f" against the product kernels' {kernel_s:.6f} s")
    if bad:
        prog.ok, prog.why = False, "; ".join(bad)
    return prog


def metric(name: str, programs: dict):
    """A span metric in device ms from {window: Program}; None where its
    window is missing or failed its self-check, or its spans are absent.
    spmv_glue_ms: `bmsp.spmv` less its tiers, per call."""
    if name == "spmv_glue_ms":
        prog = programs.get("spmv")
        if prog is None or not prog.ok or "bmsp.spmv" not in prog.spans:
            return None
        whole = prog.spans["bmsp.spmv"]
        tiers = sum(prog.spans[t]["device_s"] for t in SPMV_TIERS
                    if t in prog.spans)
        return (whole["device_s"] - tiers) / whole["count"] * 1e3
    window, parts, per = METRICS[name]
    prog = programs.get(window)
    if prog is None or not prog.ok or per not in prog.spans:
        return None
    got = [prog.spans[n]["device_s"] for n in parts if n in prog.spans]
    if not got:
        return None
    return sum(got) / prog.spans[per]["count"] * 1e3


NAMES = ("spmv_dia_ms", "spmv_sell_ms", "spmv_stream_ms", "spmv_glue_ms",
         "cg_vector_ms", "product_decompress_ms", "product_compress_ms")


def kept(rec, phase: str):
    """Host seconds of the program's set-up phase `phase` (its own clock,
    utils/timing.py::kept, summed over the run's plans), in a traced run
    on a card: None where the run has no traced window of its requests
    (a run on the CPU, or a window that failed its check) or the program
    keeps no such phase."""
    if rec.window("requests") is None:
        return None
    from bmsparse_tpu_torch.utils import timing

    return getattr(timing, "kept", {}).get(phase)
