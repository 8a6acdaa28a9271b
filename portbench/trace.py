"""Traced windows: torch.profiler around a piece of work, read into device
busy time, kernel launches by name, device operations by time and the
host's activity during the device's idle gaps.

Every window is checked before any metric reads it: the launches of each
of the program's kernels that the profiler saw must equal what the
program's own launch counters counted over the window, and the device
time of one call may not fall below its least time. A window that fails
either is kept out of every metric (`Window.ok` false, `Window.why`).
"""

from __future__ import annotations

import bisect
import importlib
import json
import re
from dataclasses import dataclass, field
from pathlib import Path

import torch

KERNELS_DIR = Path(__file__).resolve().parent / "kernels"
TOP = 10


def kernel_specs(kernels_dir: Path = KERNELS_DIR) -> dict:
    """{kernel: (module, attribute, compiled pattern)} from kernels/*.json,
    one file per kernel of the program: its launch counter and the name
    the profiler gives its launches."""
    specs = {}
    for f in sorted(kernels_dir.glob("*.json")):
        d = json.loads(f.read_text())
        mod, attr = d["counter"].split(":")
        specs[f.stem] = (mod, attr, re.compile(d["pattern"]))
    return specs


def read_counters(specs: dict) -> dict:
    """The program's launch counters, {kernel: launches}."""
    return {k: int(getattr(importlib.import_module(mod), attr).launches)
            for k, (mod, attr, _) in specs.items()}


def short_name(name: str) -> str:
    """A device operation's name without its argument list."""
    name = name.removeprefix("void ")
    cut = name.find("(")
    name = name[:cut] if cut > 0 else name
    return name if len(name) <= 96 else name[:96]


@dataclass
class Window:
    name: str
    calls: int
    wall_s: float = 0.0
    busy_s: float = 0.0
    least_s: float | None = None         # least time of one call
    launches: dict = field(default_factory=dict)      # profiler, by kernel
    counted: dict = field(default_factory=dict)       # program's counters
    device_ops: dict = field(default_factory=dict)    # short name -> s
    idle_gaps: dict = field(default_factory=dict)     # host activity -> s
    ok: bool = True
    why: str = ""

    def kernel_seconds(self, pattern: str) -> float:
        rx = re.compile(pattern)
        return sum(s for n, s in self.device_ops.items() if rx.search(n))


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _host_at(cpu, times):
    """For each time (ascending), the innermost host operation running on
    the traced thread then, or "python" between operations. cpu: (start,
    end, name) of properly nested ranges."""
    cpu = sorted(cpu, key=lambda e: (e[0], -e[1]))
    starts = [e[0] for e in cpu]
    out, stack, j = [], [], 0
    for t in times:
        hi = bisect.bisect_right(starts, t)
        while j < hi:
            while stack and stack[-1][1] <= cpu[j][0]:
                stack.pop()
            stack.append(cpu[j])
            j += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][2] if stack else "python")
    return out


def capture(name: str, fn, calls: int, specs: dict,
            least_s: float | None = None) -> Window:
    """Run fn() (which ends in a synchronize) once under the profiler and
    read the window. calls: the calls of the measured operation that fn
    makes, for per-call figures."""
    from torch.profiler import ProfilerActivity, profile, record_function

    w = Window(name=name, calls=calls, least_s=least_s)
    label = f"portbench.{name}"
    torch.cuda.synchronize()
    before = read_counters(specs)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(label):
            fn()
            torch.cuda.synchronize()
    after = read_counters(specs)
    w.counted = {k: after[k] - before[k] for k in specs}

    events = list(prof.profiler.kineto_results.events())
    ann = [e for e in events if e.name() == label
           and e.device_type() == torch.autograd.DeviceType.CPU]
    if not ann:
        w.ok, w.why = False, "the window's own range is missing from the trace"
        return w
    a0, a1 = ann[0].start_ns(), ann[0].end_ns()
    thread = ann[0].start_thread_id()
    w.wall_s = (a1 - a0) * 1e-9
    dev = []
    for e in events:
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        # the device timeline's copy of a record_function range is no work
        if e.name().startswith("portbench.") or "annotation" in str(
                getattr(e, "activity_type", lambda: "")()).lower():
            continue
        s, t = max(e.start_ns(), a0), min(e.end_ns(), a1)
        if t > s:
            dev.append((s, t, e.name()))
    if not dev:
        w.ok, w.why = False, "no device activity in the trace"
        return w
    busy = _merge([(s, t) for s, t, _ in dev])
    w.busy_s = sum(t - s for s, t in busy) * 1e-9
    ops = {}
    for s, t, n in dev:
        k = short_name(n)
        ops[k] = ops.get(k, 0.0) + (t - s) * 1e-9
    w.device_ops = ops
    w.launches = {k: sum(1 for _, _, n in dev if rx.search(n))
                  for k, (_, _, rx) in specs.items()}

    # idle gaps: before the first device operation, between the busy
    # stretches, after the last; named by what the host was doing
    edges = [a0] + [x for iv in busy for x in iv] + [a1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    cpu = [(e.start_ns(), e.end_ns(), e.name()) for e in events
           if e.device_type() == torch.autograd.DeviceType.CPU
           and e.start_thread_id() == thread and e.name() != label
           and a0 <= e.start_ns() <= a1]
    mids = [(s + t) // 2 for s, t in gaps]
    order = sorted(range(len(mids)), key=mids.__getitem__)
    names = _host_at(cpu, [mids[i] for i in order])
    idle = {}
    for i, n in zip(order, names):
        s, t = gaps[i]
        idle[n] = idle.get(n, 0.0) + (t - s) * 1e-9
    w.idle_gaps = idle

    bad = [f"{k}: profiler {w.launches[k]} launches, counter "
           f"{w.counted[k]}" for k in specs if w.launches[k] != w.counted[k]]
    if bad:
        w.ok, w.why = False, "; ".join(bad)
    elif least_s is not None and w.busy_s / calls < least_s:
        w.ok, w.why = False, (f"device time {w.busy_s / calls:.9f} s per "
                              f"call under its least time {least_s:.9f} s")
    return w


def top(d: dict, n: int = TOP) -> list:
    """The n largest entries of {name: seconds} as [[name, seconds]]."""
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
