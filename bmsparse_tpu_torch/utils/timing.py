"""Timing — counterpart of ``bmsparse_tpu/utils/timing.py``.

`PhaseTimer` keeps the reference's per-phase labels (T_1..T_9, "Toda F";
ref: src/bmSparse_SPGEMM.cu:835-853,951-957,1209-1220) with host clocks;
on a CUDA device each phase ends with a synchronisation of that device,
where the JAX package blocks on a result.

`time_op`: on a CUDA device the time of each run is taken between two
CUDA events recorded on the current stream, so it is device time, not
the time to enqueue; on the CPU it is the host clock around the call.
Like the package's other entry points it times on the card unless the
caller asks for the CPU, and raises where there is no card.

`sync` waits for a result on a CUDA device (JAX's block_until_ready).

`span` names a piece of the program's work on the profiler's timeline
(`bmsp.<name>`, on the clock of the device's events) while a profiler
records, and costs one check when none does. Set-up phases also keep
their host seconds in `kept`, profiler or not.
"""

from __future__ import annotations

import contextlib
import statistics
import time
from typing import Any

import torch

# A function-scope range, as an operator's: a record_function range is a
# user annotation, which the profiler also copies onto the device's
# timeline, where a reader that cannot see an event's type (torch 2.11's
# kineto events have none) would count it as device work.
_Range = torch._C._profiler._RecordFunctionFast
# host seconds of the set-up phases opened with span(name, keep=True),
# summed over the process's calls, by name
kept: dict[str, float] = {}

_OFF = contextlib.nullcontext()


def sync(x: Any = None):
    """Wait for the device work behind x (a tensor, or anything with a
    `device`, such as a BmSparse) where it lives on a CUDA device; return
    x."""
    device = getattr(x, "device", None)
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return x


def span(name: str, keep: bool = False):
    """A context naming the work inside it `bmsp.<name>` on the timeline
    of a profiler that records; where none records, one shared no-op
    context, with no range and no clock read.
    keep=True (set-up phases only): also add the block's host seconds to
    kept[name], whether or not a profiler records."""
    if keep:
        return _kept(name)
    if not torch._C._autograd._profiler_enabled():
        return _OFF
    return _Range("bmsp." + name)


@contextlib.contextmanager
def _kept(name: str):
    t0 = time.perf_counter()
    with span(name):
        yield
    kept[name] = kept.get(name, 0.0) + time.perf_counter() - t0


class PhaseTimer:
    """Collects labelled phase durations in microseconds. `device`: where
    the timed work runs; a CUDA device is synchronised at the end of each
    phase while the timer is enabled (a disabled timer costs nothing)."""

    def __init__(self, enabled: bool = True, device=None):
        self.enabled = enabled
        self.device = torch.device(device or "cpu")
        self.phases: dict[str, float] = {}
        self._t0 = time.perf_counter()

    @contextlib.contextmanager
    def phase(self, label: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.enabled and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            dt = (time.perf_counter() - t0) * 1e6
            self.phases[label] = self.phases.get(label, 0.0) + dt

    def total_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def report(self, stream=None) -> None:
        if not self.enabled:
            return
        emit = print if stream is None else (lambda s: stream.write(s + "\n"))
        for label, us in self.phases.items():
            emit(f"{label}: {us:.0f}")
        emit(f"Toda F: {self.total_us():.0f}")


def time_op(fn, *args, warmup: int = 1, iters: int = 10,
            device="cuda", **kw) -> tuple[float, Any]:
    """Median time in seconds of fn(*args, **kw) over `iters` runs after
    `warmup` runs, and the last result. `device` names where fn runs
    ("cuda", "cuda:1", "cpu"; default "cuda", which raises where no CUDA
    device exists: CPU work passes device="cpu")."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("time_op: no CUDA device; pass device='cpu' to "
                           "time CPU work")
    out = None
    for _ in range(max(warmup, 1)):
        out = fn(*args, **kw)
    times = []
    if device.type == "cuda":
        with torch.cuda.device(device):
            torch.cuda.synchronize()
            for _ in range(iters):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(*args, **kw)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end) / 1e3)
    else:
        for _ in range(iters):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            times.append(time.perf_counter() - t0)
    return statistics.median(times), out
