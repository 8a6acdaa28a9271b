"""The program's spans in a traced window (portbench/spans.py) on
synthetic events: the attribution of device seconds to nested spans by
correlation, the window's bounds, the self-check that gates the span
metrics, and the readers of the plan's phases."""

import random

import pytest
import torch

from bmsparse_tpu_torch.utils import timing
from portbench import harness, spans

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA

# spans (ns): bmsp.a twice, bmsp.a.b nested in the first
RANGES = [(0, 100, "bmsp.a"), (10, 40, "bmsp.a.b"), (200, 300, "bmsp.a")]
LAUNCHES = [(1, 5),        # in a
            (2, 20),       # in a and a.b
            (3, 150),      # between the spans
            (4, 250),      # in a's second occurrence
            (5, 40)]       # at a.b's end, which is inside
DEVICE = [(1, 1.0), (2, 2.0), (2, 0.5), (3, 4.0), (4, 8.0), (5, 16.0),
          (9, 32.0)]       # 9: launched by no call seen


def test_attribution_nests_inclusively_by_correlation():
    got = spans.attribute(RANGES, LAUNCHES, DEVICE)
    assert set(got) == {"bmsp.a", "bmsp.a.b"}
    assert got["bmsp.a"]["count"] == 2
    assert got["bmsp.a"]["host_s"] == pytest.approx(200e-9)
    assert got["bmsp.a"]["device_s"] == pytest.approx(1 + 2.5 + 8 + 16)
    assert got["bmsp.a.b"]["count"] == 1
    assert got["bmsp.a.b"]["device_s"] == pytest.approx(2.5 + 16)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_attribution_ignores_the_order_of_events(seed):
    rng = random.Random(seed)
    r, lc, d = (rng.sample(x, len(x)) for x in (RANGES, LAUNCHES, DEVICE))
    assert spans.attribute(r, lc, d) == spans.attribute(RANGES, LAUNCHES,
                                                        DEVICE)


class Ev:
    """A kineto event as spans.read sees it (torch 2.11's: no activity
    type)."""

    def __init__(self, name, dev, s, e, corr=0, thread=7):
        self._v = (name, dev, s, e, corr, thread)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def start_thread_id(self):
        return self._v[5]


def _events():
    ns = 1_000_000_000
    return [
        Ev("portbench.w", CPU, 0, 10 * ns),
        Ev("bmsp.x", CPU, 1 * ns, 5 * ns),
        Ev("bmsp.x", CPU, 6 * ns, 7 * ns, thread=8),
        Ev("aten::add", CPU, 2 * ns, 3 * ns, corr=11),
        Ev("cudaLaunchKernel", CPU, 2 * ns, 2 * ns + 9, 21),
        Ev("cuLaunchKernel", CPU, 4 * ns, 4 * ns + 9, 22),
        Ev("cudaLaunchKernel", CPU, 8 * ns, 8 * ns + 9, 23),
        Ev("cudaMemsetAsync", CPU, -2 * ns, -ns, 24),
        Ev("k1", CUDA, 3 * ns, 4 * ns, 21),
        Ev("k2", CUDA, 9 * ns, 12 * ns, 22),         # clipped to 1 s
        Ev("k3", CUDA, 8 * ns, 9 * ns, 23),
        Ev("memset", CUDA, 0, ns // 2, 24),
        Ev("k4", CUDA, 3 * ns, 4 * ns, 11),          # a cpu op's id
        Ev("bmsp.x", CUDA, 3 * ns, 4 * ns, 21),       # a range's copy
        Ev("portbench.w", CUDA, 0, 10 * ns),
    ]


def test_read_keeps_to_the_window_and_its_thread():
    prog = spans.read(_events(), "portbench.w")
    assert prog.ok
    # k1 (launched inside bmsp.x), k2 clipped to the window's end
    assert prog.spans == {"bmsp.x": {"count": 1, "host_s": 4.0,
                                     "device_s": pytest.approx(2.0)}}
    # k1 1 s, k2 1 s, k3 1 s, the memset 0.5 s, k4 1 s; no range's copy
    assert prog.device_s == pytest.approx(4.5)
    # the memset's call lies before the window, k4's id is a cpu op's
    assert prog.unmatched_s == pytest.approx(1.5)


def test_read_without_its_window():
    prog = spans.read(_events(), "portbench.other")
    assert not prog.ok and "portbench.other" in prog.why


def _prog(**device_s):
    """A Program whose spans hold these device seconds, counts fixed."""
    count = {"bmsp.spmv": 20, "bmsp.cg": 4, "bmsp.cg.update": 200,
             "bmsp.product": 4}
    names = {k.replace("_", ".") if k.startswith("bmsp") else k: v
             for k, v in device_s.items()}
    total = names.pop("total")
    return spans.Program(
        spans={n: {"count": count.get(n, 20), "host_s": 0.0,
                   "device_s": s} for n, s in names.items()},
        device_s=total)


SOLVE = dict(total=1.0, bmsp_spmv=0.995, bmsp_spmv_sell=0.6,
             bmsp_spmv_overflow=0.1, bmsp_spmv_stream=0.2)
CG = dict(total=2.0, bmsp_cg=2.0, bmsp_cg_update=0.9)
PRODUCT = dict(total=1.0, bmsp_product=1.0, bmsp_product_decompress=0.25,
               bmsp_spgemm_products=0.05, bmsp_spgemm_compress=0.69)


@pytest.mark.parametrize("window,numbers,kernel_s,ok", [
    ("spmv", SOLVE, None, True),
    ("spmv", {**SOLVE, "bmsp_spmv": 0.98}, None, False),
    ("spmv", {"total": 1.0}, None, False),           # no bmsp.spmv
    ("requests", CG, None, True),
    ("requests", {**CG, "bmsp_cg": 1.9}, None, False),
    ("requests", {"total": 1.0}, None, True),        # PageRank's: no whole
    ("requests", PRODUCT, 0.0505, True),
    ("requests", PRODUCT, 0.06, False),              # products disagree
])
def test_self_check(window, numbers, kernel_s, ok):
    prog = spans.check(window, _prog(**numbers), kernel_s)
    assert prog.ok is ok and (prog.why == "") is ok


def test_span_metrics_per_call():
    programs = {"spmv": spans.check("spmv", _prog(**SOLVE)),
                "requests": spans.check("requests", _prog(**CG))}
    got = {n: spans.metric(n, programs) for n in spans.NAMES}
    assert got == pytest.approx({
        "spmv_dia_ms": None,
        "spmv_sell_ms": 0.7 / 20 * 1e3,
        "spmv_stream_ms": 0.2 / 20 * 1e3,
        "spmv_glue_ms": (0.995 - 0.9) / 20 * 1e3,
        "cg_vector_ms": 0.9 / 200 * 1e3,
        "product_decompress_ms": None,
        "product_compress_ms": None}, nan_ok=False)
    product = {"requests": spans.check("requests", _prog(**PRODUCT), 0.05)}
    assert spans.metric("product_decompress_ms", product) == \
        pytest.approx(0.25 / 4 * 1e3)
    assert spans.metric("product_compress_ms", product) == \
        pytest.approx(0.69 / 4 * 1e3)


class Rec:
    def __init__(self, windows):
        self._w = windows

    def window(self, name):
        return self._w.get(name)


PLAN = ["plan_coo_s", "plan_dia_s", "plan_stream_s", "plan_sell_s"]


def _reader(metric):
    return harness.load_module(harness.reader_path(metric),
                               f"test_reader_{metric}")


def test_a_failed_self_check_leaves_out_only_its_windows_span_metrics(
        monkeypatch):
    monkeypatch.setattr(timing, "kept", {f"plan.{m[5:-2]}": 1.5
                                         for m in PLAN})
    programs = {"spmv": spans.check("spmv", _prog(**SOLVE)),
                "requests": spans.check("requests",
                                        _prog(**{**CG, "bmsp_cg": 1.0}))}
    assert not programs["requests"].ok
    assert spans.metric("cg_vector_ms", programs) is None
    assert spans.metric("spmv_sell_ms", programs) is not None
    rec = Rec({"requests": object()})
    assert [_reader(m).read(rec) for m in PLAN] == [1.5] * 4


@pytest.mark.parametrize("metric", PLAN)
def test_plan_readers_need_their_window_and_their_phase(metric,
                                                        monkeypatch):
    phase = f"plan.{metric[5:-2]}"
    read = _reader(metric).read
    monkeypatch.setattr(timing, "kept", {phase: 2.5})
    assert read(Rec({"requests": object()})) == 2.5
    assert read(Rec({})) is None                   # no window: no card
    monkeypatch.setattr(timing, "kept", {})
    assert read(Rec({"requests": object()})) is None
    monkeypatch.delattr(timing, "kept")            # a program without it
    assert read(Rec({"requests": object()})) is None


@pytest.mark.parametrize("metric", spans.NAMES)
def test_span_metrics_need_their_window_and_their_spans(metric):
    window = "spmv" if metric.startswith("spmv") else "requests"
    requests = CG if metric.startswith("cg") else PRODUCT
    full = {"spmv": spans.check("spmv", _prog(**SOLVE, bmsp_spmv_dia=0.01)),
            "requests": spans.check("requests", _prog(**requests), 0.05)}
    assert spans.metric(metric, full) is not None
    assert spans.metric(metric, {k: v for k, v in full.items()
                                 if k != window}) is None
    assert spans.metric(metric, {window: spans.Program(
        spans={}, device_s=1.0)}) is None


@pytest.mark.gpu
def test_spans_read_on_the_card():
    """On the card's own profiler: each spmv's span holds its device work,
    its tiers nest in it, every operation finds its launch, and no span
    is copied onto the device's timeline."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile, record_function

    import bmsparse_tpu_torch as bt
    from bmsparse_tpu_torch.ops.cuda import build
    from bmsparse_tpu_torch.utils import testmats as tm

    build.load()
    r, c, v, shape = tm.roadnet(65536, seed=8)
    p = bt.prepare(bt.coo_to_bmsparse(r, c, v, shape, device="cuda"),
                   stream="off")
    x = torch.rand(shape[1], device="cuda")
    bt.spmv(p, x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("portbench.t"):
            for _ in range(5):
                bt.spmv(p, x)
            torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    prog = spans.check("spmv", spans.read(events, "portbench.t"))
    assert prog.ok, prog.why
    assert prog.unmatched_s == 0 and prog.device_s > 0
    assert {n: s["count"] for n, s in prog.spans.items()} == {
        "bmsp.spmv": 5, "bmsp.spmv.dia": 5, "bmsp.spmv.sell": 5,
        "bmsp.spmv.overflow": 5}
    assert not [e.name() for e in events if e.name().startswith("bmsp.")
                and e.device_type() == CUDA]
