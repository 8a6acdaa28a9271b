"""The port's spans (utils/timing.py::span): no profiler range and no
clock read while no profiler records; under one, one `bmsp.*` range per
call of each piece of work, nested as the calls are; the same outputs
either way; and prepare's set-up phases kept in `timing.kept`."""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile

import bmsparse_tpu_torch as bt
from bmsparse_tpu_torch.examples import cg as cg_t
from bmsparse_tpu_torch.ops.plan import prepare
from bmsparse_tpu_torch.utils import testmats as tm
from bmsparse_tpu_torch.utils import timing

PLAN_PHASES = {"plan.coo", "plan.dia", "plan.stream", "plan.sell"}


@pytest.fixture
def kept(monkeypatch):
    d = {}
    monkeypatch.setattr(timing, "kept", d)
    return d


def _profiled(fn):
    """fn()'s result and the bmsp.* ranges it opened, (start, end, name)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    ranges = [(e.start_ns(), e.end_ns(), e.name())
              for e in prof.profiler.kineto_results.events()
              if e.name().startswith("bmsp.")]
    return out, ranges


def _named(ranges, name):
    return [r for r in ranges if r[2] == name]


def _inside(inner, outer):
    """Each range of `inner` lies within one range of `outer`."""
    return all(any(o0 <= s and t <= o1 for o0, o1, _ in outer)
               for s, t, _ in inner)


def _same(a, b):
    if isinstance(a, (tuple, list)):
        return all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return all(torch.equal(getattr(a, f), getattr(b, f))
               for f in ("brow", "bcol", "bmp_hi", "bmp_lo", "offsets",
                         "values"))


@pytest.mark.parametrize("keep", [False, True])
def test_no_profiler_no_range(keep, kept, monkeypatch):
    entered = []          # the ranges opened

    def counting(name):
        entered.append(name)
        return timing._OFF

    monkeypatch.setattr(timing, "_Range", counting)
    with timing.span("work", keep=keep):
        pass
    assert entered == []
    assert set(kept) == ({"work"} if keep else set())
    assert timing.span("a") is timing.span("b") is timing._OFF


@pytest.mark.parametrize("keep", [False, True])
def test_profiler_sees_a_named_range(keep, kept):
    def work():
        with timing.span("work", keep=keep):
            pass

    _, ranges = _profiled(work)
    assert [r[2] for r in ranges] == ["bmsp.work"]
    assert set(kept) == ({"work"} if keep else set())


def test_a_span_is_no_user_annotation():
    """A user annotation (record_function) is also copied onto the
    device's timeline; a span, like an operator, is not."""
    def work():
        with timing.span("work"):
            pass

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        work()
    kinds = [e.activity_type() for e in prof.profiler.kineto_results.events()
             if e.name() == "bmsp.work"]
    assert kinds == ["cpu_op"]


def _roadnet():
    r, c, v, shape = tm.roadnet(65536, seed=8)
    return prepare(bt.coo_to_bmsparse(r, c, v, shape, device="cpu"),
                   stream="off")


def _web():
    r, c, v, shape = tm.webgraph(4096, avg_deg=6, seed=9)
    return prepare(bt.coo_to_bmsparse(r, c, v, shape, device="cpu"),
                   stream="force")


@pytest.mark.parametrize("case,tiers", [
    (_roadnet, {"dia", "sell", "overflow"}),
    (_web, {"stream"}),
], ids=["dia-sell-overflow", "stream"])
def test_spmv_spans_each_call_and_its_tiers(case, tiers):
    p = case()
    present = {"dia": p.dia is not None, "sell": bool(p.sell_ks),
               "overflow": bool(p.ovf_ks), "stream": p.stream is not None}
    assert {t for t, on in present.items() if on} == tiers
    v = torch.from_numpy(np.random.default_rng(3).standard_normal(
        p.m.num_cols).astype(np.float32))
    calls = 3
    plain = [bt.spmv(p, v) for _ in range(calls)]
    out, ranges = _profiled(lambda: [bt.spmv(p, v) for _ in range(calls)])
    assert _same(out, plain)
    whole = _named(ranges, "bmsp.spmv")
    assert len(whole) == calls
    for t in ("dia", "sell", "overflow", "stream"):
        got = _named(ranges, f"bmsp.spmv.{t}")
        assert len(got) == (calls if t in tiers else 0), t
        assert _inside(got, whole), t


def test_cg_spans_the_solve_and_each_update():
    n, iters = 512, 7
    p, b = cg_t.setup(n, "cpu")
    plain = cg_t.cg(p, b, iters)
    out, ranges = _profiled(lambda: cg_t.cg(p, b, iters))
    assert _same(out, plain)
    solve = _named(ranges, "bmsp.cg")
    update = _named(ranges, "bmsp.cg.update")
    spmvs = _named(ranges, "bmsp.spmv")
    assert len(solve) == 1
    assert len(update) == len(spmvs) == iters
    assert _inside(update, solve) and _inside(spmvs, solve)
    assert not _inside(spmvs[:1], update)     # the spmv is not an update


def test_product_spans_decompress_products_and_compress():
    n = 1024
    r, c, v = tm.make_banded(n, 4, seed=5)
    a = bt.coo_to_bmsparse(r, c, v, (n, n), device="cpu")
    b = bt.coo_to_bmsparse(r, c, v, (n, n), transposed=True, device="cpu")
    pp = bt.prepare_product(a, b)
    plain = pp(a, b)
    out, ranges = _profiled(lambda: pp(a, b))
    assert _same(out, plain)
    whole = _named(ranges, "bmsp.product")
    assert len(whole) == 1
    for name in ("bmsp.product.decompress", "bmsp.spgemm.products",
                 "bmsp.spgemm.compress"):
        got = _named(ranges, name)
        assert len(got) == 1 and _inside(got, whole), name


def test_prepare_keeps_its_phases(kept):
    r, c, v, shape = tm.roadnet(16384, seed=8)
    m = bt.coo_to_bmsparse(r, c, v, shape, device="cpu")
    t0 = time.perf_counter()
    prepare(m)
    host = time.perf_counter() - t0
    assert set(kept) == PLAN_PHASES
    assert all(s >= 0 for s in kept.values())
    assert sum(kept.values()) <= host
