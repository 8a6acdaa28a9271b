#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (bmsparse_tpu_torch) on one NVIDIA
card: builds the kernels from csrc/, holds each against its plain torch
version at the shapes the main paths give it, drives the two main paths
through the public API —
  SpMV   (MatrixMarket / COO -> BmSparse -> prepare -> spmv) on Ragusa16,
         stencil2M and road1M;
  SpGEMM (COO -> BmSparse A and transposed B -> spgemm(A, B) and
         prepare_product(A, B)()) A*A on Ragusa16, blockdense64k, band2M
         and fem1M —
checks the results against scipy in float64 and against the plain path on
the card, shows from the launch counters that each path ran through its
kernels, and times kernel and plain paths with CUDA events.

    python3 chip_smoke.py

Needs a CUDA device; exits non-zero without one, or when any check
fails. The last line of its output is
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}
and the line before it lists the kernels as JSON.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

TOL = dict(rtol=1e-5, atol=1e-5)   # kernel vs plain: only the sum order differs
ORACLE_REL = 1e-4                  # vs scipy float64, max|u - ref| / max|ref|
WARMUP, ITERS = 3, 20


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, torch) -> float:
    from bmsparse_tpu_torch.utils.timing import time_op

    t, _ = time_op(fn, warmup=WARMUP, iters=ITERS, device="cuda")
    return t * 1e3


def device_profile(fn, torch, iters: int = 10):
    """Device time of fn per call from a torch.profiler trace of `iters`
    back-to-back calls (a run separate from the timed ones): (busy ms,
    span ms), busy being the summed device activity and span the device
    interval from the first activity to the last; None where the profiler
    recorded no device activity."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events()
           if getattr(e, "device_type", None) is not None
           and e.device_type.name == "CUDA"]
    if not evs:
        return None
    busy = sum(e.time_range.end - e.time_range.start for e in evs)
    span = (max(e.time_range.end for e in evs)
            - min(e.time_range.start for e in evs))
    return busy / iters / 1e3, span / iters / 1e3


def device_top(fn, torch, iters: int = 5, top: int = 8) -> str:
    """The `top` device operations of fn by self device time per call,
    from a torch.profiler trace of `iters` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0)
        if t > 0:
            rows.append((t / iters / 1e3, e.key))
    rows.sort(reverse=True)
    if not rows:
        return "not measured (no profiler activity)"
    return "; ".join(f"{name[:60]} {ms!r} ms" for ms, name in rows[:top])


def profile_text(prof) -> str:
    if prof is None:
        return "device time not measured (no profiler activity)"
    busy, span = prof
    return (f"device busy {busy!r} ms per call, idle share "
            f"{1 - busy / span!r} of back-to-back calls")


def max_abs(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def phase1_kernels(torch, dev):
    """Each kernel against its plain version at main-path shapes."""
    from bmsparse_tpu_torch.ops.cuda import sell_kernel as sk
    from bmsparse_tpu_torch.ops.cuda.sell_kernel import (
        sell_window, sell_window_plain,
    )
    from bmsparse_tpu_torch.ops.cuda.spmv_kernel import (
        dia_spmv, dia_spmv_plain,
    )

    g = torch.Generator(device=dev).manual_seed(1234)
    errs = {"dia_spmv": 0.0, "sell_window": 0.0}
    n = 2_097_152
    v = torch.randn(n, generator=g, device=dev)
    for offs in (tuple(range(-8, 9)), (-300, -129, -1, 0, 1, 128, 257)):
        for dt in (torch.float32, torch.bfloat16):
            # the stencil2M DIA tier: (17, 16384, 128)
            dia = torch.randn((len(offs), 16384, 128), generator=g,
                              device=dev).to(dt)
            got = dia_spmv(dia, v, offs)
            want = dia_spmv_plain(dia, v, offs)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, **TOL)
            err = max_abs(got, want)
            errs["dia_spmv"] = max(errs["dia_spmv"], err)
            print(f"phase1 dia_spmv nd={len(offs)} R=16384 {dt}: "
                  f"max_abs_err={err!r}")
    n = 1_048_576
    v = torch.randn(n, generator=g, device=dev)
    for cw, cap in ((8, 256), (64, 64)):
        kg = 24                    # as deep as road1M's first K-group
        ncu = -(-n // cw)
        hi = sk.ncu_padded(ncu) - sk.WINDOW_UNITS
        ws = torch.randint(0, hi + 1, (cap,), generator=g, device=dev,
                           dtype=torch.int32)
        ws[-1] = hi                # a window that runs past the end of v
        rel = torch.randint(0, sk.WINDOW_UNITS, (cap, kg, 128), generator=g,
                            device=dev, dtype=torch.int32)
        dense = torch.randn((cw, cap, kg, 8, 128), generator=g, device=dev)
        dense *= torch.rand(dense.shape, generator=g, device=dev) < 0.05
        for dt in (torch.float32, torch.bfloat16):
            d = dense.to(dt)
            got = sell_window(d, rel, ws, v, cw, n)
            want = sell_window_plain(d, rel, ws, v, cw, n)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, **TOL)
            err = max_abs(got, want)
            errs["sell_window"] = max(errs["sell_window"], err)
            print(f"phase1 sell_window cw={cw} cap={cap} kg={kg} {dt}: "
                  f"max_abs_err={err!r}")
    return errs


def phase1_spgemm_kernels(torch, dev):
    """The SpGEMM kernels against their plain versions, at the slot-table
    shapes of blockdense64k (numeric_sell) and band2M (numeric_window)."""
    from bmsparse_tpu_torch.ops.cuda.spgemm_kernel import (
        numeric_sell, numeric_sell_plain,
    )
    from bmsparse_tpu_torch.ops.cuda.spgemm_window_kernel import (
        _SENT_REL, W_MAX, numeric_window, numeric_window_plain,
    )

    g = torch.Generator(device=dev).manual_seed(4321)
    errs = {"numeric_sell": 0.0, "numeric_window": 0.0}

    def slots(nb, shape, sentinel):
        t = torch.randint(0, nb, shape, generator=g, device=dev,
                          dtype=torch.int32)
        t[torch.rand(shape, generator=g, device=dev) < 0.2] = sentinel
        return t

    nb = 40_960                  # blockdense64k's blocks per operand
    a = torch.randn((nb, 64), generator=g, device=dev)
    b = torch.randn((nb, 64), generator=g, device=dev)
    for k, ch in ((1, 1600), (2, 16), (3, 64), (16, 64)):
        ta, tb = slots(nb, (ch, k, 128), nb), slots(nb, (ch, k, 128), nb)
        for dt in (torch.float32, torch.bfloat16):
            args = (a.to(dt), b.to(dt), ta, tb)
            got = numeric_sell(*args)
            want = numeric_sell_plain(*args)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, **TOL)
            err = max_abs(got, want)
            errs["numeric_sell"] = max(errs["numeric_sell"], err)
            print(f"phase1 numeric_sell nb={nb} ch={ch} K={k} {dt}: "
                  f"max_abs_err={err!r}")
    nb = 786_432                 # band2M's blocks per operand
    nb_pad = max(-(-(nb + 1) // 128) * 128, W_MAX)
    a = torch.randn((nb, 64), generator=g, device=dev)
    b = torch.randn((nb, 64), generator=g, device=dev)
    for k, w, t_real, ntiles in ((3, 4096, 8, 256), (2, 2048, 4, 512),
                                 (1, 256, 1, 512)):
        ws = [torch.randint(0, (nb_pad - w) // 128 + 1, (ntiles,),
                            generator=g, device=dev, dtype=torch.int32) * 128
              for _ in range(2)]
        for x in ws:
            x[-1] = nb_pad - w   # a window that runs past the table's end
        ra, rb = (slots(w, (ntiles, k, 8, 128), _SENT_REL) for _ in range(2))
        for dt in (torch.float32, torch.bfloat16):
            args = (a.to(dt), b.to(dt), ra, rb, ws[0], ws[1], k, t_real)
            got = numeric_window(*args)
            want = numeric_window_plain(*args)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, **TOL)
            err = max_abs(got, want)
            errs["numeric_window"] = max(errs["numeric_window"], err)
            print(f"phase1 numeric_window nb={nb} ntiles={ntiles} K={k} "
                  f"W={w} t_real={t_real} {dt}: max_abs_err={err!r}")
    return errs


def matrices():
    """(name, loader) pairs; each loader makes the matrix on the card
    through the port's entry points."""
    import bmsparse_tpu_torch as bt
    from bmsparse_tpu_torch.utils.testmats import make_stencil, roadnet

    here = os.path.dirname(os.path.abspath(__file__))

    def ragusa():
        return bt.mmread_bmsparse(
            os.path.join(here, "data", "real", "A_matrix.mtx"), device="cuda")

    def stencil():
        n = 2_097_152
        r, c, v = make_stencil(n, 8, seed=6)
        return bt.coo_to_bmsparse(r, c, v, (n, n), device="cuda")

    def road():
        r, c, v, shape = roadnet(1_048_576, seed=8)
        return bt.coo_to_bmsparse(r, c, v, shape, device="cuda")

    return [("Ragusa16", ragusa), ("stencil2M", stencil), ("road1M", road)]


def phase2_main_path(torch):
    """The slice through the public API, with launch counts."""
    import bmsparse_tpu_torch as bt
    from bmsparse_tpu_torch.ops.cuda.sell_kernel import sell_window
    from bmsparse_tpu_torch.ops.cuda.spmv_kernel import dia_spmv

    launches = {"dia_spmv": 0, "sell_window": 0}
    runs = {}
    for name, load in matrices():
        dia_spmv.launches = sell_window.launches = 0
        t0 = time.perf_counter()
        m = load()
        t1 = time.perf_counter()
        p = bt.prepare(m)
        t2 = time.perf_counter()
        # v as bench.py makes it
        v_np = np.random.default_rng(0).standard_normal(
            m.num_cols).astype(np.float32)
        v = torch.from_numpy(v_np).to("cuda")
        u = bt.spmv(p, v)
        torch.cuda.synchronize()
        counts = {"dia_spmv": dia_spmv.launches,
                  "sell_window": sell_window.launches}
        for k in launches:
            launches[k] += counts[k]
        nwin = sum(r is not None for r in p.sell_rel)
        cw = p.sell_dense[0].shape[0] if p.sell_dense else 0
        print(f"phase2 {name}: n={m.num_rows} nnz={m.nnz} blocks={m.nb} "
              f"load={t1 - t0:.3f}s prepare={t2 - t1:.3f}s "
              f"ndiags={len(p.dia_offsets)} sell_ks={p.sell_ks} cw={cw} "
              f"windowed_groups={nwin}/{len(p.sell_ks)} ovf_ks={p.ovf_ks} "
              f"launches={counts}")
        check(u.is_cuda and u.shape == (m.num_rows,)
              and bool(torch.isfinite(u).all()), f"{name}: output")
        ref = m.to_scipy() @ v_np.astype(np.float64)
        rel = float(np.abs(u.cpu().double().numpy() - ref).max()
                    / max(np.abs(ref).max(), 1e-30))
        print(f"phase2 {name}: max|u-ref|/max|ref| vs scipy float64 = {rel!r}")
        check(rel <= ORACLE_REL, f"{name}: error {rel} vs scipy")
        u_plain = bt.spmv(p, v, impl="plain")
        torch.testing.assert_close(u, u_plain, **TOL)
        print(f"phase2 {name}: max_abs_err vs plain on the card = "
              f"{max_abs(u, u_plain)!r}")
        if name != "Ragusa16":
            check(counts["dia_spmv"] > 0, f"{name}: DIA kernel not launched")
        if name == "road1M":
            check(counts["sell_window"] > 0,
                  "road1M: SELL window kernel not launched")
            check(nwin > 0 and p.ovf_ks,
                  "road1M: expected windowed groups and overflow slots")
        runs[name] = (m, p, v)
    return launches, runs


def spgemm_matrices():
    """(name, loader) pairs for A*A; each loader makes A and the
    transposed B on the card through the port's entry points, as bench.py
    builds them."""
    import bmsparse_tpu_torch as bt
    from bmsparse_tpu_torch.utils.testmats import (
        fem2d, make_banded, make_blockdense,
    )

    here = os.path.dirname(os.path.abspath(__file__))

    def pair(r, c, v, shape):
        return (bt.coo_to_bmsparse(r, c, v, shape, device="cuda"),
                bt.coo_to_bmsparse(r, c, v, shape, transposed=True,
                                   device="cuda"))

    def ragusa():
        return pair(*bt.read_matrix_market(
            os.path.join(here, "data", "real", "A_matrix.mtx")))

    def square(gen, n):
        return lambda: pair(*gen(), (n, n))

    return [
        ("Ragusa16", ragusa),
        ("blockdense64k", square(
            lambda: make_blockdense(65_536, 40_960, seed=3), 65_536)),
        ("band2M", square(lambda: make_banded(2_097_152, 16, seed=4),
                          2_097_152)),
        ("fem1M", lambda: pair(*fem2d(1024, seed=7))),
    ]


def count_syncs(fn, torch) -> list:
    """The places (file:line) of the host syncs torch reports while fn
    runs (CUDA sync debug mode)."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [f"{os.path.basename(w.filename)}:{w.lineno}" for w in seen
            if "called a synchronizing CUDA operation" in str(w.message)]


def same_c(c, cp):
    """C equals the plain path's C: structure exactly, values to TOL."""
    import torch

    check(c.nb == cp.nb and c.nnz == cp.nnz, "C block count or nnz differs")
    for f in ("brow", "bcol", "bmp_hi", "bmp_lo", "offsets"):
        check(torch.equal(getattr(c, f), getattr(cp, f)), f"C.{f} differs")
    torch.testing.assert_close(c.values, cp.values, **TOL)


def phase2_spgemm(torch):
    """SpGEMM A*A through the public API, with launch counts."""
    import bmsparse_tpu_torch as bt
    from bmsparse_tpu_torch.ops.cuda.spgemm_kernel import numeric_sell
    from bmsparse_tpu_torch.ops.cuda.spgemm_window_kernel import (
        numeric_window,
    )

    launches = {"numeric_sell": 0, "numeric_window": 0}
    runs = {}
    for name, load in spgemm_matrices():
        t0 = time.perf_counter()
        a, b = load()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        numeric_sell.launches = numeric_window.launches = 0
        c = bt.spgemm(a, b)
        pp = bt.prepare_product(a, b)
        c2 = pp()
        torch.cuda.synchronize()
        counts = {"numeric_sell": numeric_sell.launches,
                  "numeric_window": numeric_window.launches}
        t2 = time.perf_counter()
        for k in launches:
            launches[k] += counts[k]
        syncs = (count_syncs(lambda: bt.spgemm(a, b), torch),
                 count_syncs(pp, torch))
        print(f"phase2 spgemm {name}: host syncs of one-shot spgemm() "
              f"{syncs[0]}, of the cached pp() {syncs[1]}")
        check(len(syncs[0]) == 2 and not syncs[1],
              f"{name}: spgemm() must sync twice (task total, plan packet) "
              f"and pp() never, got {syncs}")
        p = pp.plan
        routes = [("numeric_window" if w is not None else "numeric_sell",
                   kg, c1 - c0) for (kg, c0, c1), w in zip(p.groups, p.pwin)]
        print(f"phase2 spgemm {name}: n={a.num_rows} nnz(A)={a.nnz} "
              f"blocks(A)={a.nb} tasks={p.num_tasks} "
              f"pruned={p.num_tasks - p.num_alive} C blocks={c.nb} "
              f"nnz(C)={c.nnz} load={t1 - t0:.3f}s "
              f"spgemm+prepare_product+call={t2 - t1:.3f}s "
              f"launches={counts}")
        print(f"phase2 spgemm {name}: K-groups (kernel, K, chunks) {routes}; "
              f"tile windows {p.pwin}")
        check(c.values.is_cuda and c.values.dtype == torch.float32
              and c.values.shape[0] >= c.nnz
              and bool(torch.isfinite(c.values).all()), f"{name}: output")
        same_c(c, c2)
        cp = bt.spgemm(a, b, impl="plain")
        same_c(c, cp)
        print(f"phase2 spgemm {name}: structure equal to the plain path's, "
              f"max_abs_err vs plain on the card = "
              f"{max_abs(c.values, cp.values)!r}")
        a_sp = a.to_scipy().tocsr()
        ref = (a_sp @ b.to_scipy().tocsr()).tocsr()
        mre = bt.mean_relative_error(c, ref)
        diff = abs(c.to_scipy().tocsr() - ref)
        ref_max = float(abs(ref).max()) if ref.nnz else 0.0
        rel = (float(diff.max()) if diff.nnz else 0.0) / max(ref_max, 1e-30)
        print(f"phase2 spgemm {name}: vs scipy float64: mean relative error "
              f"{mre!r}, max|C-ref|/max|ref| {rel!r}, nnz(C)={c.nnz} "
              f"nnz(ref)={ref.nnz}")
        check(mre < 1e-5, f"{name}: mean relative error {mre}")
        check(c.nnz >= ref.nnz, f"{name}: nnz(C) below scipy's")
        check(rel <= 1e-4, f"{name}: max error {rel} vs scipy")
        n_win = sum(w is not None for w in p.pwin)
        check(counts["numeric_window"] == 2 * n_win
              and counts["numeric_sell"] == 2 * (len(p.groups) - n_win),
              f"{name}: a K-group did not launch its kernel")
        if name == "blockdense64k":
            check(counts["numeric_sell"] > 0 and n_win == 0,
                  "blockdense64k: expected numeric_sell and no tile window")
        if name == "band2M":
            check(counts["numeric_window"] > 0,
                  "band2M: numeric_window not launched")
        runs[name] = (a, b, c, pp)
        del cp, c2, ref, diff, a_sp
    return launches, runs


def phase3_spgemm_times(torch, runs, card):
    """Per matrix: one-shot spgemm, the cached numeric call on kernels and
    on plain torch, its roofline share and device profile; then each
    kernel alone against its plain version."""
    import bmsparse_tpu_torch as bt
    from bmsparse_tpu_torch.ops.cuda.spgemm_kernel import (
        numeric_sell, numeric_sell_plain,
    )
    from bmsparse_tpu_torch.ops.cuda.spgemm_window_kernel import (
        numeric_window, numeric_window_plain,
    )
    from bmsparse_tpu_torch.utils import roofline as rl

    bw = rl.device_hbm_gbps(torch.cuda.get_device_name(0))
    for name in ("blockdense64k", "band2M", "fem1M"):
        a, b, c, pp = runs[name]
        pp_plain = bt.prepare_product(a, b, impl="plain")
        t_e2e = median_ms(lambda: bt.spgemm(a, b), torch)
        t_k = median_ms(pp, torch)
        t_p = median_ms(pp_plain, torch)
        p = pp.plan
        line = (f"phase3 spgemm {name}: one-shot spgemm {t_e2e!r} ms; cached "
                f"pp() kernels {t_k!r} ms ({c.nnz / t_k / 1e6!r} Gnnz(C)/s), "
                f"plain {t_p!r} ms ({c.nnz / t_p / 1e6!r} Gnnz(C)/s)")
        if bw is not None:
            min_b = rl.spgemm_min_bytes(a.nnz, a.nb, b.nnz, b.nb, p.num_tasks,
                                        c.nnz, c.nb)
            t_min = min_b / (bw * 1e9) * 1e3
            line += (f"; spgemm_min_bytes {min_b} = {t_min!r} ms at {bw} "
                     f"GB/s, pp() kernels at {t_min / t_k!r} of it")
        print(line + f" [{card}]")
        for what, fn in (("kernels", pp), ("plain", pp_plain)):
            prof = device_profile(fn, torch)
            print(f"phase3 spgemm {name} pp() {what}: {profile_text(prof)} "
                  f"(torch.profiler) [{card}]")
        print(f"phase3 spgemm {name} one-shot spgemm phases (µs, host "
              f"clock, each phase ends with a CUDA sync):")
        bt.spgemm(a, b, verbose=True)
        print(f"phase3 spgemm {name} pp() kernels, device time per call by "
              f"operation: {device_top(pp, torch)} [{card}]")
        del pp_plain

    kernels = []
    for kname, mname, fn, plain in (
            ("numeric_sell", "blockdense64k", numeric_sell, numeric_sell_plain),
            ("numeric_window", "band2M", numeric_window,
             numeric_window_plain)):
        p = runs[mname][3].plan
        win = kname == "numeric_window"
        calls = [
            (p.tas[g], p.tbs[g]) + ((*p.pws[g], kg, p.pwin[g][2]) if win
                                    else ())
            for g, (kg, _, _) in enumerate(p.groups)
            if (p.pwin[g] is not None) == win]

        def run_groups(f, calls=calls, p=p):
            return [f(p.a_flat, p.b_flat, *args) for args in calls]

        t_k = median_ms(lambda: run_groups(fn), torch)
        t_p = median_ms(lambda: run_groups(plain), torch)
        print(f"phase3 {kname} {mname} ({len(calls)} K-groups): kernel "
              f"{t_k!r} ms, plain {t_p!r} ms [{card}]")
        for what, f in (("kernel", fn), ("plain", plain)):
            prof = device_profile(lambda: run_groups(f), torch)
            print(f"phase3 {kname} {mname} {what}: {profile_text(prof)} "
                  f"(torch.profiler) [{card}]")
        kernels.append((kname, t_k, t_p))
    return kernels


def phase3_times(torch, runs, card):
    """Kernel path against plain path, per matrix and per kernel."""
    import bmsparse_tpu_torch as bt
    from bmsparse_tpu_torch.ops.cuda.sell_kernel import (
        sell_window, sell_window_plain,
    )
    from bmsparse_tpu_torch.ops.cuda.spmv_kernel import (
        dia_spmv, dia_spmv_plain,
    )
    from bmsparse_tpu_torch.ops.plan import cast_prepared
    from bmsparse_tpu_torch.utils import roofline as rl

    bw = rl.device_hbm_gbps(torch.cuda.get_device_name(0))
    print(f"phase3 card: {card}; peak bandwidth "
          f"{'unknown (no roofline)' if bw is None else f'{bw} GB/s'}; "
          f"CUDA events, {WARMUP} warm-up runs, median of {ITERS}")
    cases = [(name, runs[name][1], "float32") for name in ("stencil2M",
                                                            "road1M")]
    cases.append(("stencil2M", cast_prepared(runs["stencil2M"][1],
                                             torch.bfloat16), "bfloat16"))
    for name, p, dt in cases:
        m, _, v = runs[name]
        if dt == "bfloat16":
            torch.testing.assert_close(bt.spmv(p, v),
                                       bt.spmv(p, v, impl="plain"), **TOL)
        t_k = median_ms(lambda: bt.spmv(p, v), torch)
        t_p = median_ms(lambda: bt.spmv(p, v, impl="plain"), torch)
        line = (f"phase3 spmv {name} {dt}: kernels {t_k!r} ms "
                f"({m.nnz / t_k / 1e6!r} Gnnz/s), plain {t_p!r} ms "
                f"({m.nnz / t_p / 1e6!r} Gnnz/s)")
        if bw is not None and dt == "float32":
            roof = rl.roofline_nnz_per_s(
                rl.spmv_min_bytes(m.nnz, m.nb, m.num_rows, m.num_cols),
                m.nnz, bw)
            line += (f"; roofline {roof / 1e9!r} Gnnz/s, kernels at "
                     f"{m.nnz / (t_k / 1e3) / roof!r} of it")
        print(line + f" [{card}]")
        for impl in ("auto", "plain"):
            prof = device_profile(lambda: bt.spmv(p, v, impl=impl), torch)
            print(f"phase3 spmv {name} {dt} {impl}: {profile_text(prof)} "
                  f"(torch.profiler) [{card}]")

    kernels = []
    p = runs["stencil2M"][1]
    vpad = runs["stencil2M"][2]
    for dia, dt in ((p.dia, "float32"), (p.dia.to(torch.bfloat16),
                                          "bfloat16")):
        t_k = median_ms(lambda: dia_spmv(dia, vpad, p.dia_offsets), torch)
        t_p = median_ms(lambda: dia_spmv_plain(dia, vpad, p.dia_offsets),
                        torch)
        gbs = (dia.numel() * dia.element_size() + 2 * 4 * vpad.numel()) \
            / (t_k / 1e3) / 1e9
        print(f"phase3 dia_spmv stencil2M {tuple(dia.shape)} {dt}: kernel "
              f"{t_k!r} ms ({gbs!r} GB/s of strip + v + u), plain {t_p!r} ms"
              f" [{card}]")
        for what, fn in (("kernel", dia_spmv), ("plain", dia_spmv_plain)):
            prof = device_profile(lambda: fn(dia, vpad, p.dia_offsets), torch)
            print(f"phase3 dia_spmv stencil2M {dt} {what}: "
                  f"{profile_text(prof)} (torch.profiler) [{card}]")
        if dt == "float32":
            kernels.append(("dia_spmv", t_k, t_p))

    m, p, v = runs["road1M"]
    n = m.block_cols * 8
    vpad = torch.zeros(n, device="cuda")
    vpad[: v.shape[0]] = v
    groups = [(d, r, w) for d, r, w in zip(p.sell_dense, p.sell_rel,
                                           p.sell_ws) if r is not None]

    def run_groups(fn):
        return [fn(d, r, w, vpad, d.shape[0], n) for d, r, w in groups]

    t_k = median_ms(lambda: run_groups(sell_window), torch)
    t_p = median_ms(lambda: run_groups(sell_window_plain), torch)
    shapes = [tuple(d.shape) for d, _, _ in groups]
    slab = sum(d.numel() * d.element_size() for d, _, _ in groups)
    print(f"phase3 sell_window road1M windowed groups {shapes} ({slab!r} "
          f"bytes of slabs): kernel {t_k!r} ms, plain {t_p!r} ms [{card}]")
    for what, fn in (("kernel", sell_window), ("plain", sell_window_plain)):
        prof = device_profile(lambda: run_groups(fn), torch)
        print(f"phase3 sell_window road1M {what}: {profile_text(prof)} "
              f"(torch.profiler) [{card}]")
    kernels.append(("sell_window", t_k, t_p))
    return kernels


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing run",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")

    # ---- phase 0: setup ------------------------------------------------
    from bmsparse_tpu_torch.ops.cuda import build

    t0 = time.perf_counter()
    build.load()
    print(f"phase0 kernels built and loaded in "
          f"{time.perf_counter() - t0:.1f}s (nvcc "
          f"{build.build_seconds if build.build_seconds is not None else 0.0:.1f}s)"
          f": {build.library_path().name}")
    for line in build.build_log().splitlines():
        if "ptxas info" in line and ("Used" in line or "Compiling" in line):
            print("phase0", line.strip())
    card = card_line()
    print(f"phase0 card (nvidia-smi name, power.limit): {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("phase0 torch.backends.cuda.matmul.allow_tf32 = "
          f"{torch.backends.cuda.matmul.allow_tf32}, "
          f"torch.backends.cudnn.allow_tf32 = {torch.backends.cudnn.allow_tf32}")
    print(f"phase0 torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    errs = phase1_kernels(torch, dev)
    errs.update(phase1_spgemm_kernels(torch, dev))
    launches, runs = phase2_main_path(torch)
    print(f"phase2 launches on the SpMV path: {launches}")
    spgemm_launches, spgemm_runs = phase2_spgemm(torch)
    print(f"phase2 launches on the SpGEMM path: {spgemm_launches}")
    launches.update(spgemm_launches)
    check(all(n > 0 for n in launches.values()),
          f"a kernel of the paths was not launched: {launches}")
    times = phase3_times(torch, runs, card)
    del runs
    times += phase3_spgemm_times(torch, spgemm_runs, card)

    replaces = {
        "dia_spmv": ("bmsparse_tpu_torch/csrc/dia_spmv.cu",
                     "bmsparse_tpu/ops/pallas/spmv_kernel.py:62"),
        "sell_window": ("bmsparse_tpu_torch/csrc/sell_window.cu",
                        "bmsparse_tpu/ops/pallas/sell_kernel.py:159"),
        "numeric_sell": ("bmsparse_tpu_torch/csrc/spgemm_sell.cu",
                         "bmsparse_tpu/ops/pallas/spgemm_kernel.py:106"),
        "numeric_window": ("bmsparse_tpu_torch/csrc/spgemm_window.cu",
                           "bmsparse_tpu/ops/pallas/"
                           "spgemm_window_kernel.py:234"),
    }
    out = {"kernels": [
        {"name": name, "route": "cuda", "source": replaces[name][0],
         "replaces": replaces[name][1], "launches": launches[name],
         "max_abs_err": errs[name], "ms": t_k, "plain_ms": t_p}
        for name, t_k, t_p in times
    ]}
    print(card)
    print(json.dumps(out))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
