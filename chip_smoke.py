#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (bmsparse_tpu_torch) on one NVIDIA
card: builds the kernels from csrc/, holds each against its plain torch
version at the shapes the main paths give it, drives the paths through
the public API —
  SpMV, block tiers (MatrixMarket / COO -> BmSparse -> prepare(stream=
         "off") -> spmv) on Ragusa16, stencil2M and road1M;
  SpMV, stream tier (prepare(stream="force") -> spmv) on web256k and
         rand64k, and the tier prepare(stream="auto") picks for them and
         for road1M;
  SpGEMM (COO -> BmSparse A and transposed B -> spgemm(A, B) and
         prepare_product(A, B)()) A*A on Ragusa16, blockdense64k, band2M
         and fem1M;
  SpGEMM compress alternatives: the segment compress (spgemm_compress=
         "mxu") on band2M and fem1M, the gather-fold ("fold") on band256k;
         the default compress's kernel (bitmap_compress) against its
         plain version, bit for bit, at band2M's and fem1M's;
  the user surfaces (phase 4): the device converter against the host
         converter on stencil2M and road1M, container and plan
         persistence (road1M, web256k), write_matrix_market and both
         parsers, cli.spmv, cli.spgemm and cli.batch on band256k, and the
         examples cg (n = 2,097,152) and matrix_powers (n = 1,048,576);
  the multi-device path (phase 5, bmsparse_tpu_torch/parallel): an NCCL
         group of world size 1 runs dryrun_multichip, the sharded tiered
         SpMV on stencil2M, the sharded product on band2M and the padded
         SpGEMM on band256k; then every shard of 4-shard plans (stencil2M,
         a 262,144-row band, band2M) runs in turn on the card, so the DIA
         kernel sees non-zero column shifts — one card, not a multi-card
         run;
  the scaling report (phase 6, cli/scaling.py) on the CLI's synthetic
         band at n = 1,048,576: d = 1 measured over an NCCL group of world
         size 1, its kernels held against their twins and its SpMV call
         taken apart, d = 4, 8 projected with the model's data-sheet
         figures, then the CLI once as a subprocess —
checks the results against scipy in float64 and against the plain path on
the card (each kernel also alone against its plain version, sell_gather on
road1M's two gathered packs), shows from the launch counters that each
path ran through its kernels, times kernel and plain paths with CUDA
events beside each kernel's bound and, where one exists, a single PyTorch
call computing the same function, and measures the stream tier's cost-model constants.

    python3 chip_smoke.py

Needs a CUDA device; exits non-zero without one, or when any check
fails. The last line of its output is
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}
and the line before it lists the kernels as JSON.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np

TOL = dict(rtol=1e-5, atol=1e-5)   # kernel vs plain: only the sum order differs
EXACT = dict(rtol=0, atol=0)       # one product or one copy per output
COMPRESS_REL = 1e-6                # compress modes vs scatter, max|dC| / max|C|
ORACLE_REL = 1e-4                  # vs scipy float64, max|u - ref| / max|ref|
# sell_gather's rows vs their float64 sums, |u - ref| / (|A| |v|) per row
# (the benchmark's spmv_gap): float32 sums of up to ~46k entries, whose
# order differs from the plain version's, so TOL does not fit long rows
GATHER_REL = 1e-6
WARMUP, ITERS = 3, 20
FLUSH_BYTES = 256 << 20            # written between L2-cold runs (L2: 50 MB)
SPIN_CYCLES = 2_000_000            # ~1 ms of device spin before a cold run
# H100 SXM peaks (NVIDIA's data sheet, at a 700 W limit): device memory
# and float32 outside the tensor cores, for the kernels' bounds
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12


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


def cold_ms(fn, torch, spin_cycles: int = SPIN_CYCLES) -> float:
    """Median ms of fn from a cold L2, by CUDA events: before each of
    ITERS runs a FLUSH_BYTES buffer is written and the stream spins for
    spin_cycles, both outside the events, so that fn's launches are all
    queued when its first kernel starts and the events hold device time
    alone (no host launch gaps), L2 evicted. The spin must outlast the
    host's time to enqueue fn."""
    import statistics

    buf = torch.empty(FLUSH_BYTES // 4, device="cuda")
    for _ in range(WARMUP):
        fn()
    times = []
    for _ in range(ITERS):
        buf.fill_(1.0)
        torch.cuda._sleep(spin_cycles)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    del buf
    return statistics.median(times)


def windowed_csr(torch, p, n):
    """The windowed SELL groups of plan p as one CSR matrix on the card
    (int32 indices), the groups' output rows stacked in group order, and
    the number of nonzeros: what one torch.sparse_csr_tensor matvec needs
    to compute sell_window's outputs. Read from the groups' packs."""
    from bmsparse_tpu_torch.ops.cuda.sell_kernel import pack_entries

    rows, cols, vals = [], [], []
    base = 0
    for pk in p.sell_pack:
        if pk is None:
            continue
        r, c, x = pack_entries(pk)
        rows.append(base + r)
        cols.append(c)
        vals.append(x.float())
        base += pk.cap * 8 * 128
    rows, cols, vals = torch.cat(rows), torch.cat(cols), torch.cat(vals)
    order = torch.argsort(rows * n + cols)
    crow = torch.zeros(base + 1, dtype=torch.int64, device=rows.device)
    crow[1:] = torch.cumsum(torch.bincount(rows, minlength=base), 0)
    csr = torch.sparse_csr_tensor(crow.int(), cols[order].int(),
                                  vals[order], (base, n))
    return csr, int(vals.numel())


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


def busy_s(fn, torch) -> float:
    """Device busy seconds per call of fn (torch.profiler); CUDA events
    where the profiler recorded no device activity."""
    prof = device_profile(fn, torch)
    return (prof[0] if prof is not None else median_ms(fn, torch)) / 1e3


def profile_text(prof, bound_ms: float | None = None) -> str:
    """A torch.profiler reading as text; where the function's least time
    bound_ms is given, a reading below it (inputs warm in L2, or a broken
    trace) prints as not measured, never as a device time."""
    if prof is None:
        return "device time not measured (no profiler activity)"
    busy, span = prof
    if bound_ms is not None and busy < bound_ms:
        return (f"device busy {busy!r} ms per call is below the bound "
                f"{bound_ms!r} ms (inputs warm in L2, or a broken trace): "
                f"not a device time")
    return (f"device busy {busy!r} ms per call, idle share "
            f"{1 - busy / span!r} of back-to-back calls")


def bounded_ms_text(ms: float, bound_ms: float) -> str:
    """A kernel's device ms where its least time is bound_ms: a reading
    below the bound is impossible and prints as a broken one, not as a
    time."""
    if ms >= bound_ms:
        return f"{ms!r} ms"
    return f"broken reading ({ms!r} ms < bound): not measured"


def max_abs(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def bound(n_bytes: float, flops: float) -> tuple:
    """The least time the card could take for work that must move
    `n_bytes` (each input read once, each output written once) and do
    `flops` float32 operations: (ms, "bytes" or "operations")."""
    t_b = n_bytes / PEAK_BYTES_PER_S
    t_f = flops / PEAK_F32_PER_S
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def distinct(idxs, below: int) -> int:
    """Distinct entries in [0, below) of the index tensors idxs: the rows
    the gathers must read."""
    import torch

    if not idxs:
        return 0
    idx = torch.cat([i.reshape(-1) for i in idxs])
    return int(torch.unique(idx[(idx >= 0) & (idx < below)]).numel())


def kernel_row(name, ms, plain_ms, bound_ms_by, library_ms=None) -> dict:
    return {"name": name, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms_by[0], "bound_by": bound_ms_by[1],
            "library_ms": library_ms}


def phase1_kernels(torch, dev):
    """Each kernel against its plain version at main-path shapes."""
    from bmsparse_tpu_torch.ops.cuda import sell_kernel as sk
    from bmsparse_tpu_torch.ops.cuda.sell_kernel import (
        pack_group, sell_window, sell_window_plain,
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
        dense = torch.where(torch.rand(dense.shape, generator=g, device=dev)
                            < 0.05, dense, 0.0)
        for dt in (torch.float32, torch.bfloat16):
            pack = pack_group(dense.to(dt), rel, ws)
            got = sell_window(pack, v, n)
            want = sell_window_plain(pack, v, n)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, **TOL)
            err = max_abs(got, want)
            errs["sell_window"] = max(errs["sell_window"], err)
            print(f"phase1 sell_window cw={cw} cap={cap} kg={kg} {dt} "
                  f"({pack.nnz} nonzeros, {pack.vals.numel()} pack entries)"
                  f": max_abs_err={err!r}")
    return errs


def group_launches(torch, specs, nb, g, order=True):
    """Random operand slots for K-groups of one kind and the planner's
    launch over them (ops/spgemm.py::_product_launches), on the card:
    specs per group (kg, ch) for numeric_sell, (kg, ch, t, w) for
    numeric_window; a trailing "empty" makes a group read only
    sentinels. Random chunk keys interleave the groups (order=False keeps
    group order). Returns (launch, rows)."""
    from bmsparse_tpu_torch.config import bucket_size
    from bmsparse_tpu_torch.ops.cuda.spgemm_window_kernel import (
        _SENT_REL, TILE_CHUNKS, W_MAX,
    )
    from bmsparse_tpu_torch.ops.spgemm import _product_launches

    nb_pad = max(-(-(nb + 1) // 128) * 128, W_MAX)
    window = isinstance(specs[0][2] if len(specs[0]) > 2 else None, int)
    groups, pwin, pws, ws_host, tas, tbs = [], [], [], [], [], []
    c0 = 0
    for spec in specs:
        kg, ch = spec[:2]
        cap = bucket_size(ch, minimum=1)
        if window:
            t, w = spec[2:4]
            ntiles = -(-cap // t)
            shape = (ntiles, kg, TILE_CHUNKS, 128)
            ws = [torch.randint(0, (nb_pad - w) // 128 + 1, (ntiles,),
                                generator=g, device="cuda",
                                dtype=torch.int32) * 128 for _ in range(2)]
            for x in ws:
                x[-1] = nb_pad - w     # a window past the table's end
            pwin.append((w, w, t, cap))
            pws.append(tuple(ws))
            ws_host.append(tuple(x.cpu().numpy() for x in ws))
            hi, sent = w, _SENT_REL
        else:
            shape = (cap, kg, 128)
            pwin.append(None)
            pws.append(None)
            ws_host.append(None)
            hi, sent = nb, nb
        tabs = []
        for _ in range(2):
            x = torch.randint(0, hi, shape, generator=g, device="cuda",
                              dtype=torch.int32)
            x[torch.rand(shape, generator=g, device="cuda") < 0.2] = sent
            if spec[-1] == "empty":
                x.fill_(sent)
            tabs.append(x)
        groups.append((kg, c0, c0 + ch))
        tas.append(tabs[0])
        tbs.append(tabs[1])
        c0 += ch
    amin = np.random.default_rng(len(specs)).integers(0, 64, c0) if order \
        else np.zeros(c0, np.int64)
    launches, rows, _, _ = _product_launches(groups, pwin, pws, ws_host, tas,
                                             tbs, amin)
    return launches[0] if window else launches[1], rows


def phase1_spgemm_kernels(torch, dev):
    """The SpGEMM kernels against their plain versions: per group at the
    slot-table shapes of blockdense64k (numeric_sell) and band2M
    (numeric_window), and over multi-group work tables in one launch
    (K = 1 with padding chunks, groups deeper than one slot slice, an
    all-sentinel group, t_real < 8, windows past the table's end)."""
    from bmsparse_tpu_torch.ops.cuda.spgemm_kernel import (
        numeric_sell_groups, numeric_sell_groups_plain,
    )
    from bmsparse_tpu_torch.ops.cuda.spgemm_window_kernel import (
        numeric_window_groups, numeric_window_groups_plain,
    )

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
    for kname, nb, specs in (
            ("numeric_sell", 40_960, [(2, 3), (1, 1594)]),
            ("numeric_sell", 40_960, [(40, 5), (3, 7), (2, 4, "empty")]),
            ("numeric_window", 786_432, [(3, 2048, 8, 4096),
                                         (2, 4096, 8, 2048),
                                         (1, 4096, 8, 2048)]),
            ("numeric_window", 786_432, [(24, 3, 2, 512), (2, 33, 4, 2048),
                                         (1, 10, 1, 256)])):
        # scaled by 1/4: C near 1 at depth 40, where only the order of
        # the float32 sums differs between kernel and plain version
        a = torch.randn((nb, 64), generator=g, device=dev) / 4
        b = torch.randn((nb, 64), generator=g, device=dev) / 4
        launch, rows = group_launches(torch, specs, nb, g)
        fn, plain = ((numeric_sell_groups, numeric_sell_groups_plain)
                     if kname == "numeric_sell" else
                     (numeric_window_groups, numeric_window_groups_plain))
        for dt in (torch.float32, torch.bfloat16):
            args = (a.to(dt), b.to(dt), launch)
            got = fn(*args, torch.full((rows, 64), float("nan"), device=dev))
            want = plain(*args, torch.empty((rows, 64), device=dev))
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, **TOL)
            err = max_abs(got, want)
            errs[kname] = max(errs[kname], err)
            print(f"phase1 {kname} one launch over K-groups {specs} "
                  f"({launch.work.shape[0]} chunks) nb={nb} {dt}: "
                  f"max_abs_err={err!r}")
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
    """SpMV on the block tiers through the public API, with launch counts.
    These matrices exercise the DIA and SELL tiers, so their plans are
    built with stream="off" (the tier prepare's default "auto" picks is
    printed in phase 2's stream section)."""
    import bmsparse_tpu_torch as bt
    from bmsparse_tpu_torch.ops.cuda.sell_gather_kernel import sell_gather
    from bmsparse_tpu_torch.ops.cuda.sell_kernel import (
        sell_window, sell_window_plain,
    )
    from bmsparse_tpu_torch.ops.cuda.spmv_kernel import dia_spmv

    launches = {"dia_spmv": 0, "sell_window": 0, "sell_gather": 0}
    errs = {"sell_window": 0.0, "sell_gather": 0.0}
    runs = {}
    for name, load in matrices():
        dia_spmv.launches = sell_window.launches = sell_gather.launches = 0
        t0 = time.perf_counter()
        m = load()
        t1 = time.perf_counter()
        p = bt.prepare(m, stream="off")
        t2 = time.perf_counter()
        # v as bench.py makes it
        v_np = np.random.default_rng(0).standard_normal(
            m.num_cols).astype(np.float32)
        v = torch.from_numpy(v_np).to("cuda")
        u = bt.spmv(p, v)
        torch.cuda.synchronize()
        counts = {"dia_spmv": dia_spmv.launches,
                  "sell_window": sell_window.launches,
                  "sell_gather": sell_gather.launches}
        for k in launches:
            launches[k] += counts[k]
        nwin = sum(pk is not None for pk in p.sell_pack)
        cw = sorted({pk.cw for pk in p.sell_pack if pk is not None})
        print(f"phase2 {name}: n={m.num_rows} nnz={m.nnz} blocks={m.nb} "
              f"load={t1 - t0:.3f}s prepare={t2 - t1:.3f}s "
              f"ndiags={len(p.dia_offsets)} sell_ks={p.sell_ks} "
              f"sell_chunks={p.sell_chunks} windowed cw={cw} "
              f"windowed_groups={nwin}/{len(p.sell_ks)} ovf_ks={p.ovf_ks} "
              f"launches={counts}")
        want = sum(gather_launches(pk) for _, pk, _ in gathered(p))
        check(counts["sell_gather"] == want,
              f"{name}: {counts['sell_gather']} sell_gather launches in one "
              f"spmv, {want} expected from the plan's gathered packs")
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
            errs["sell_window"] = pack_check(torch, p, v, "road1M",
                                             sell_window, sell_window_plain)
            check(len(gathered(p)) == 2,
                  "road1M: expected gathered packs on both SELL tiers")
            errs["sell_gather"] = gather_check(torch, p, v, "road1M")
        runs[name] = (m, p, v)
    return launches, runs, errs


def pack_check(torch, p, v, what, kernel, plain) -> float:
    """Each windowed group's pack of plan p: its size against the dense
    slab of its shape (cw, chunks, K, 8, 128) that the JAX package's plan
    holds, and the kernel against its plain twin on it. Returns the
    largest max_abs_err."""
    n = p.block_cols * 8
    vpad = torch.zeros(n, device=v.device)
    vpad[: v.shape[0]] = v
    err = 0.0
    for g, pk in enumerate(p.sell_pack):
        if pk is None:
            continue
        shape = (pk.cw, pk.cap, p.sell_ks[g], 8, 128)
        slab = math.prod(shape) * pk.vals.element_size()
        got, want = kernel(pk, vpad, n), plain(pk, vpad, n)
        if v.is_cuda:
            torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **TOL)
        err = max(err, max_abs(got, want))
        print(f"phase2 {what} sell_window group {g} {shape}: "
              f"{pk.nnz} nonzeros, {pk.vals.numel()} pack entries "
              f"({pk.vals.numel() / max(pk.nnz, 1)!r} per nonzero), pack "
              f"{pk.nbytes()} bytes against {slab} of slab; kernel vs "
              f"plain max_abs_err={max_abs(got, want)!r}")
    return err


def gathered(p) -> list:
    """(tier, pack, stacked rows) of each SELL tier of plan p that has a
    gathered pack: the main tier's sell_gpack, then the overflow tier's
    ovf_gpack, as one spmv calls them."""
    return [(tier, pk, rows) for tier, pk, rows in (
        ("SELL", p.sell_gpack, p.sell_rows),
        ("overflow", p.ovf_gpack, p.ovf_rows)) if pk is not None]


def gather_launches(pk) -> int:
    """sell_gather's launches for one call on pack pk: the segments'
    kernel where it has segments, the rows' kernel where it has rows."""
    return int(pk.seg_off.shape[0] > 1) + int(pk.rows.shape[0] > 0)


def gather_out(torch, rows_total, device):
    """A zeroed stacked output of a SELL tier of rows_total stacked rows
    (sell_apply's u_rows, flat): its rows and the zero row, 8 scalars
    each."""
    return torch.zeros((rows_total + 1) * 8, device=device)


def gather_gap(torch, pk, vpad, n, got_rows) -> float:
    """max over pack pk's rows of |got - ref| / (|A| |v|), ref and |A| |v|
    summed in float64 by sell_gather_plain; got_rows: the rows' values in
    pack row order. A row whose |A| |v| is zero must be exactly zero."""
    import dataclasses

    from bmsparse_tpu_torch.ops.cuda.sell_gather_kernel import (
        sell_gather_plain,
    )

    size = int(pk.rows.max()) + 1 if pk.rows.numel() else 0
    rows = pk.rows.long()
    ref, scale = (sell_gather_plain(q, x, n, torch.zeros(
        size, dtype=torch.float64, device=vpad.device))[rows]
        for q, x in ((pk, vpad),
                     (dataclasses.replace(pk, vals=pk.vals.abs()),
                      vpad.abs())))
    d = (got_rows.double() - ref).abs()
    gap = torch.where(scale > 0, d / torch.where(scale > 0, scale, 1.0),
                      torch.where(d > 0, math.inf, 0.0))
    return float(gap.max()) if gap.numel() else 0.0


def gather_check(torch, p, v, what, close=TOL) -> float:
    """Each gathered pack of plan p: two kernel calls for the same bits,
    sell_gather and sell_gather_plain each within GATHER_REL of the
    float64 sums and, where `close` is given, the kernel against the
    plain version elementwise; and the kernel on a window of v from a
    column offset (the multi-device halo mode) bitwise equal to it on
    the whole v with the columns before the window zeroed. Returns the
    largest max_abs_err of kernel against plain."""
    from bmsparse_tpu_torch.ops.cuda.sell_gather_kernel import (
        sell_gather, sell_gather_plain,
    )

    n = p.block_cols * 8
    vpad = torch.zeros(n, device=v.device)
    vpad[: v.shape[0]] = v
    err = 0.0
    off = n // 2 // 8 * 8
    cut = vpad.clone()
    cut[:off] = 0
    for tier, pk, rows_total in gathered(p):
        def out():
            return gather_out(torch, rows_total, vpad.device)

        got = sell_gather(pk, vpad, n, out())
        again = sell_gather(pk, vpad, n, out())
        want = sell_gather_plain(pk, vpad, n, out())
        shifted = sell_gather(pk, vpad[off:], n - off, out(), off)
        masked = sell_gather(pk, cut, n, out())
        torch.cuda.synchronize()
        check(torch.equal(shifted, masked),
              f"{what}: sell_gather at column offset {off} differs from "
              f"the whole v with the columns before it zeroed")
        check(torch.equal(got, again),
              f"{what}: two sell_gather calls differ in their bits")
        rows = pk.rows.long()
        gaps = [gather_gap(torch, pk, vpad, n, x[rows]) for x in (got, want)]
        check(max(gaps) <= GATHER_REL,
              f"{what}: sell_gather {tier} tier gaps to the float64 sums "
              f"(kernel, plain) {gaps} above {GATHER_REL}")
        if close is not None:
            torch.testing.assert_close(got, want, **close)
        err = max(err, max_abs(got, want))
        print(f"phase2 {what} sell_gather {tier} tier: {pk.nnz} nonzeros, "
              f"{pk.seg_off.shape[0] - 1} segments, {pk.rows.shape[0]} rows;"
              f" pack {nbytes(*(getattr(pk, f) for f in pk.TENSORS))} bytes;"
              f" kernel vs plain max_abs_err={max_abs(got, want)!r}; gap to "
              f"the float64 sums, |u - ref| / (|A| |v|): kernel "
              f"{gaps[0]!r}, plain {gaps[1]!r}; two calls bitwise equal; "
              f"column offset {off} bitwise equal to the zeroed columns")
    return err


def gather_csr(torch, packs, n):
    """The rows of gathered packs as one CSR matrix on the card (int32
    indices), the packs' rows stacked in order: what one torch.sparse_csr_
    tensor matvec needs to compute sell_gather's rows."""
    dev = packs[0].vals.device
    crow, cols, vals = [torch.zeros(1, dtype=torch.int64, device=dev)], [], []
    for pk in packs:
        cnt = torch.bincount(pk.entry_rows(), minlength=pk.rows.shape[0])
        crow.append(crow[-1][-1:] + torch.cumsum(cnt, 0))
        cols.append(pk.cols[:pk.nnz])
        vals.append(pk.vals[:pk.nnz].float())
    crow = torch.cat(crow)
    return torch.sparse_csr_tensor(crow.int(), torch.cat(cols),
                                   torch.cat(vals), (crow.numel() - 1, n))


def gather_bound(packs) -> tuple:
    """sell_gather's least time over packs: each entry's value and
    column read once, the segment and row tables read once and each row
    written once, v left in L2; one FMA per entry."""
    b = sum(pk.nnz * (pk.vals.element_size() + 4)
            + nbytes(pk.seg_off, pk.row_seg, pk.rows) + 4 * pk.rows.numel()
            for pk in packs)
    return bound(b, 2 * sum(pk.nnz for pk in packs))


def stream_matrices():
    """(name, loader) pairs of the stream-tier cases, as bench.py makes
    them (bench.py:185,200); each loader makes the matrix on the card."""
    import bmsparse_tpu_torch as bt
    from bmsparse_tpu_torch.utils.testmats import make_random, webgraph

    def web():
        return bt.coo_to_bmsparse(*webgraph(262_144, avg_deg=8, seed=9),
                                  device="cuda")

    def rand():
        n = 65_536
        return bt.coo_to_bmsparse(*make_random(n, 3e-4, seed=1), (n, n),
                                  device="cuda")

    return [("web256k", web), ("rand64k", rand)]


def stream_kernel_inputs(torch, s, v, seed=99):
    """The stream kernels' operands at the plan's shapes: window_product
    on the plan's tables and v's table; rowwise_gather on the plan's
    stage-2 and stage-3 index tables with x of the stages' shapes."""
    g = torch.Generator(device=v.device).manual_seed(seed)
    vtab = torch.zeros(s.vtab_len, device=v.device)
    k = min(s.vtab_len, v.shape[0])
    vtab[:k] = v[:k]
    x2 = torch.randn((128 * s.nsub, 128), generator=g, device=v.device)
    x3 = torch.randn((16384, s.w3), generator=g, device=v.device)
    return ((s.vals_grid, s.rel_grid, s.ws, vtab, s.w),
            [(x2, s.idx2, s.idx2.shape[1]), (x3, s.idx3, s.idx3.shape[1])])


def phase2_stream(torch, runs):
    """SpMV through the stream tier (prepare(stream="force")), with launch
    counts; then each stream kernel against its plain version at the
    plan's shapes, and the tier stream="auto" picks."""
    import bmsparse_tpu_torch as bt
    from bmsparse_tpu_torch.ops.cuda.shuffle_kernel import (
        rowwise_gather, rowwise_gather_plain, window_product,
        window_product_plain,
    )

    launches = {"window_product": 0, "rowwise_gather": 0}
    errs = {"window_product": 0.0, "rowwise_gather": 0.0}
    out = {}
    for name, load in stream_matrices():
        t0 = time.perf_counter()
        m = load()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        p = bt.prepare(m, stream="force")
        t2 = time.perf_counter()
        v_np = np.random.default_rng(0).standard_normal(
            m.num_cols).astype(np.float32)
        v = torch.from_numpy(v_np).to("cuda")
        window_product.launches = rowwise_gather.launches = 0
        u = bt.spmv(p, v)
        torch.cuda.synchronize()
        counts = {"window_product": window_product.launches,
                  "rowwise_gather": rowwise_gather.launches}
        for k in launches:
            launches[k] += counts[k]
        s = p.stream
        check(s is not None, f"{name}: no stream plan under stream='force'")
        print(f"phase2 stream {name}: n={m.num_rows} nnz={m.nnz} "
              f"load={t1 - t0:.3f}s prepare(stream='force')={t2 - t1:.3f}s "
              f"(host plan build) k={s.k} nsub={s.nsub} nahi={s.nahi} "
              f"w3={s.w3} s2={s.idx2.shape[1]} "
              f"residue={s.res_rows.shape[0]} "
              f"grid rows={s.vals_grid.shape[0]} sell_ks={p.sell_ks} "
              f"launches={counts}")
        check(counts["window_product"] == 1 and counts["rowwise_gather"] == 2,
              f"{name}: the stream kernels were not launched")
        check(u.is_cuda and u.shape == (m.num_rows,)
              and bool(torch.isfinite(u).all()), f"{name}: output")
        ref = m.to_scipy() @ v_np.astype(np.float64)
        rel = float(np.abs(u.cpu().double().numpy() - ref).max()
                    / max(np.abs(ref).max(), 1e-30))
        print(f"phase2 stream {name}: max|u-ref|/max|ref| vs scipy float64 "
              f"= {rel!r}")
        check(rel <= ORACLE_REL, f"{name}: error {rel} vs scipy")
        u_plain = bt.spmv(p, v, impl="plain")
        torch.testing.assert_close(u, u_plain, **TOL)
        print(f"phase2 stream {name}: max_abs_err vs plain on the card = "
              f"{max_abs(u, u_plain)!r}")

        wargs, gcalls = stream_kernel_inputs(torch, s, v)
        got, want = window_product(*wargs), window_product_plain(*wargs)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **EXACT)
        errs["window_product"] = max(errs["window_product"],
                                     max_abs(got, want))
        print(f"phase1 window_product {name} R={s.vals_grid.shape[0]} "
              f"w={s.w}: max_abs_err={max_abs(got, want)!r}")
        for stage, args in zip((2, 3), gcalls):
            got, want = rowwise_gather(*args), rowwise_gather_plain(*args)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, **EXACT)
            errs["rowwise_gather"] = max(errs["rowwise_gather"],
                                         max_abs(got, want))
            print(f"phase1 rowwise_gather {name} stage {stage} "
                  f"x={tuple(args[0].shape)} g={args[2]}: "
                  f"max_abs_err={max_abs(got, want)!r}")
        out[name] = (m, p, v)

    # the tier prepare's default picks, under the H100 constants
    from bmsparse_tpu_torch.ops import plan as plan_mod
    from bmsparse_tpu_torch.ops import route

    print(f"phase2 stream routing constants in the code: BW={route.BW!r} "
          f"TILE_STEP={route.TILE_STEP!r} STEP={route.STEP!r} "
          f"QSEL={route.QSEL!r} RES_NS={route.RES_NS!r} "
          f"G_NS={plan_mod.G_NS!r}")
    auto = {}
    for name, (m, _, v) in (("web256k", out["web256k"]),
                            ("rand64k", out["rand64k"]),
                            ("road1M", runs["road1M"])):
        t0 = time.perf_counter()
        pa = bt.prepare(m)
        dt = time.perf_counter() - t0
        tier = "stream" if pa.stream is not None else "block tiers"
        print(f"phase2 stream: prepare(stream='auto') picks the {tier} for "
              f"{name} ({dt:.3f}s; ndiags={len(pa.dia_offsets)} "
              f"sell_ks={pa.sell_ks})")
        auto[name] = (m, pa, v)
    return launches, errs, out, auto


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
    from bmsparse_tpu_torch.ops.cuda.bitmap_compress_kernel import (
        bitmap_compress,
    )
    from bmsparse_tpu_torch.ops.cuda.spgemm_kernel import numeric_sell
    from bmsparse_tpu_torch.ops.cuda.spgemm_window_kernel import (
        numeric_window,
    )

    launches = {"numeric_sell": 0, "numeric_window": 0, "bitmap_compress": 0}
    runs = {}
    for name, load in spgemm_matrices():
        t0 = time.perf_counter()
        a, b = load()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        numeric_sell.launches = numeric_window.launches = 0
        bitmap_compress.launches = 0
        c = bt.spgemm(a, b)
        pp = bt.prepare_product(a, b)
        c2 = pp()
        torch.cuda.synchronize()
        counts = {"numeric_sell": numeric_sell.launches,
                  "numeric_window": numeric_window.launches,
                  "bitmap_compress": bitmap_compress.launches}
        t2 = time.perf_counter()
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
        # one launch per kernel per product, over all its K-groups: two
        # products here (spgemm() and pp())
        check(counts["numeric_window"] == 2 * (n_win > 0)
              and counts["numeric_sell"] == 2 * (len(p.groups) > n_win),
              f"{name}: expected one launch per kernel kind and product, "
              f"got {counts}")
        check(counts["bitmap_compress"] == 2 * (c.nb > 0),
              f"{name}: expected one bitmap_compress per product, got "
              f"{counts}")
        numeric_sell.launches = numeric_window.launches = 0
        bitmap_compress.launches = 0
        pp()
        torch.cuda.synchronize()
        one = (numeric_window.launches, numeric_sell.launches,
               bitmap_compress.launches)
        print(f"phase2 spgemm {name}: one pp() launches numeric_window "
              f"{one[0]}, numeric_sell {one[1]} and bitmap_compress {one[2]} "
              f"times")
        check(max(one) <= 1, f"{name}: pp() launched a kernel twice")
        for k in launches:
            launches[k] += counts[k]
        if name == "blockdense64k":
            check(counts["numeric_sell"] > 0 and n_win == 0,
                  "blockdense64k: expected numeric_sell and no tile window")
        if name == "band2M":
            check(counts["numeric_window"] > 0,
                  "band2M: numeric_window not launched")
        runs[name] = (a, b, c, pp)
        del cp, c2, ref, diff, a_sp
    return launches, runs


def compress_rel(c, c_ref) -> float:
    """C against a C of the same structure: max|dC| / max|C_ref|."""
    check(c.nb == c_ref.nb and c.nnz == c_ref.nnz,
          "C block count or nnz differs")
    for f in ("brow", "bcol", "bmp_hi", "bmp_lo", "offsets"):
        check(bool((getattr(c, f) == getattr(c_ref, f)).all()),
              f"C.{f} differs")
    x, y = c.values[: c.nnz].double(), c_ref.values[: c_ref.nnz].double()
    return float((x - y).abs().max() / y.abs().max().clamp(min=1e-30)) \
        if c.nnz else 0.0


def mxu_inputs(pp):
    """The segment compress's per-class operands of a cached product, as
    its pp() makes them: (w_g, b_g) per K-group, and t_rows."""
    from bmsparse_tpu_torch.ops import spgemm as sg

    p = pp.plan
    c_rows = sg._numeric_products(p.a_flat, p.b_flat, p.launches, p.rows,
                                  True)
    t_rows = -(-p.nnz_pad // 64)
    return list(sg._mxu_class_inputs(c_rows, *p.sig_st, p.groups)), t_rows


def scatter_inputs(pp):
    """The default compress's operands of a cached product: c_rows as its
    pp() makes them, and the plan (sigma rows' words and offsets in
    p.sig_st, p.nnz_pad, p.num_c_nnz)."""
    from bmsparse_tpu_torch.ops import spgemm as sg

    p = pp.plan
    return sg._numeric_products(p.a_flat, p.b_flat, p.launches, p.rows,
                                True), p


def phase2_compress(torch, runs):
    """The SpGEMM compress alternatives through the public API, with
    launch counts: the segment compress ("mxu") on band2M and fem1M, the
    gather-fold ("fold") on band256k; C against the scatter path's and
    scipy; then segment_compress_class against its plain version at
    band2M's pp() shapes, and bitmap_compress against its plain version,
    bit for bit, at band2M's and fem1M's."""
    import bmsparse_tpu_torch as bt
    from bmsparse_tpu_torch.config import bucket_size
    from bmsparse_tpu_torch.ops import spgemm as sg
    from bmsparse_tpu_torch.ops.cuda.bitmap_compress_kernel import (
        bitmap_compress, bitmap_compress_plain,
    )
    from bmsparse_tpu_torch.ops.cuda.compress_kernel import (
        segment_compress_class, segment_compress_class_plain,
    )
    from bmsparse_tpu_torch.utils.testmats import make_banded

    cases = [(name, "mxu", runs[name][0], runs[name][1], runs[name][2])
             for name in ("band2M", "fem1M")]
    n = 262_144                        # bench.py:182
    r, c, v = make_banded(n, 16, seed=2)
    a = bt.coo_to_bmsparse(r, c, v, (n, n), device="cuda")
    b = bt.coo_to_bmsparse(r, c, v, (n, n), transposed=True, device="cuda")
    cases.append(("band256k", "fold", a, b, bt.spgemm(a, b)))
    launches = {"segment_compress_class": 0}
    out = {}
    for name, mode, a, b, c_sc in cases:
        bt.set_config(spgemm_compress=mode)
        try:
            segment_compress_class.launches = 0
            bitmap_compress.launches = 0
            c = bt.spgemm(a, b)
            pp = bt.prepare_product(a, b)
            c2 = pp()
            torch.cuda.synchronize()
            n_seg = segment_compress_class.launches
            n_bc = bitmap_compress.launches
        finally:
            bt.set_config(spgemm_compress="auto")
        launches["segment_compress_class"] += n_seg
        p = pp.plan
        print(f"phase2 compress {name}: spgemm_compress={mode!r} -> plan "
              f"compress_mode={pp.compress_mode!r}; K-groups "
              f"{[(kg, c1 - c0) for kg, c0, c1 in p.groups]}; "
              f"segment_compress_class launches={n_seg}")
        if mode == "fold" and pp.compress_mode != "fold":
            r_rows = sum(bucket_size(c1 - c0, minimum=1) * 128
                         for _, c0, c1 in p.groups)
            t_rows_pad = max(-(-p.nnz_pad // 64), 1)
            print(f"phase2 compress {name}: the fold's eligibility rules "
                  f"refuse it (jmax={p.jmax} <= {sg._FOLD_MAX_J}, "
                  f"t_rows_pad*jmax={t_rows_pad * p.jmax} <= "
                  f"4*r_rows={4 * r_rows}, r_rows={r_rows} <= "
                  f"{sg._FOLD_MAX_ROWS}); the scatter ran")
        want = 2 * len(p.groups) if mode == "mxu" else 0
        check(n_seg == want, f"{name}: {n_seg} segment compress launches, "
              f"expected {want}")
        check(n_bc == 2 * (pp.compress_mode == "scatter"),
              f"{name}: {n_bc} bitmap_compress launches under {mode}")
        rels = (compress_rel(c, c_sc), compress_rel(c2, c_sc))
        print(f"phase2 compress {name}: structure equal to the scatter "
              f"path's; max|C-C_scatter|/max|C_scatter| one-shot "
              f"{rels[0]!r}, cached {rels[1]!r}")
        check(max(rels) <= COMPRESS_REL, f"{name}: {rels} vs scatter")
        ref = (a.to_scipy().tocsr() @ b.to_scipy().tocsr()).tocsr()
        mre = bt.mean_relative_error(c2, ref)
        diff = abs(c2.to_scipy().tocsr() - ref)
        ref_max = float(abs(ref).max()) if ref.nnz else 0.0
        rel = (float(diff.max()) if diff.nnz else 0.0) / max(ref_max, 1e-30)
        print(f"phase2 compress {name}: vs scipy float64: mean relative "
              f"error {mre!r}, max|C-ref|/max|ref| {rel!r}")
        check(mre < 1e-5 and rel <= 1e-4 and c2.nnz >= ref.nnz,
              f"{name}: {mode} C vs scipy")
        out[name] = (a, b, pp, c_sc)
        del c, c2, ref, diff

    classes, t_rows = mxu_inputs(out["band2M"][2])
    err = 0.0
    for g, (w_g, b_g) in enumerate(classes):
        got = segment_compress_class(w_g, b_g, t_rows)
        want = segment_compress_class_plain(w_g, b_g, t_rows)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=COMPRESS_REL,
                                   atol=COMPRESS_REL)
        err = max(err, max_abs(got, want))
        print(f"phase1 segment_compress_class band2M class {g}: "
              f"w={tuple(w_g.shape)} t_pad={t_rows}: "
              f"max_abs_err={max_abs(got, want)!r}")
    errs = {"segment_compress_class": err, "bitmap_compress": 0.0}
    for name in ("band2M", "fem1M"):
        c_rows, p = scatter_inputs(out[name][2])
        args = (c_rows, *p.sig_st, p.nnz_pad, p.num_c_nnz)
        want = bitmap_compress_plain(*args)
        got = bitmap_compress(*args)
        torch.cuda.synchronize()
        check(torch.equal(got, want),
              f"{name}: bitmap_compress differs from its plain version")
        errs["bitmap_compress"] = max(errs["bitmap_compress"],
                                      max_abs(got, want))
        print(f"phase1 bitmap_compress {name}: c_rows={tuple(c_rows.shape)} "
              f"nnz(C)={p.num_c_nnz} nnz_pad={p.nnz_pad}: equal to its "
              f"plain version bit for bit")
    return launches, errs, out


def phase3_stream_times(torch, stream_runs, auto_runs, card):
    """The stream kernels at web256k's shapes (event and device time,
    plain version, bound, one PyTorch call), stream-tier SpMV under
    "force" and "off", the tier prepare(stream="auto") picked against the
    block tiers, and the measurements behind the cost model's
    constants."""
    import bmsparse_tpu_torch as bt
    from bmsparse_tpu_torch.ops import plan as plan_mod
    from bmsparse_tpu_torch.ops import route
    from bmsparse_tpu_torch.ops.cuda.shuffle_kernel import (
        rowwise_gather, rowwise_gather_plain, window_product,
        window_product_plain,
    )

    for name, (m, p, v) in stream_runs.items():
        for mode in ("force", "off"):
            pm = p if mode == "force" else bt.prepare(m, stream="off")
            t_k = median_ms(lambda: bt.spmv(pm, v), torch)
            t_p = median_ms(lambda: bt.spmv(pm, v, impl="plain"), torch)
            print(f"phase3 spmv {name} stream={mode!r}: kernels {t_k!r} ms "
                  f"({m.nnz / t_k / 1e6!r} Gnnz/s), plain {t_p!r} ms "
                  f"({m.nnz / t_p / 1e6!r} Gnnz/s) [{card}]")
            for impl in ("auto", "plain"):
                prof = device_profile(lambda: bt.spmv(pm, v, impl=impl),
                                      torch)
                print(f"phase3 spmv {name} stream={mode!r} {impl}: "
                      f"{profile_text(prof)} (torch.profiler) [{card}]")
            if mode == "force":
                print(f"phase3 spmv {name} stream='force' kernels, device "
                      f"time per call by operation: "
                      f"{device_top(lambda: bt.spmv(pm, v), torch)} [{card}]")
            del pm
    for name, (m, pa, v) in auto_runs.items():
        po = bt.prepare(m, stream="off")
        t_a = median_ms(lambda: bt.spmv(pa, v), torch)
        t_o = median_ms(lambda: bt.spmv(po, v), torch)
        tier = "stream" if pa.stream is not None else "block tiers"
        print(f"phase3 routing {name}: prepare(stream='auto') picked the "
              f"{tier}: spmv {t_a!r} ms; block tiers (stream='off') "
              f"{t_o!r} ms [{card}]")
        del po

    m, p, v = stream_runs["web256k"]
    s = p.stream
    wargs, gcalls = stream_kernel_inputs(torch, s, v)
    rows = []
    # window_product: vals, rel, ws read and the products written once;
    # each distinct window of v once; one multiply per slot. Timed
    # L2-cold: its 37 MB stay in L2 between back-to-back runs
    t_k = cold_ms(lambda: window_product(*wargs), torch)
    t_p = cold_ms(lambda: window_product_plain(*wargs), torch)
    t_warm = median_ms(lambda: window_product(*wargs), torch)
    n_win = int(torch.unique(s.ws).numel())
    w_bytes = nbytes(s.vals_grid, s.rel_grid, s.ws) \
        + nbytes(s.vals_grid) + min(n_win * s.w, s.vtab_len) * 4
    rows.append(kernel_row("window_product", t_k, t_p,
                           bound(w_bytes, s.vals_grid.numel())))
    wp_bytes = w_bytes
    # rowwise_gather: both stages of one SpMV; x and idx read, out written
    g_bytes = [nbytes(x, i) + i.numel() * 4 for x, i, _ in gcalls]
    t_k = median_ms(lambda: [rowwise_gather(*a) for a in gcalls], torch)
    t_p = median_ms(lambda: [rowwise_gather_plain(*a) for a in gcalls],
                    torch)
    ext = [(torch.cat([x, x.new_zeros((x.shape[0], 1))], dim=1),
            torch.where((i >= 0) & (i < x.shape[1]), i, x.shape[1]).long()
            .reshape(x.shape[0], -1)) for x, i, _ in gcalls]
    t_lib = median_ms(lambda: [xe.gather(1, ie) for xe, ie in ext], torch)
    rows.append(kernel_row("rowwise_gather", t_k, t_p,
                           bound(sum(g_bytes), 0), t_lib))
    print(f"phase3 stream kernels web256k: window_product kernel "
          f"{rows[0]['ms']!r} ms, plain {rows[0]['plain_ms']!r} ms (L2-cold "
          f"device ms; L2-warm event ms {t_warm!r}), bound "
          f"{rows[0]['bound_ms']!r} ms; rowwise_gather (stages 2+3, x "
          f"{[tuple(a[0].shape) for a in gcalls]}) kernel {rows[1]['ms']!r}"
          f" ms, plain {rows[1]['plain_ms']!r} ms, torch.gather "
          f"{t_lib!r} ms, bound {rows[1]['bound_ms']!r} ms [{card}]")
    for kname, fn in (("window_product", lambda: window_product(*wargs)),
                      ("window_product plain",
                       lambda: window_product_plain(*wargs)),
                      ("rowwise_gather",
                       lambda: [rowwise_gather(*a) for a in gcalls]),
                      ("rowwise_gather plain",
                       lambda: [rowwise_gather_plain(*a) for a in gcalls]),
                      ("rowwise_gather torch.gather",
                       lambda: [xe.gather(1, ie) for xe, ie in ext])):
        bnd_ms = rows[0 if kname.startswith("window") else 1]["bound_ms"]
        print(f"phase3 {kname} web256k: "
              f"{profile_text(device_profile(fn, torch), bnd_ms)} "
              f"(torch.profiler) [{card}]")

    # ---- the cost model's constants, measured ----------------------------
    x = torch.empty(1 << 28, device="cuda")
    y = torch.empty_like(x)
    t = median_ms(lambda: y.copy_(x), torch) / 1e3
    bw = 2 * nbytes(x) / t
    del x, y
    # G_NS: the block tiers' per-slot gather of v segments (cw = 8), as
    # ops/spmv.sell_apply does it, per index
    g = torch.Generator(device="cuda").manual_seed(7)
    ncu = 131_072
    vt = torch.randn((8, ncu + 1), generator=g, device="cuda")
    bcol = torch.randint(0, ncu + 1, (1 << 22,), generator=g, device="cuda")
    g_ns = busy_s(lambda: vt[:, bcol], torch) / bcol.numel()
    # RES_NS: the residue's gather and index_add_, per element
    nres = 1 << 20
    vtab = torch.randn(1 << 20, generator=g, device="cuda")
    res_cols = torch.randint(0, vtab.numel(), (nres,), generator=g,
                             device="cuda")
    res_rows = torch.sort(torch.randint(0, 1 << 20, (nres,), generator=g,
                                        device="cuda")).values
    res_vals = torch.randn(nres, generator=g, device="cuda")
    u = torch.zeros(1 << 20, device="cuda")
    res_ns = busy_s(lambda: u.index_add_(
        0, res_rows, res_vals * vtab[res_cols]), torch) / nres
    # TILE_STEP and STEP: the kernels' device time beyond their bytes at
    # bw, per tile of window_product and per 32-row step of rowwise_gather
    ntiles = s.vals_grid.shape[0] // route.TILE_R
    tile_fit = (busy_s(lambda: window_product(*wargs), torch)
                - wp_bytes / bw) / ntiles
    steps = sum(x.shape[0] / 32 for x, _, _ in gcalls)
    step_fit = (busy_s(lambda: [rowwise_gather(*a) for a in gcalls], torch)
                - sum(g_bytes) / bw) / steps
    # QSEL: stage 3 at w3 and at 4 * w3, the same indices: the time beyond
    # the wider x's bytes, per (8-row block, output row, 128-column) unit
    x3, i3, g3 = gcalls[1]
    x3w = torch.randn((x3.shape[0], 4 * x3.shape[1]), generator=g,
                      device="cuda")
    t3 = busy_s(lambda: rowwise_gather(x3, i3, g3), torch)
    t3w = busy_s(lambda: rowwise_gather(x3w, i3, g3), torch)
    units = (16384 / 8) * g3 * (x3w.shape[1] - x3.shape[1]) / 128
    qsel_fit = (t3w - t3 - (nbytes(x3w) - nbytes(x3)) / bw) / units
    print(f"phase3 routing constants measured [{card}]: BW={bw!r} B/s "
          f"(copy of {2 * (1 << 30)} bytes read+written); "
          f"G_NS={g_ns!r} s/index (v-segment gather, {bcol.numel()} "
          f"indices); RES_NS={res_ns!r} s/element (gather + index_add_, "
          f"{nres} elements); TILE_STEP fit={tile_fit!r} s/tile "
          f"(window_product, {ntiles} tiles); STEP fit={step_fit!r} s/step "
          f"(rowwise_gather stages 2+3, {steps} steps); QSEL fit="
          f"{qsel_fit!r} s/unit (stage 3 at w={x3.shape[1]} {t3!r} s and "
          f"w={x3w.shape[1]} {t3w!r} s)")
    print(f"phase3 routing constants in the code: BW={route.BW!r} "
          f"TILE_STEP={route.TILE_STEP!r} STEP={route.STEP!r} "
          f"QSEL={route.QSEL!r} RES_NS={route.RES_NS!r} "
          f"G_NS={plan_mod.G_NS!r}")
    return rows


def compress_bound(hi, lo, nnz_pad) -> tuple:
    """bitmap_compress's least time: the 32-byte sectors of c_rows that
    hold a set address (8 addresses each), 24 bytes of words and offset
    per row, and the nnz_pad values written."""
    from bmsparse_tpu_torch.format import bitmap as bm

    sectors, step = 0, 1 << 22
    for i in range(0, hi.shape[0], step):
        bits = bm.expand_bits(hi[i:i + step], lo[i:i + step])
        sectors += int(bits.reshape(-1, 8, 8).any(-1).sum())
    return bound(sectors * 32 + hi.shape[0] * 24 + nnz_pad * 4, 0)


def phase3_bitmap_compress(torch, pp, name, card) -> dict:
    """bitmap_compress at a cached product's shapes: L2-cold and warm
    event ms, device ms (torch.profiler), and its plain version (the one
    PyTorch path that computes the same array)."""
    from bmsparse_tpu_torch.ops.cuda.bitmap_compress_kernel import (
        bitmap_compress, bitmap_compress_plain,
    )

    c_rows, p = scatter_inputs(pp)
    args = (c_rows, *p.sig_st, p.nnz_pad, p.num_c_nnz)
    fns = {"kernel": lambda: bitmap_compress(*args),
           "plain": lambda: bitmap_compress_plain(*args)}
    t_cold = cold_ms(fns["kernel"], torch)
    t_k, t_p = (median_ms(f, torch) for f in fns.values())
    row = kernel_row("bitmap_compress", t_k, t_p,
                     compress_bound(p.sig_st[0], p.sig_st[1], p.nnz_pad))
    print(f"phase3 bitmap_compress {name} (rows {c_rows.shape[0]}, nnz(C) "
          f"{p.num_c_nnz}, nnz_pad {p.nnz_pad}): kernel cold {t_cold!r} ms, "
          f"warm {t_k!r} ms, plain {t_p!r} ms, "
          f"bound {row['bound_ms']!r} ms [{card}]")
    for kname, fn in fns.items():
        print(f"phase3 bitmap_compress {name} {kname}: "
              f"{profile_text(device_profile(fn, torch), row['bound_ms'])} "
              f"(torch.profiler) [{card}]")
    return row


def phase3_compress_times(torch, compress_runs, spgemm_runs, card):
    """pp() under "mxu", "fold" and "scatter", and segment_compress_class
    at band2M's classes (event and device time, plain version, bound,
    one index_add_ per class); bitmap_compress at band2M's shapes."""
    from bmsparse_tpu_torch.ops.cuda.compress_kernel import (
        segment_compress_class, segment_compress_class_plain,
    )

    for name, (a, b, pp, _) in compress_runs.items():
        pp_sc = spgemm_runs[name][3] if name in spgemm_runs else None
        if pp_sc is None:
            import bmsparse_tpu_torch as bt

            pp_sc = bt.prepare_product(a, b)
        t_m = median_ms(pp, torch)
        t_s = median_ms(pp_sc, torch)
        print(f"phase3 compress {name}: pp() compress_mode="
              f"{pp.compress_mode!r} {t_m!r} ms, compress_mode="
              f"{pp_sc.compress_mode!r} {t_s!r} ms [{card}]")
        prof = device_profile(pp, torch)
        print(f"phase3 compress {name} pp() {pp.compress_mode}: "
              f"{profile_text(prof)} (torch.profiler) [{card}]")
        print(f"phase3 compress {name} pp() {pp.compress_mode}, device time "
              f"per call by operation: {device_top(pp, torch)} [{card}]")

    classes, t_rows = mxu_inputs(compress_runs["band2M"][2])
    t_k = median_ms(lambda: [segment_compress_class(w, b_, t_rows)
                             for w, b_ in classes], torch)
    t_p = median_ms(lambda: [segment_compress_class_plain(w, b_, t_rows)
                             for w, b_ in classes], torch)
    lib = []
    for w, b_ in classes:
        bl = b_.long()
        lib.append((torch.zeros((t_rows + 1, 128), device="cuda"),
                    torch.where((bl >= 0) & (bl < t_rows), bl, t_rows), w))
    t_lib = median_ms(lambda: [o.index_add_(0, i, w) for o, i, w in lib],
                      torch)
    c_bytes = sum(nbytes(w, b_) + t_rows * 128 * 4 for w, b_ in classes)
    row = kernel_row("segment_compress_class", t_k, t_p,
                     bound(c_bytes, sum(w.numel() for w, _ in classes)),
                     t_lib)
    print(f"phase3 segment_compress_class band2M ({len(classes)} classes, "
          f"rows {[w.shape[0] for w, _ in classes]}, t_pad {t_rows}): "
          f"kernel {t_k!r} ms, plain {t_p!r} ms, index_add_ {t_lib!r} ms, "
          f"bound {row['bound_ms']!r} ms [{card}]")
    for kname, fn in (
            ("kernel", lambda: [segment_compress_class(w, b_, t_rows)
                                for w, b_ in classes]),
            ("plain", lambda: [segment_compress_class_plain(w, b_, t_rows)
                               for w, b_ in classes]),
            ("index_add_", lambda: [o.index_add_(0, i, w)
                                    for o, i, w in lib])):
        print(f"phase3 segment_compress_class band2M {kname}: "
              f"{profile_text(device_profile(fn, torch), row['bound_ms'])} "
              f"(torch.profiler) [{card}]")
    return [row, phase3_bitmap_compress(torch, compress_runs["band2M"][2],
                                        "band2M", card)]


def phase3_spgemm_times(torch, runs, card):
    """Per matrix: one-shot spgemm, the cached numeric call on kernels and
    on plain torch, its roofline share and device profile; then each
    kernel alone at its cell (numeric_sell at blockdense64k,
    numeric_window at band2M): the main path's one launch over all its
    K-groups against the same kernel launched once per group, once in
    group order, and the plain twin."""
    import bmsparse_tpu_torch as bt
    from bmsparse_tpu_torch.ops import spgemm as sg
    from bmsparse_tpu_torch.ops.cuda.spgemm_kernel import (
        numeric_sell_groups, numeric_sell_groups_plain,
    )
    from bmsparse_tpu_torch.ops.cuda.spgemm_window_kernel import (
        _SENT_REL, numeric_window_groups, numeric_window_groups_plain,
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
    for kname, mname in (("numeric_sell", "blockdense64k"),
                         ("numeric_window", "band2M")):
        p = runs[mname][3].plan
        win = kname == "numeric_window"
        fn, plain = ((numeric_window_groups, numeric_window_groups_plain)
                     if win else (numeric_sell_groups,
                                  numeric_sell_groups_plain))
        launch = p.launches[0 if win else 1]
        members = [g for g in range(len(p.groups))
                   if (p.pwin[g] is not None) == win]
        ws_host = [None if w is None else tuple(x.cpu().numpy() for x in w)
                   for w in p.pws]
        no_order = np.zeros(p.nbc_pad // 128, np.int64)

        def launches_of(gs):
            """The planner's launch over groups gs, in group and chunk
            order, writing rows from 0."""
            (lw, ls), rows, _, _ = sg._product_launches(
                [p.groups[g] for g in gs], [p.pwin[g] for g in gs],
                [p.pws[g] for g in gs], [ws_host[g] for g in gs],
                [p.tas[g] for g in gs], [p.tbs[g] for g in gs], no_order)
            return (lw if win else ls), rows

        ab = (p.a_flat, p.b_flat)
        out = torch.empty((p.rows, 64), device="cuda")
        # the kernel launched once per group, into one output each (the
        # per-group layout, whose outputs a torch.cat then joined), and
        # once over all groups in group order (no L2 ordering)
        per_group = [(lg, torch.empty((rows, 64), device="cuda"))
                     for lg, rows in (launches_of([g]) for g in members)]
        unordered = launches_of(members)[0]
        variants = (
            ("one launch, ordered (the main path)",
             lambda: fn(*ab, launch, out)),
            ("one launch, group order", lambda: fn(*ab, unordered, out)),
            ("one launch per group",
             lambda: [fn(*ab, lg, o) for lg, o in per_group]),
            ("plain twin", lambda: plain(*ab, launch, out)))
        # bound: the slot and work tables, each distinct operand tile
        # once, the C rows the main path keeps written once; 1,024 float32
        # operations per live task
        nb_a, nb_b = p.a_flat.shape[0], p.b_flat.shape[0]
        kept = sum(rows for _, rows, _ in launch.parts)
        k_bytes = nbytes(launch.slots_a, launch.slots_b, launch.work) \
            + kept * 64 * 4
        group_rows = 0           # rows of full per-group outputs
        flops = 0
        ia, ib = [], []
        for _, rows, args in launch.parts:
            ta, tb = args[0], args[1]
            if win:
                wsa, wsb, _, t = args[2:]
                group_rows += ta.shape[0] * t * 128
                ok = (ta != _SENT_REL) & (tb != _SENT_REL)
                ta = torch.where(ta != _SENT_REL,
                                 ta + wsa[:, None, None, None], nb_a)
                tb = torch.where(tb != _SENT_REL,
                                 tb + wsb[:, None, None, None], nb_b)
            else:
                group_rows += rows
                ok = (ta < nb_a) & (tb < nb_b)
            flops += 1024 * int(ok.sum())
            ia.append(ta.reshape(-1))
            ib.append(tb.reshape(-1))
        row = p.a_flat.shape[1] * p.a_flat.element_size()
        k_bytes += row * (distinct(ia, nb_a) + distinct(ib, nb_b))
        bnd = bound(k_bytes, flops)
        bnd_groups = bound(k_bytes + (group_rows - kept) * 64 * 4, flops)
        times = {}
        for what, f in variants:
            prof = device_profile(f, torch)
            times[what] = (median_ms(f, torch),
                           None if prof is None else prof[0])
            print(f"phase3 {kname} {mname} {what}: event "
                  f"{times[what][0]!r} ms; {profile_text(prof, bnd[0])} "
                  f"(torch.profiler) [{card}]")
        outs = [o for _, o in per_group]
        t_cat = median_ms(lambda: torch.cat(outs), torch)
        print(f"phase3 {kname} {mname}: the copy that joins per-group "
              f"outputs (torch.cat of {len(outs)} outputs, "
              f"{nbytes(*outs)} bytes): {t_cat!r} ms [{card}]")
        main = times["one launch, ordered (the main path)"]
        dev_ms = ("not measured" if main[1] is None
                  else bounded_ms_text(main[1], bnd[0]))
        print(f"phase3 {kname} {mname} ({len(members)} K-groups, "
              f"{launch.work.shape[0]} chunks, one launch): event {main[0]!r}"
              f" ms, device {dev_ms}; bound {bnd[0]!r} ms "
              f"({bnd[1]}; {k_bytes} bytes, {flops} flops); with the "
              f"per-group outputs' trimmed rows written {bnd_groups[0]!r} ms "
              f"[{card}]")
        kernels.append(kernel_row(kname, main[0],
                                  times["plain twin"][0], bnd))
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
    m, p, vpad = runs["stencil2M"]
    # the one PyTorch call: a CSR matvec over the whole matrix, whose
    # nonzeros all lie on the DIA tier (built outside the timed region)
    sp = m.to_scipy().tocsr()
    check(not p.sell_ks, "stencil2M: expected the DIA tier alone")
    csr = torch.sparse_csr_tensor(
        *(torch.from_numpy(x.astype(np.int32)).to("cuda")
          for x in (sp.indptr, sp.indices)),
        torch.from_numpy(sp.data.astype(np.float32)).to("cuda"), sp.shape)
    del sp
    u_lib = csr @ vpad
    torch.testing.assert_close(
        u_lib, dia_spmv(p.dia, vpad, p.dia_offsets).reshape(-1)[
            :m.num_rows], **TOL)
    t_lib = median_ms(lambda: csr @ vpad, torch)
    print(f"phase3 dia_spmv stencil2M one PyTorch call (torch.sparse_csr_"
          f"tensor @ v, {m.nnz} nonzeros, int32 indices): {t_lib!r} ms; "
          f"{profile_text(device_profile(lambda: csr @ vpad, torch))} "
          f"(torch.profiler) [{card}]")
    del csr, u_lib
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
        bnd = bound(nbytes(dia, vpad) + dia.shape[1] * 128 * 4,
                    2 * dia.numel())
        for what, fn in (("kernel", dia_spmv), ("plain", dia_spmv_plain)):
            prof = device_profile(lambda: fn(dia, vpad, p.dia_offsets), torch)
            print(f"phase3 dia_spmv stencil2M {dt} {what}: "
                  f"{profile_text(prof, bnd[0])} (torch.profiler) [{card}]")
        if dt == "float32":
            kernels.append(kernel_row("dia_spmv", t_k, t_p, bnd, t_lib))

    m, p, v = runs["road1M"]
    n = m.block_cols * 8
    vpad = torch.zeros(n, device="cuda")
    vpad[: v.shape[0]] = v
    windowed = [(g, pk) for g, pk in enumerate(p.sell_pack)
                if pk is not None]
    packs = [pk for _, pk in windowed]

    def run_groups(fn):
        return [fn(pk, vpad, n) for pk in packs]

    # L2-cold: inside road1M's SpMV the DIA strip and the other tiers
    # pass through L2 before these groups run
    t_k = cold_ms(lambda: run_groups(sell_window), torch)
    t_p = cold_ms(lambda: run_groups(sell_window_plain), torch)
    t_warm = median_ms(lambda: run_groups(sell_window), torch)
    csr, nnz = windowed_csr(torch, p, n)
    u_lib = csr @ vpad
    torch.testing.assert_close(
        u_lib, torch.cat([o.reshape(-1) for o in run_groups(sell_window)]),
        **TOL)
    t_lib = cold_ms(lambda: csr @ vpad, torch)
    out_rows = sum(pk.cap * 8 * 128 for pk in packs)
    # bound: each nonzero's value read once, each output row written once
    # (utils/roofline.py's SpMV rule); one FMA per nonzero
    bnd = bound(nnz * packs[0].vals.element_size() + out_rows * 4, 2 * nnz)
    entries = sum(pk.vals.numel() for pk in packs)
    print(f"phase3 sell_window road1M windowed groups (cw, chunks, K) "
          f"{[(pk.cw, pk.cap, p.sell_ks[g]) for g, pk in windowed]}: {nnz} "
          f"nonzeros, {out_rows} output rows; packs {entries} entries "
          f"({entries / nnz!r} per nonzero), "
          f"{sum(pk.nbytes() for pk in packs)} bytes [{card}]")
    print(f"phase3 sell_window road1M L2-cold device ms (events behind a "
          f"queued spin, {FLUSH_BYTES} bytes written before each run): "
          f"kernel {t_k!r}, plain {t_p!r}, torch.sparse_csr_tensor @ v "
          f"{t_lib!r}; bound {bnd[0]!r} ms ({bnd[1]}), kernel at "
          f"{bnd[0] / t_k!r} of it; L2-warm event ms (host launch "
          f"included) kernel {t_warm!r} [{card}]")
    for what, fn in (("kernel", lambda: run_groups(sell_window)),
                     ("plain", lambda: run_groups(sell_window_plain)),
                     ("csr", lambda: csr @ vpad)):
        print(f"phase3 sell_window road1M {what} L2-warm: "
              f"{profile_text(device_profile(fn, torch), bnd[0])} "
              f"(torch.profiler) [{card}]")
    kernels.append(kernel_row("sell_window", t_k, t_p, bnd, t_lib))
    del csr, u_lib
    kernels.append(gather_times(torch, p, vpad, "road1M", card))
    return kernels


def gather_times(torch, p, vpad, what, card) -> dict:
    """sell_gather on every gathered pack of plan p, as one spmv calls
    it, against its plain version and one torch.sparse_csr_tensor matvec
    over the packs' rows; its kernel row."""
    from bmsparse_tpu_torch.ops.cuda.sell_gather_kernel import (
        sell_gather, sell_gather_plain,
    )

    n = vpad.shape[0]
    tiers = gathered(p)
    packs = [pk for _, pk, _ in tiers]
    outs = [gather_out(torch, rows, vpad.device) for _, _, rows in tiers]

    def run(fn):
        return [fn(pk, vpad, n, o) for pk, o in zip(packs, outs)]

    csr = gather_csr(torch, packs, n)
    u_lib = csr @ vpad
    base = 0
    for pk in packs:
        r = pk.rows.numel()
        gap = gather_gap(torch, pk, vpad, n, u_lib[base:base + r])
        base += r
        check(gap <= GATHER_REL, f"{what}: the CSR call's gap {gap} to the "
              f"float64 sums above {GATHER_REL}")
    # L2-cold: inside an spmv the other tiers pass through L2 first
    t_k = cold_ms(lambda: run(sell_gather), torch)
    t_p = cold_ms(lambda: run(sell_gather_plain), torch)
    t_lib = cold_ms(lambda: csr @ vpad, torch)
    t_warm = median_ms(lambda: run(sell_gather), torch)
    bnd = gather_bound(packs)
    nnz = sum(pk.nnz for pk in packs)
    print(f"phase3 sell_gather {what} packs of the "
          f"{[t for t, _, _ in tiers]} tiers: {nnz} nonzeros, "
          f"{sum(pk.seg_off.shape[0] - 1 for pk in packs)} segments, "
          f"{sum(pk.rows.shape[0] for pk in packs)} rows [{card}]")
    print(f"phase3 sell_gather {what} L2-cold device ms (events behind a "
          f"queued spin, {FLUSH_BYTES} bytes written before each run): "
          f"kernel {bounded_ms_text(t_k, bnd[0])}, plain {t_p!r}, "
          f"torch.sparse_csr_tensor @ v {t_lib!r}; bound {bnd[0]!r} ms "
          f"({bnd[1]}), kernel at {bnd[0] / t_k!r} of it; L2-warm event ms "
          f"(host launch included) kernel {t_warm!r} [{card}]")
    for name, fn in (("kernel", lambda: run(sell_gather)),
                     ("plain", lambda: run(sell_gather_plain)),
                     ("csr", lambda: csr @ vpad)):
        print(f"phase3 sell_gather {what} {name} L2-warm: "
              f"{profile_text(device_profile(fn, torch), bnd[0])} "
              f"(torch.profiler) [{card}]")
    del csr, u_lib
    return kernel_row("sell_gather", t_k, t_p, bnd, t_lib)


def same_blocks(torch, md, mh, what: str) -> None:
    """md's valid blocks and values equal mh's exactly; md's padding
    blocks (if any) are empty."""
    nb = int(md.nb)
    check(nb == mh.nb and md.nnz == mh.nnz,
          f"{what}: nb {nb}/{mh.nb} or nnz {md.nnz}/{mh.nnz} differ")
    for f in ("brow", "bcol", "bmp_hi", "bmp_lo", "offsets"):
        check(torch.equal(getattr(md, f)[:nb], getattr(mh, f)[:nb]),
              f"{what}: {f} differs")
    check(torch.equal(md.values[:md.nnz], mh.values[:mh.nnz]),
          f"{what}: values differ")
    check(bool((md.brow[nb:] == md.block_rows).all())
          and not bool(md.bmp_hi[nb:].any() or md.bmp_lo[nb:].any()),
          f"{what}: padding blocks not empty")


def phase4_converter(torch):
    """The device converter on the card against the host converter at
    stencil2M and road1M: equal valid blocks, device ms against host s,
    no host copy under compact=False. Returns the host-converted
    road1M."""
    import bmsparse_tpu_torch as bt
    from bmsparse_tpu_torch.utils.testmats import make_stencil, roadnet
    from bmsparse_tpu_torch.utils.timing import time_op

    n = 2_097_152
    road = None
    for name, gen in (("stencil2M",
                       lambda: (*make_stencil(n, 8, seed=6), (n, n))),
                      ("road1M", lambda: roadnet(1_048_576, seed=8))):
        r, c, v, shape = gen()
        t0 = time.perf_counter()
        mh = bt.coo_to_bmsparse(r, c, v, shape, device="cuda")
        torch.cuda.synchronize()
        t_host = time.perf_counter() - t0
        # the triplets on the card once; the converter runs there alone
        rd, cd, vd = (torch.from_numpy(x).to("cuda") for x in (r, c, v))
        del r, c, v

        def device(compact):
            return bt.coo_to_bmsparse(rd, cd, vd, shape, compact=compact,
                                      backend="device", device="cuda")

        t_c, md = time_op(device, True, warmup=1, iters=3, device="cuda")
        same_blocks(torch, md, mh, f"{name} device converter")
        del md
        t_p, mp = time_op(device, False, warmup=1, iters=3, device="cuda")
        same_blocks(torch, mp, mh, f"{name} device converter, compact=False")
        del mp
        padded = []
        syncs = count_syncs(lambda: padded.append(device(False)), torch)
        check(not syncs and isinstance(padded[0].nb, torch.Tensor),
              f"{name}: compact=False made host copies at {syncs}")
        print(f"phase4 converter {name}: nnz={mh.nnz} blocks={mh.nb}; "
              f"device converter {t_c * 1e3!r} ms (compact=True, one sync), "
              f"{t_p * 1e3!r} ms (compact=False, host syncs {syncs}); host "
              f"converter {t_host!r} s; valid blocks and values equal")
        del rd, cd, vd, padded
        if name == "road1M":
            road = mh
        del mh
        torch.cuda.empty_cache()
    return road


def plan_items(p):
    """(name, value) of every field of a Prepared plan, of its StreamPlan
    and of its SELL packs (windowed and gathered) but the container and
    the cached dense tiles."""
    import dataclasses

    for f in dataclasses.fields(p):
        x = getattr(p, f.name)
        if f.name in ("m", "dense_flat_"):
            continue
        if f.name == "stream" and x is not None:
            for g in dataclasses.fields(x):
                yield f"stream.{g.name}", getattr(x, g.name)
        elif f.name == "sell_pack":
            for g, pk in enumerate(x):
                yield from ((f"sell_pack[{g}].{k}", t) for k, t in (
                    pk.state().items() if pk is not None else [("", None)]))
        elif f.name in ("sell_gpack", "ovf_gpack") and x is not None:
            yield from ((f"{f.name}.{k}", t) for k, t in x.state().items())
        else:
            yield f.name, x


def same_value(torch, a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.is_cuda and b.is_cuda
                and a.dtype == b.dtype and torch.equal(a, b))
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(
            same_value(torch, x, y) for x, y in zip(a, b))
    return a == b


def phase4_persistence(torch, road, tmp):
    """save_bmsparse/load_bmsparse of road1M; save_prepared/load_prepared
    of road1M's block tiers and web256k's stream tier, each loaded plan
    equal to the saved one field for field, its SpMV bitwise equal and
    launching the plan's kernels; the loaded road1M packs held against
    the twins. Returns sell_window's and sell_gather's largest
    max_abs_err there, by kernel."""
    import bmsparse_tpu_torch as bt
    from bmsparse_tpu_torch.io.binary import load_prepared, save_prepared
    from bmsparse_tpu_torch.ops.cuda.sell_gather_kernel import sell_gather
    from bmsparse_tpu_torch.ops.cuda.sell_kernel import (
        sell_window, sell_window_plain,
    )
    from bmsparse_tpu_torch.ops.cuda.shuffle_kernel import (
        rowwise_gather, window_product,
    )
    from bmsparse_tpu_torch.ops.cuda.spmv_kernel import dia_spmv
    from bmsparse_tpu_torch.utils.testmats import webgraph

    errs = {"sell_window": 0.0, "sell_gather": 0.0}
    path = os.path.join(tmp, "road1M.npz")
    t0 = time.perf_counter()
    bt.save_bmsparse(path, road)
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = bt.load_bmsparse(path, device="cuda")
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    same_blocks(torch, loaded, road, "road1M load_bmsparse")
    check((loaded.shape, loaded.transposed, loaded.dtype)
          == (road.shape, road.transposed, road.dtype), "road1M: metadata")
    print(f"phase4 persistence road1M: save_bmsparse {t_save!r} s "
          f"({os.path.getsize(path)} bytes), load_bmsparse {t_load!r} s; "
          f"every array equal")
    web = bt.coo_to_bmsparse(*webgraph(262_144, avg_deg=8, seed=9),
                             device="cuda")
    cases = (("road1M", loaded, "off", (dia_spmv, sell_window, sell_gather)),
             ("web256k", web, "force", (window_product, rowwise_gather)))
    for name, m, stream, kernels in cases:
        t0 = time.perf_counter()
        p = bt.prepare(m, stream=stream)
        torch.cuda.synchronize()
        t_prep = time.perf_counter() - t0
        f = os.path.join(tmp, f"{name}.plan")
        save_prepared(f, p)
        t0 = time.perf_counter()
        p2 = load_prepared(f, m)
        torch.cuda.synchronize()
        t_lp = time.perf_counter() - t0
        check(p2 is not None and p2.m is m, f"{name}: load_prepared refused")
        for (k, a), (_, b) in zip(plan_items(p), plan_items(p2)):
            check(same_value(torch, a, b), f"{name}: plan field {k} differs")
        v = torch.from_numpy(np.random.default_rng(0).standard_normal(
            m.num_cols).astype(np.float32)).to("cuda")
        # the stream tier's residue is an index_add_, whose atomics may
        # add in any order: both plans run in torch's deterministic mode
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            u = bt.spmv(p, v)
            for k in kernels:
                k.launches = 0
            u2 = bt.spmv(p2, v)
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
        counts = {k.__name__: k.launches for k in kernels}
        print(f"phase4 persistence {name} (stream={stream!r}): prepare() "
              f"{t_prep!r} s, load_prepared() {t_lp!r} s "
              f"({os.path.getsize(f)} bytes); spmv on the loaded plan "
              f"bitwise equal: {torch.equal(u, u2)}; launches {counts}")
        check(torch.equal(u, u2), f"{name}: spmv on the loaded plan differs")
        check(all(n > 0 for n in counts.values()),
              f"{name}: the loaded plan's kernels were not launched")
        if name == "road1M":
            errs["sell_window"] = pack_check(
                torch, p2, v, "road1M loaded plan", sell_window,
                sell_window_plain)
            errs["sell_gather"] = gather_check(torch, p2, v,
                                               "road1M loaded plan")
        del p, p2
    return errs


def run_cli(main, argv, label):
    """Run a CLI's main(argv) in process; print its output under `label`
    and return (rc, output)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    out = buf.getvalue()
    for line in out.splitlines():
        print(f"phase4 {label}: {line}")
    return rc, out


def final_of(out: str) -> float:
    import re

    return float(re.search(r"Final: (\S+)", out).group(1))


def phase4_clis(torch, tmp):
    """band256k written with write_matrix_market and read by both parsers;
    cli.spmv, cli.spgemm (float32, bfloat16) and cli.batch on it, with
    their checks and launch counts."""
    import shutil

    from bmsparse_tpu_torch.cli import batch, spgemm, spmv
    from bmsparse_tpu_torch.io.matrix_market import (
        read_matrix_market, write_matrix_market,
    )
    from bmsparse_tpu_torch.ops.cuda.spgemm_kernel import numeric_sell
    from bmsparse_tpu_torch.ops.cuda.spgemm_window_kernel import (
        numeric_window,
    )
    from bmsparse_tpu_torch.ops.cuda.spmv_kernel import dia_spmv
    from bmsparse_tpu_torch.utils.testmats import make_banded

    n = 262_144
    r, c, v = make_banded(n, 16, seed=2)
    path = os.path.join(tmp, "band256k.mtx")
    t0 = time.perf_counter()
    write_matrix_market(path, r, c, v, (n, n))
    t_w = time.perf_counter() - t0
    parsed = {}
    for native in (True, False):
        t0 = time.perf_counter()
        rr, cc, vv, shape = read_matrix_market(path, native=native)
        k = np.lexsort((cc, rr))
        parsed[native] = (rr[k], cc[k], vv[k], shape,
                          time.perf_counter() - t0)
    nat, sci = parsed[True], parsed[False]
    check(nat[3] == sci[3] == (n, n) and all(
        np.array_equal(a, b) for a, b in zip(nat[:3], sci[:3])),
        "band256k: the native parser and scipy disagree")
    check(np.array_equal(nat[2], v[np.lexsort((c, r))]),
          "band256k: parsed values differ from the written ones")
    print(f"phase4 mtx band256k: nnz={len(r)} write_matrix_market {t_w!r} s; "
          f"native parser {nat[4]!r} s, scipy {sci[4]!r} s; equal triplets")
    del r, c, v, parsed, nat, sci

    dia_spmv.launches = 0
    rc, out = run_cli(spmv.main, [tmp, "band256k", "--check"], "cli.spmv")
    launched = dia_spmv.launches
    check(rc == 0 and final_of(out) < 1e-4, f"cli.spmv: rc {rc}, {out}")
    check(launched > 0, "cli.spmv: dia_spmv not launched")
    print(f"phase4 cli.spmv band256k: rc {rc}, dia_spmv launches {launched}")
    for dtype, bound_ in (("float32", 1e-5), ("bfloat16", 1e-2)):
        numeric_sell.launches = numeric_window.launches = 0
        rc, out = run_cli(spgemm.main, [tmp, "band256k", "band256k",
                                        "--check", "--dtype", dtype],
                          f"cli.spgemm {dtype}")
        counts = {"numeric_window": numeric_window.launches,
                  "numeric_sell": numeric_sell.launches}
        check(rc == 0 and final_of(out) < bound_,
              f"cli.spgemm {dtype}: rc {rc}, Final above {bound_}")
        check(sum(counts.values()) > 0,
              f"cli.spgemm {dtype}: no product kernel launched")
        print(f"phase4 cli.spgemm band256k {dtype}: rc {rc}, Final below "
              f"{bound_}, launches {counts}")
    shutil.copy(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "data", "real", "A_matrix.mtx"), tmp)
    lst = os.path.join(tmp, "list.txt")
    with open(lst, "w") as f:
        f.write("band256k\nA_matrix\n")
    out_file = os.path.join(tmp, "spmv_out.txt")
    rc, _ = run_cli(batch.main, ["spmv", tmp, lst, out_file,
                                 "--args=--check"], "cli.batch")
    with open(out_file) as f:
        text = f.read()
    for line in text.splitlines():
        print(f"phase4 cli.batch out: {line}")
    check(rc == 0 and text.count("rc=0)") == 2 and "ERROR" not in text,
          f"cli.batch: rc {rc}")


def phase4_examples(torch):
    """cg at n = 2,097,152 (100 iterations, no host sync inside) and
    matrix_powers at n = 1,048,576, band 8."""
    from bmsparse_tpu_torch.examples import cg as cg_ex
    from bmsparse_tpu_torch.examples import matrix_powers
    from bmsparse_tpu_torch.ops.cuda.spgemm_kernel import numeric_sell
    from bmsparse_tpu_torch.ops.cuda.spgemm_window_kernel import (
        numeric_window,
    )
    from bmsparse_tpu_torch.ops.cuda.spmv_kernel import dia_spmv

    n, iters = 2_097_152, 100
    p, b = cg_ex.setup(n, "cuda")
    cg_ex.cg(p, b, iters)
    dia_spmv.launches = 0
    res = []
    syncs = count_syncs(lambda: res.append(cg_ex.cg(p, b, iters)), torch)
    launched = dia_spmv.launches
    x, hist = res[0]
    r_end = float(hist[-1]) ** 0.5
    r0 = float(torch.dot(b, b)) ** 0.5
    ms = median_ms(lambda: cg_ex.cg(p, b, iters), torch)
    print(f"phase4 cg n={n} iters={iters}: |r| {r_end!r} from |b| {r0!r} "
          f"(ratio {r_end / r0!r}); host syncs in the loop {syncs}; "
          f"dia_spmv launches {launched}; {ms * 1e3 / iters!r} us/iteration "
          f"(events, median of {ITERS} solves)")
    check(bool(torch.isfinite(x).all()) and r_end <= 1e-3 * r0,
          f"cg: residual {r_end} against {r0}")
    check(not syncs, f"cg: host syncs inside the loop at {syncs}")
    check(launched == iters, f"cg: dia_spmv launched {launched} times")
    del p, b, x, hist, res

    numeric_sell.launches = numeric_window.launches = 0
    r = matrix_powers.run(1_048_576, 8, device="cuda")
    counts = {"numeric_window": numeric_window.launches,
              "numeric_sell": numeric_sell.launches}
    print(f"phase4 matrix_powers n={r['n']} band 8: nnz {r['nnz']}, A^2 nnz "
          f"{r['nnz_a2']}; prepare_product {r['plan_s']!r} s; cached "
          f"multiply {r['multiply_s'] * 1e3!r} ms (events, median of 5); "
          f"A^4 v error vs scipy {r['err']!r}; launches {counts}")
    check(r["err"] < matrix_powers.ERR_BOUND,
          f"matrix_powers: error {r['err']}")
    check(sum(counts.values()) > 0, "matrix_powers: no product kernel ran")


def phase4_surfaces(torch):
    """The user surfaces: the device converter, persistence, the CLIs and
    the examples, through the public API on the card. Returns
    sell_window's and sell_gather's largest max_abs_err on the loaded
    road1M plan, by kernel."""
    import tempfile

    t0 = time.perf_counter()
    road = phase4_converter(torch)
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(dir=here, prefix=".chip_smoke_") as tmp:
        errs = phase4_persistence(torch, road, tmp)
        del road
        phase4_clis(torch, tmp)
    phase4_examples(torch)
    print(f"phase4 seconds: {time.perf_counter() - t0:.1f}")
    return errs


def same_structure(torch, c, c_ref, what: str) -> float:
    """C's blocks and bitmaps equal c_ref's exactly; returns the values'
    max|dC| / max|C|."""
    nb, nnz = int(c.nb), int(c.nnz)
    check(nb == int(c_ref.nb) and nnz == int(c_ref.nnz),
          f"{what}: block count or nnz differs ({nb}, {nnz} vs "
          f"{int(c_ref.nb)}, {int(c_ref.nnz)})")
    for f in ("brow", "bcol", "bmp_hi", "bmp_lo", "offsets"):
        check(torch.equal(getattr(c, f)[:nb], getattr(c_ref, f)[:nb]),
              f"{what}: C.{f} differs")
    ref = c_ref.values[:nnz].double()
    return float((c.values[:nnz].double() - ref).abs().max()
                 / max(float(ref.abs().max()), 1e-30))


def phase5_spmv_shards(torch, name, m, v, errs, card):
    """Every shard of a 4-shard plan of m, in turn on this one card: the
    DIA kernel at the shard's column shift against its plain twin, and
    the shards' rows against scipy. Returns the shifts it ran."""
    from bmsparse_tpu_torch.ops.cuda.spmv_kernel import (
        dia_spmv, dia_spmv_plain,
    )
    from bmsparse_tpu_torch.parallel.partition import partition
    from bmsparse_tpu_torch.parallel.plan import prepare_sharded
    from bmsparse_tpu_torch.parallel.spmv import (
        local_spmv_prepared, shard_geometry, shard_window,
    )

    t0 = time.perf_counter()
    sp = prepare_sharded(partition(m, 4, align=16))
    t_prep = time.perf_counter() - t0
    ref = m.to_scipy() @ v.cpu().double().numpy()
    shifts = []
    for ex in ("halo", "allgather") if sp.halo is not None else ("allgather",):
        parts = []
        for s in range(4):
            vpad = shard_window(sp, v, s, ex)
            shift = shard_geometry(sp, s, vpad.shape[0], ex)[0]
            check(bool(sp.dia_offsets), f"{name}: no DIA tier in the shards")
            got = dia_spmv(sp.dia[s], vpad, sp.dia_offsets, shift)
            want = dia_spmv_plain(sp.dia[s], vpad, sp.dia_offsets, shift)
            torch.testing.assert_close(got, want, **TOL)
            errs["dia_spmv"] = max(errs["dia_spmv"], max_abs(got, want))
            shifts.append(shift)
            parts.append(local_spmv_prepared(sp, s, vpad, ex, kernels=True))
        u = torch.cat(parts)[:m.num_rows]
        rel = float(np.abs(u.cpu().double().numpy() - ref).max()
                    / max(np.abs(ref).max(), 1e-30))
        print(f"phase5 {name} 4 shards in turn, exchange {ex!r} (halo "
              f"{sp.halo}): dia_spmv shifts {shifts[-4:]}, kernel vs plain "
              f"max_abs_err {errs['dia_spmv']!r}, max|u-ref|/max|ref| vs "
              f"scipy float64 = {rel!r} [{card}]")
        check(rel <= ORACLE_REL, f"{name} 4 shards: error {rel} vs scipy")
    print(f"phase5 {name}: prepare_sharded(4 shards) {t_prep!r} s (host) "
          f"[{card}]")
    return sp, shifts


def phase5_multidevice(torch, stencil, band, card):
    """The multi-device path (bmsparse_tpu_torch/parallel) on this one
    card: an NCCL group of world size 1 drives the user entry points
    (dry run, stencil2M sharded SpMV, band2M sharded product, band256k
    padded SpGEMM); every shard of 4-shard plans then runs in turn on the
    card, so the kernels see non-zero shifts and the exchanged operand
    tables at full size. Returns the main path's launches and the kernels'
    errors against their plain twins."""
    import torch.distributed as dist

    import bmsparse_tpu_torch as bt
    from bmsparse_tpu_torch.ops.cuda.spgemm_kernel import numeric_sell
    from bmsparse_tpu_torch.ops.cuda.spmv_kernel import dia_spmv
    from bmsparse_tpu_torch.parallel.dryrun import (
        big_band, dryrun_multichip,
    )
    from bmsparse_tpu_torch.parallel.launch import init_group
    from bmsparse_tpu_torch.parallel.partition import (
        ShardedBmSparse, partition,
    )
    from bmsparse_tpu_torch.parallel.plan import prepare_sharded
    from bmsparse_tpu_torch.parallel.product import (
        local_multiply, prepare_sharded_product, shard_b_needed,
        sharded_multiply,
    )
    from bmsparse_tpu_torch.parallel.spgemm import (
        estimate_bounds, sharded_spgemm,
    )
    from bmsparse_tpu_torch.parallel.spmv import (
        shard_geometry, shard_window, sharded_spmv_prepared,
    )
    from bmsparse_tpu_torch.utils.testmats import make_banded

    t_phase = time.perf_counter()
    launches = {"dia_spmv": 0, "numeric_sell": 0}
    errs = {"dia_spmv": 0.0, "numeric_sell": 0.0}
    mesh = init_group(0, 1, "cuda")
    try:
        print(f"phase5 process group: backend {dist.get_backend()}, world "
              f"{mesh.size}, rank {mesh.rank}, {mesh.device} (loopback TCP "
              "rendezvous). One card: the exchanges run over NCCL with no "
              "peer, and the 4-shard runs below take their shards in turn "
              "on this card; none of this is a multi-card run.")

        dia_spmv.launches = numeric_sell.launches = 0
        t0 = time.perf_counter()
        dr = dryrun_multichip(1, "cuda")
        torch.cuda.synchronize()
        print(f"phase5 dryrun_multichip(1, 'cuda'): "
              f"{time.perf_counter() - t0:.1f} s; launches dia_spmv "
              f"{dia_spmv.launches}, numeric_sell {numeric_sell.launches} "
              f"[{card}]")
        check(dia_spmv.launches > 0 and numeric_sell.launches > 0,
              "dry run: a kernel was not launched")

        # ---- stencil2M: the sharded tiered SpMV --------------------------
        m, p, v = stencil
        v_np = v.cpu().double().numpy()
        t0 = time.perf_counter()
        sp = prepare_sharded(partition(m, 1, align=16))
        torch.cuda.synchronize()
        t_prep = time.perf_counter() - t0
        dia_spmv.launches = 0
        u = sharded_spmv_prepared(sp, v, mesh)
        torch.cuda.synchronize()
        launches["dia_spmv"] += dia_spmv.launches
        ex = "halo" if sp.halo is not None else "allgather"
        vpad = shard_window(sp, v, 0, ex)
        shift = shard_geometry(sp, 0, vpad.shape[0], ex)[0]
        print(f"phase5 stencil2M sharded_spmv_prepared (world 1): "
              f"partition + prepare_sharded {t_prep!r} s (host); ndiags "
              f"{len(sp.dia_offsets)}, sell_ks {sp.sell_ks}, halo {sp.halo}, "
              f"exchange {ex!r}, dia_spmv shift {shift}, launches dia_spmv "
              f"{dia_spmv.launches} [{card}]")
        check(dia_spmv.launches > 0, "stencil2M: dia_spmv not launched")
        ref = m.to_scipy() @ v_np
        rel = float(np.abs(u.cpu().double().numpy() - ref).max()
                    / max(np.abs(ref).max(), 1e-30))
        u1 = bt.spmv(p, v)
        torch.testing.assert_close(u, u1, **TOL)
        u_ag = sharded_spmv_prepared(sp, v, mesh, exchange="allgather")
        torch.testing.assert_close(u_ag, u1, **TOL)
        print(f"phase5 stencil2M: max|u-ref|/max|ref| vs scipy float64 = "
              f"{rel!r}; vs single-device spmv max_abs_err "
              f"{max_abs(u, u1)!r} (halo), {max_abs(u_ag, u1)!r} "
              f"(allgather) [{card}]")
        check(rel <= ORACLE_REL, f"stencil2M sharded: error {rel} vs scipy")

        # ---- band2M: the sharded product ---------------------------------
        a, b, _, pp = band
        t0 = time.perf_counter()
        spp = prepare_sharded_product(partition(a, 1, align=16),
                                      partition(b, 1, align=16))
        torch.cuda.synchronize()
        t_pp = time.perf_counter() - t0
        numeric_sell.launches = 0
        cs = sharded_multiply(spp, mesh)
        torch.cuda.synchronize()
        launches["numeric_sell"] += numeric_sell.launches
        check(numeric_sell.launches == 1,
              f"band2M: numeric_sell launched {numeric_sell.launches} times")
        c1 = pp()
        rel = same_structure(torch, cs.to_bmsparse(), c1, "band2M sharded")
        print(f"phase5 band2M sharded_multiply (world 1): partition + "
              f"prepare_sharded_product {t_pp!r} s (host, plan_seconds "
              f"{spp.plan_seconds!r}); K-groups {list(zip(spp.ks, spp.caps))}"
              f", exchange {spp.exchange!r}, launches numeric_sell "
              f"{numeric_sell.launches}; C structure equal to pp()'s, nnz(C) "
              f"{c1.nnz}, values max|dC|/max|C| {rel!r} [{card}]")
        check(rel <= 1e-5, f"band2M sharded: values differ by {rel}")

        # ---- band256k: the padded SpGEMM (plain torch) -------------------
        n = 262_144
        r, c, vals = make_banded(n, 16, seed=2)
        a256 = bt.coo_to_bmsparse(r, c, vals, (n, n), device="cuda")
        b256 = bt.coo_to_bmsparse(r, c, vals, (n, n), transposed=True,
                                  device="cuda")
        sa, sb = partition(a256, 1), partition(b256, 1)
        bounds = estimate_bounds(sa, sb)
        t0 = time.perf_counter()
        cpad = sharded_spgemm(sa, sb, mesh, **bounds)
        torch.cuda.synchronize()
        t_pad = time.perf_counter() - t0
        rel = same_structure(torch, cpad.to_bmsparse(), bt.spgemm(a256, b256),
                             "band256k sharded_spgemm")
        print(f"phase5 band256k sharded_spgemm (padded, plain torch, world "
              f"1): bounds {bounds}, {t_pad!r} s (host clock, one call); C "
              f"structure equal to spgemm()'s, values max|dC|/max|C| {rel!r} "
              f"[{card}]")
        check(rel <= 1e-5, f"band256k padded: values differ by {rel}")
        del cpad, a256, b256, sa, sb

        # ---- every shard of 4-shard plans, in turn -----------------------
        sp4, sh1 = phase5_spmv_shards(torch, "stencil2M", m, v, errs,
                                     card)
        big, vbig = big_band("cuda")
        _, sh2 = phase5_spmv_shards(torch, "band262k", big, vbig, errs, card)
        check(any(x != 0 for x in sh1 + sh2), "no non-zero DIA shift ran")
        t0 = time.perf_counter()
        spp4 = prepare_sharded_product(partition(a, 4, align=16),
                                       partition(b, 4, align=16))
        torch.cuda.synchronize()
        t_pp4 = time.perf_counter() - t0
        vals4 = []
        for s in range(4):
            bn = shard_b_needed(spp4, s)
            got = local_multiply(spp4, s, bn, kernels=True)
            want = local_multiply(spp4, s, bn, kernels=False)
            torch.testing.assert_close(got, want, **TOL)
            errs["numeric_sell"] = max(errs["numeric_sell"],
                                       max_abs(got, want))
            vals4.append(got)
        c4 = ShardedBmSparse(
            brow=spp4.cbrow, bcol=spp4.cbcol, bmp_hi=spp4.c_hi,
            bmp_lo=spp4.c_lo, offsets=spp4.c_offsets,
            values=torch.stack(vals4), nb=spp4.c_nb,
            num_rows=spp4.num_rows, num_cols=spp4.num_cols, nnz=-1,
            rows_per_shard=spp4.rows_per_shard).to_bmsparse()
        rel = same_structure(torch, c4, c1, "band2M 4 shards")
        print(f"phase5 band2M 4 shards in turn: prepare_sharded_product "
              f"{t_pp4!r} s (host); exchange {spp4.exchange!r}, max_send "
              f"{spp4.max_send}, plan-time bytes per multiply: selective "
              f"{spp4.comm_bytes_selective}, useful "
              f"{spp4.comm_bytes_useful}, all-gather "
              f"{spp4.comm_bytes_allgather} (counted, not measured); "
              f"numeric_sell vs plain max_abs_err {errs['numeric_sell']!r};"
              f" C structure equal to pp()'s, values max|dC|/max|C| {rel!r} "
              f"[{card}]")
        check(rel <= 1e-5, f"band2M 4 shards: values differ by {rel}")
        del c4, vals4, spp4

        # ---- times --------------------------------------------------------
        dia_cases = [
            ("stencil2M single-device, shift 0", p.dia, v, p.dia_offsets, 0),
            (f"stencil2M world 1, shift {shift}", sp.dia[0], vpad,
             sp.dia_offsets, shift)]
        vpad1 = shard_window(sp4, v, 1)
        shift1 = shard_geometry(sp4, 1, vpad1.shape[0],
                                "halo" if sp4.halo is not None
                                else "allgather")[0]
        dia_cases.append((f"stencil2M shard 1 of 4, shift {shift1}",
                          sp4.dia[1], vpad1, sp4.dia_offsets, shift1))
        # CUDA events: torch.profiler's traces of this kernel read nothing
        # or less than its bound in whole-script runs (cause not found)
        for what, dia, vv, offs, sh in dia_cases:
            t_k = median_ms(lambda: dia_spmv(dia, vv, offs, sh), torch)
            t_cold = cold_ms(lambda: dia_spmv(dia, vv, offs, sh), torch)
            bnd = bound(nbytes(dia, vv) + dia.shape[1] * 128 * 4,
                        2 * dia.numel())[0]
            print(f"phase5 dia_spmv {what} {tuple(dia.shape)}: event "
                  f"{t_k!r} ms, L2-cold device {bounded_ms_text(t_cold, bnd)}"
                  f" (bound {bnd!r} ms) [{card}]")
        for what, fn in (("sharded_spmv_prepared world 1",
                          lambda: sharded_spmv_prepared(sp, v, mesh)),
                         ("single-device spmv", lambda: bt.spmv(p, v)),
                         ("sharded_multiply world 1",
                          lambda: sharded_multiply(spp, mesh)),
                         ("single-device pp()", pp)):
            t = median_ms(fn, torch)
            prof = device_profile(fn, torch)
            print(f"phase5 {what}: event {t!r} ms, {profile_text(prof)} "
                  f"[{card}]")
        print(f"phase5 host seconds [{card}]: prepare_sharded stencil2M "
              f"world 1 {t_prep!r}, prepare_sharded_product band2M world 1 "
              f"{t_pp!r}, 4 shards {t_pp4!r}")
    finally:
        dist.destroy_process_group()
    print(f"phase5 seconds: {time.perf_counter() - t_phase:.1f} [{card}]")
    return launches, errs


# phase 6 is cut to keep it near two minutes: n is half the band2M scale,
# and d = 2 is left out (d = 4 and 8 take the same halo and selective
# exchanges; the CPU tests check d = 2)
SCALING_N = 1_048_576
SCALING_SIZES = (1, 4, 8)


def host_and_event_ms(fn, torch) -> tuple:
    """ITERS calls of fn after WARMUP, each from an idle device: the host
    ms spent in each call and the CUDA-event ms of each (host launch gaps
    included)."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    host, ev = [], []
    for _ in range(ITERS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        host.append((time.perf_counter() - t0) * 1e3)
        end.synchronize()
        ev.append(start.elapsed_time(end))
    return host, ev


def spread_text(xs) -> str:
    import statistics

    return (f"median {statistics.median(xs)!r} (min {min(xs)!r}, max "
            f"{max(xs)!r}) ms")


def phase6_d1(torch, m, coo, v, mesh, t_roof_ms, card):
    """The scaling report's measured d = 1 row, its plans built again as
    the report's ranks build them (partition(m, 1, align=16),
    prepare_sharded; prepare_sharded_product with B in the transposed
    layout): dia_spmv at shard 0's window and shift and numeric_sell
    through local_multiply against their plain twins, then the d = 1 SpMV
    call taken apart by CUDA events, the host clock and the syncs it
    makes. t_roof_ms: the report's compute_s at d = 1 in ms. Returns the
    kernels' max_abs_err."""
    from bmsparse_tpu_torch import coo_to_bmsparse
    from bmsparse_tpu_torch.ops.cuda.spmv_kernel import (
        dia_spmv, dia_spmv_plain,
    )
    from bmsparse_tpu_torch.parallel.partition import partition
    from bmsparse_tpu_torch.parallel.plan import prepare_sharded
    from bmsparse_tpu_torch.parallel.product import (
        local_multiply, prepare_sharded_product, shard_b_needed,
    )
    from bmsparse_tpu_torch.parallel.spmv import (
        _resolve_exchange, local_spmv_prepared, shard_geometry,
        shard_window, sharded_spmv_prepared,
    )

    t0 = time.perf_counter()
    sm = partition(m, 1, align=16)
    sp = prepare_sharded(sm)
    b = coo_to_bmsparse(*coo, transposed=True, backend="device",
                        device="cuda")
    spp = prepare_sharded_product(sm, partition(b, 1, align=16))
    torch.cuda.synchronize()
    t_plan = time.perf_counter() - t0
    ex = _resolve_exchange(sp, "auto")
    vpad = shard_window(sp, v, 0, ex)
    shift = shard_geometry(sp, 0, vpad.shape[0], ex)[0]
    check(bool(sp.dia_offsets), "phase 6: no DIA tier in the d = 1 plan")
    got = dia_spmv(sp.dia[0], vpad, sp.dia_offsets, shift)
    want = dia_spmv_plain(sp.dia[0], vpad, sp.dia_offsets, shift)
    torch.testing.assert_close(got, want, **TOL)
    errs = {"dia_spmv": max_abs(got, want)}
    bn = shard_b_needed(spp, 0)
    got = local_multiply(spp, 0, bn, kernels=True)
    want = local_multiply(spp, 0, bn, kernels=False)
    torch.testing.assert_close(got, want, **TOL)
    errs["numeric_sell"] = max_abs(got, want)
    del got, want, bn
    print(f"phase6 d=1 plans on the card (partition + prepare_sharded + "
          f"device converter for B + prepare_sharded_product) {t_plan!r} s "
          f"(host clock): ndiags {len(sp.dia_offsets)}, sell_ks "
          f"{sp.sell_ks}, exchange {ex!r}, dia_spmv shift {shift}; K-groups "
          f"{list(zip(spp.ks, spp.caps))}; kernel vs plain max_abs_err: "
          f"dia_spmv {errs['dia_spmv']!r}, numeric_sell "
          f"{errs['numeric_sell']!r} [{card}]")

    def call():
        return sharded_spmv_prepared(sp, v, mesh)

    host, ev = host_and_event_ms(call, torch)
    # the spin before each L2-cold run must outlast the host's enqueue:
    # take at least four times the slowest call's host time
    unit = median_ms(lambda: torch.cuda._sleep(SPIN_CYCLES), torch)
    k = max(1, math.ceil(4 * max(host) / unit))
    cold = cold_ms(call, torch, k * SPIN_CYCLES)
    body = cold_ms(lambda: local_spmv_prepared(sp, 0, vpad, ex, True),
                   torch, k * SPIN_CYCLES)
    dia = cold_ms(lambda: dia_spmv(sp.dia[0], vpad, sp.dia_offsets, shift),
                  torch)
    syncs = count_syncs(call, torch)
    print(f"phase6 spmv d=1 taken apart ({ITERS} calls): event "
          f"{spread_text(ev)} from an idle device, host launch gaps "
          f"included; host clock in the call {spread_text(host)}; host "
          f"syncs in the call {syncs}. L2-cold device time, launches "
          f"queued behind a {k * unit!r} ms spin: the call "
          f"{bounded_ms_text(cold, t_roof_ms)}, its local body "
          f"(local_spmv_prepared, no exchange) {body!r} ms, dia_spmv alone "
          f"{dia!r} ms [{card}]")
    print(f"phase6 spmv d=1 against the model's compute_s {t_roof_ms!r} ms "
          f"(HBM roofline): {t_roof_ms / min(ev)!r} of it by the fastest "
          f"event time, {t_roof_ms / cold!r} by the device time without "
          f"host gaps [{card}]")
    check(cold >= t_roof_ms, "phase 6: a device time below the HBM roofline")
    return errs


def phase6_scaling(torch, card):
    """The scaling report (bmsparse_tpu_torch/cli/scaling.py) on the card
    on the CLI's synthetic band at n = SCALING_N; d = 1 measured
    over an NCCL group of world 1 in this process (sharded SpMV and product
    against scipy, CUDA events), its kernels held against their twins and
    its SpMV call taken apart (phase6_d1); d = 4, 8 projected from plans
    built on the host with the model's data-sheet figures; then the CLI
    once as a subprocess at its default n. Returns the main path's
    launches and the kernels' max_abs_err."""
    import tempfile

    import torch.distributed as dist

    from bmsparse_tpu_torch import coo_to_bmsparse
    from bmsparse_tpu_torch.cli import scaling
    from bmsparse_tpu_torch.ops.cuda.spgemm_kernel import numeric_sell
    from bmsparse_tpu_torch.ops.cuda.spmv_kernel import dia_spmv
    from bmsparse_tpu_torch.parallel.launch import init_group

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    coo = scaling.synthetic("band", SCALING_N)
    m = coo_to_bmsparse(*coo, backend="device", device="cuda")
    v = np.random.default_rng(1).standard_normal(SCALING_N).astype(
        np.float32)
    t_build = time.perf_counter() - t0
    check(not dist.is_initialized(), "a process group is still up")
    mesh = init_group(0, 1, "cuda")
    try:
        dia_spmv.launches = numeric_sell.launches = 0
        t0 = time.perf_counter()
        rep = scaling.build_report(m, list(SCALING_SIZES), v, iters=ITERS,
                                   device="cuda")
        t_rep = time.perf_counter() - t0
        launches = {"dia_spmv": dia_spmv.launches,
                    "numeric_sell": numeric_sell.launches}
        t_roof = rep["spmv"][0]["projected"]["compute_s"]
        errs = phase6_d1(torch, m, coo, torch.from_numpy(v).cuda(), mesh,
                         t_roof * 1e3, card)
    finally:
        dist.destroy_process_group()
    del coo
    model = rep["model"]
    print(f"phase6 scaling report band n={SCALING_N}: nnz {m.nnz}, blocks "
          f"{int(m.nb)}; numpy generator + device converter {t_build!r} s, "
          f"build_report {t_rep!r} s "
          f"(host clock); model: {model['figures']} figures ({model['link']}"
          f" {model['link_gbps']} GB/s each way, HBM {model['hbm_gbps']} "
          f"GB/s, {model['gpus_per_node']} GPUs per node, "
          f"{model['network_gbps_per_gpu']} GB/s network per GPU; data "
          f"sheet, not measured) for card {model['card']!r}; launches "
          f"{launches} [{card}]")
    check(model["card"] == card.split(",")[0].strip(),
          f"model card {model['card']!r} is not nvidia-smi's {card!r}")
    check(all(n > 0 for n in launches.values()),
          f"phase 6: a kernel was not launched: {launches}")
    check("spgemm_skipped" not in rep, "phase 6: the SpGEMM rows were "
          f"skipped: {rep.get('spgemm_skipped')}")
    effs = []
    for row in rep["spmv"]:
        pr = row["projected"]
        effs += [pr["efficiency_serialized"], pr["efficiency_overlapped"]]
        print(f"phase6 spmv d={row['d']}: projected (data-sheet model) "
              f"exchange {pr['exchange']!r}, {pr['nvlink_bytes_per_gpu']} B "
              f"per GPU, compute_s {pr['compute_s']!r}, nvlink_s "
              f"{pr['nvlink_s']!r}, efficiency {pr['efficiency_serialized']!r}"
              f" serialized / {pr['efficiency_overlapped']!r} overlapped; "
              f"shard_imbalance {row['shard_imbalance']!r}")
    gem = {row["d"]: row for row in rep["spgemm"]}
    check(sorted(gem) == list(SCALING_SIZES),
          f"phase 6: SpGEMM rows {sorted(gem)}")
    for d, row in gem.items():
        if d == 1:
            continue
        pr = row["projected"]
        effs += [pr["efficiency_serialized"], pr["efficiency_overlapped"]]
        print(f"phase6 spgemm d={d}: exchange {row['exchange']!r}, max_send "
              f"{row['max_send']}, plan-time bytes per multiply: selective "
              f"{row['selective_wire_bytes_total']}, useful "
              f"{row['selective_useful_bytes_total']}, all-gather "
              f"{row['allgather_bytes_total']}; projected (data-sheet "
              f"model) compute_s {pr['compute_s']!r}, nvlink_s "
              f"{pr['nvlink_s']!r}, efficiency {pr['efficiency_serialized']!r}"
              f" / {pr['efficiency_overlapped']!r}; plan "
              f"{row['plan_seconds_host']!r} s (host)")
    check(all(0 < e <= 1 for e in effs),
          f"phase 6: a projected efficiency outside (0, 1]: {effs}")
    for what, ms in (("spmv", rep["spmv"][0].get("measured")),
                     ("spgemm", gem[1].get("measured"))):
        check(ms is not None, f"phase 6: no measured d = 1 {what} row")
        check(ms["ok"] and ms["max_rel_err"] < ORACLE_REL,
              f"phase 6 {what} d = 1: error {ms['max_rel_err']} vs scipy")
        check(ms["backend"] == "nccl" and ms["world"] == 1,
              f"phase 6 {what}: measured on {ms['backend']} world "
              f"{ms['world']}")
        print(f"phase6 {what} d=1 measured by build_report (NCCL world 1, "
              f"{ms['exchange']!r}): event median of {ITERS} "
              f"{ms['seconds'] * 1e3!r} ms, max_rel_err vs scipy float64 "
              f"{ms['max_rel_err']!r} [{card}]")
    check(t_roof <= rep["spmv"][0]["measured"]["seconds"],
          "phase 6: a time below the HBM roofline")

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "scaling.json")
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "bmsparse_tpu_torch.cli.scaling",
             "--synthetic", "band", "--report", path],
            capture_output=True, text=True, timeout=600,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        t_cli = time.perf_counter() - t0
        for line in res.stdout.splitlines():
            print(f"phase6 cli.scaling: {line}")
        check(res.returncode == 0,
              f"cli.scaling: rc {res.returncode}\n{res.stderr[-4000:]}")
        with open(path) as f:
            cli_rep = json.load(f)
    n_cli = cli_rep["matrix"]["shape"][0]
    print(f"phase6 cli.scaling --synthetic band (n {n_cli}): rc 0 in "
          f"{t_cli:.1f} s, report written with "
          f"{len(cli_rep['spmv'])} SpMV and {len(cli_rep['spgemm'])} SpGEMM "
          f"rows [{card}]")
    print(f"phase6 seconds: {time.perf_counter() - t_phase:.1f} [{card}]")
    return launches, errs


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
    launches, runs, main_errs = phase2_main_path(torch)
    print(f"phase2 launches on the SpMV block-tier path: {launches}")
    for k, e in main_errs.items():
        errs[k] = max(errs.get(k, 0.0), e)
    stream_launches, stream_errs, stream_runs, auto_runs = phase2_stream(
        torch, runs)
    print(f"phase2 launches on the SpMV stream-tier path: {stream_launches}")
    launches.update(stream_launches)
    errs.update(stream_errs)
    spgemm_launches, spgemm_runs = phase2_spgemm(torch)
    print(f"phase2 launches on the SpGEMM path: {spgemm_launches}")
    launches.update(spgemm_launches)
    compress_launches, compress_errs, compress_runs = phase2_compress(
        torch, spgemm_runs)
    print(f"phase2 launches on the SpGEMM compress paths: "
          f"{compress_launches}")
    launches.update(compress_launches)
    errs.update(compress_errs)
    check(len(launches) == 9 and all(n > 0 for n in launches.values()),
          f"a kernel of the paths was not launched: {launches}")
    stencil = runs["stencil2M"]
    times = phase3_times(torch, runs, card)
    del runs
    times += phase3_stream_times(torch, stream_runs, auto_runs, card)
    del stream_runs, auto_runs
    times += phase3_spgemm_times(torch, spgemm_runs, card)
    times += phase3_compress_times(torch, compress_runs, spgemm_runs, card)
    band = spgemm_runs["band2M"]
    del compress_runs, spgemm_runs
    torch.cuda.empty_cache()
    for k, e in phase4_surfaces(torch).items():
        errs[k] = max(errs[k], e)
    multi_launches, multi_errs = phase5_multidevice(torch, stencil, band,
                                                    card)
    del stencil, band
    print(f"phase5 launches on the multi-device paths: {multi_launches}")
    for k, n in multi_launches.items():
        launches[k] += n
        errs[k] = max(errs[k], multi_errs[k])
    scaling_launches, scaling_errs = phase6_scaling(torch, card)
    print(f"phase6 launches on the scaling report's measured rows: "
          f"{scaling_launches}")
    for k, n in scaling_launches.items():
        launches[k] += n
        errs[k] = max(errs[k], scaling_errs[k])

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
        "window_product": ("bmsparse_tpu_torch/csrc/window_product.cu",
                           "bmsparse_tpu/ops/pallas/shuffle_kernel.py:188"),
        "rowwise_gather": ("bmsparse_tpu_torch/csrc/rowwise_gather.cu",
                           "bmsparse_tpu/ops/pallas/shuffle_kernel.py:60"),
        "segment_compress_class": (
            "bmsparse_tpu_torch/csrc/segment_compress.cu",
            "bmsparse_tpu/ops/pallas/compress_kernel.py:69"),
        "sell_gather": ("bmsparse_tpu_torch/csrc/sell_gather.cu",
                        "none: the JAX package runs these groups as XLA "
                        "over their slabs (bmsparse_tpu/ops/spmv.py "
                        "sell_apply)"),
        "bitmap_compress": ("bmsparse_tpu_torch/csrc/bitmap_compress.cu",
                            "none: the JAX package's scatter compress is "
                            "XLA (bmsparse_tpu/ops/spgemm.py "
                            "_compress_rows)"),
    }
    out = {"kernels": [
        {"name": t["name"], "route": "cuda",
         "source": replaces[t["name"]][0],
         "replaces": replaces[t["name"]][1],
         "launches": launches[t["name"]],
         "max_abs_err": errs[t["name"]], "ms": t["ms"],
         "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
         "bound_by": t["bound_by"], "library_ms": t["library_ms"]}
        for t in times
    ]}
    check(sorted(k["name"] for k in out["kernels"]) == sorted(replaces),
          "the kernels line must list all nine kernels")
    print(card)
    print(json.dumps(out))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
