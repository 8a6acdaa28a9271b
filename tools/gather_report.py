#!/usr/bin/env python3
"""The SELL tier's gathered groups on a benchmark configuration's graph,
on the card: `sell_gather` at the tier's own shape, and the tier choice
of `prepare`.

    python3 tools/gather_report.py [--config FILE] [--scale N] \\
        [--seed N] [--out FILE]

Generates the configuration's matrix (default the PageRank cell's,
portbench/configs/graph500-s20.json; --scale overrides its scale) on the
card and plans it twice, with `prepare`'s default stream="auto" and with
stream="off" (the block tiers alone). For each plan: the plan's host
seconds by phase, its tiers, one `spmv`'s gap to the float64 reference
(the benchmark's `spmv_gap`), its event ms (median of 20), its device
busy ms per call and idle share (torch.profiler, calls back to back),
and the device memory at its peak (plan and SpMV). For the "auto" plan
also sell_gather on the gathered packs against its plain version and
one torch.sparse_csr_tensor matvec over the packs' rows (L2-cold, beside
its bound; chip_smoke.py's gather_times), and the main tier's pack
re-cut at other segment lengths. Prints one JSON line and writes it to FILE.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from portbench import judge  # noqa: E402
from portbench.generators import kronecker  # noqa: E402

SEG_LENS = (256, 512, 1024, 2048, 4096)


def plan_summary(p) -> dict:
    return {
        "ndiags": len(p.dia_offsets), "sell_ks": list(p.sell_ks),
        "windowed_groups": sum(pk is not None for pk in p.sell_pack),
        "ovf_ks": list(p.ovf_ks), "stream": p.stream is not None,
        "packs": {tier: {"nnz": pk.nnz, "segments": pk.seg_off.numel() - 1,
                         "rows": pk.rows.numel(),
                         "bytes": cs.nbytes(*(getattr(pk, f)
                                              for f in pk.TENSORS))}
                  for tier, pk, _ in cs.gathered(p)},
    }


def spmv_readings(bt, p, x, ref) -> dict:
    u = bt.spmv(p, x)
    xd = x.double()
    gap = judge.scaled_gap(u, ref.apply(xd), ref.abs_apply(xd))
    prof = cs.device_profile(lambda: bt.spmv(p, x), torch, iters=20)
    return {"spmv_gap": gap,
            "event_ms": cs.median_ms(lambda: bt.spmv(p, x), torch),
            "busy_ms": None if prof is None else prof[0],
            "idle_share": None if prof is None else 1 - prof[0] / prof[1],
            "top": cs.device_top(lambda: bt.spmv(p, x), torch)}


def seg_sweep(p, vpad) -> dict:
    """The main tier's pack cut at each of SEG_LENS: its segments, the
    host seconds to build it, sell_gather's L2-cold and busy ms."""
    from bmsparse_tpu_torch.ops.cuda import sell_gather_kernel as sgk

    host = p.sell_gpack.to("cpu")
    e = host.nnz
    row = host.entry_rows().numpy()
    out = cs.gather_out(torch, p.sell_rows, vpad.device)
    n = vpad.shape[0]
    res, keep = {}, sgk.SEG_LEN
    try:
        for seg_len in SEG_LENS:
            sgk.SEG_LEN = seg_len
            t0 = time.perf_counter()
            pk = sgk.gather_pack(row, host.cols[:e].numpy(), host.vals[:e],
                                 host.rows.numpy(), host.vals.dtype)
            host_s = time.perf_counter() - t0
            pk = pk.to(vpad.device)
            fn = lambda: sgk.sell_gather(pk, vpad, n, out)  # noqa: E731
            res[seg_len] = {"segments": pk.seg_off.numel() - 1,
                            "pack_host_s": host_s,
                            "cold_ms": cs.cold_ms(fn, torch),
                            "busy_ms": cs.busy_s(fn, torch) * 1e3}
            print(f"seg_len {seg_len}: {res[seg_len]}", flush=True)
    finally:
        sgk.SEG_LEN = keep
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default=os.path.join(
        ROOT, "portbench", "configs", "graph500-s20.json"))
    ap.add_argument("--scale", type=int, default=None)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("gather_report: needs a CUDA device", file=sys.stderr)
        return 1
    import bmsparse_tpu_torch as bt
    from bmsparse_tpu_torch.ops.cuda import build
    from bmsparse_tpu_torch.utils import timing

    build.load()
    card = cs.card_line()
    with open(a.config) as f:
        cfg = json.load(f)
    if a.scale is not None:
        cfg["scale"] = a.scale
    prob = kronecker.generate(cfg, "cuda")
    m = bt.coo_to_bmsparse(*prob.coo(0, 0), prob.shape, backend="device",
                           device="cuda")
    ref = prob.reference(0, 0, torch.float64)
    g = torch.Generator(device="cuda").manual_seed(a.seed)
    x = torch.rand(prob.shape[1], generator=g, device="cuda") * 2 - 1
    res = {"card": card, "config": cfg["name"], "scale": cfg["scale"],
           "n": prob.shape[0], "nnz": prob.nnz, "seed": a.seed}
    for mode in ("auto", "off"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        timing.kept.clear()
        t0 = time.perf_counter()
        p = bt.prepare(m, stream=mode)
        torch.cuda.synchronize()
        r = {"plan_s": time.perf_counter() - t0, "kept": dict(timing.kept)}
        r.update(plan_summary(p))
        r.update(spmv_readings(bt, p, x, ref))
        r["peak_bytes"] = torch.cuda.max_memory_allocated()
        print(f"stream={mode!r}: {r} [{card}]", flush=True)
        if mode == "auto" and p.sell_gpack is not None:
            # rows of tens of thousands of entries: kernel and plain are
            # each held to the float64 sums, not to each other by TOL
            cs.gather_check(torch, p, x, cfg["name"], close=None)
            vpad = torch.zeros(p.block_cols * 8, device="cuda")
            vpad[: x.numel()] = x
            r["sell_gather"] = cs.gather_times(torch, p, vpad, cfg["name"],
                                               card)
            r["seg_sweep"] = seg_sweep(p, vpad)
            del vpad
        res[mode] = r
        del p
    line = json.dumps(res)
    print(line)
    if a.out:
        with open(a.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
