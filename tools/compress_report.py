#!/usr/bin/env python3
"""The SpGEMM's default compress at the benchmark's shapes, on the card:
the cached product of hpcg-104.a2 and both products of level 0 of
hpcg-sa-amg.galerkin (each cell's inputs and plans as the benchmark
builds them, portbench harness; value set 0, which no seed changes). For
each product, from the dense C tiles its products make (level 0's second
product from the first one's output, as a call runs them):

  * bitmap_compress (csrc/bitmap_compress.cu): event ms L2-cold (from
    chip_smoke.cold_ms) and warm (median of 20), device ms per call
    (torch.profiler, 10 calls back to back);
  * its plain version (the one PyTorch path that computes the same
    array), event and device ms;
  * the bound: bytes at 3,350 GB/s, counting the 32-byte sectors of the
    tiles that hold a set address (`bound_ms`) and, as a second reading,
    every live row whole (`bound_rows_ms`), each with 24 bytes of words
    and offset per row and the values written;
  * whether the kernel equals its plain version bit for bit.

    python3 tools/compress_report.py [--out FILE]

Prints one JSON line and writes it to FILE. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from portbench import harness  # noqa: E402


def measure(c_rows, p) -> dict:
    from bmsparse_tpu_torch.ops.cuda.bitmap_compress_kernel import (
        bitmap_compress, bitmap_compress_plain,
    )

    hi, lo, off = p.sig_st
    args = (c_rows, hi, lo, off, p.nnz_pad, p.num_c_nnz)
    want = bitmap_compress_plain(*args)
    got = bitmap_compress(*args)
    torch.cuda.synchronize()
    equal = bool(torch.equal(got, want))
    del got, want
    fns = {"kernel": lambda: bitmap_compress(*args),
           "plain": lambda: bitmap_compress_plain(*args)}
    live = int(((hi | lo) != 0).sum())
    meta = hi.shape[0] * 24 + p.nnz_pad * 4
    bound_ms = cs.compress_bound(hi, lo, p.nnz_pad)[0]
    out = {"rows": hi.shape[0], "live_rows": live, "nnz_c": p.num_c_nnz,
           "nnz_pad": p.nnz_pad, "equal_to_plain": equal,
           "bound_ms": bound_ms,
           "bound_rows_ms": (live * 256 + meta) / cs.PEAK_BYTES_PER_S * 1e3,
           "kernel_cold_ms": cs.cold_ms(fns["kernel"], torch)}
    for name, fn in fns.items():
        out[f"{name}_ms"] = cs.median_ms(fn, torch)
        prof = cs.device_profile(fn, torch)
        out[f"{name}_device_ms"] = None if prof is None else prof[0]
        torch.cuda.empty_cache()
    return out


def a2() -> dict:
    _, cfg, traffic, _ = harness.load_cell(
        "hpcg-104.a2", harness.CHECKOUT / "BENCHMARK.json", {})
    run = harness.Run("cuda", torch.cuda.get_device_name(0))
    drv = harness.build(cfg, traffic, run)
    p = drv.pp.plan
    c_rows = cs.scatter_inputs(drv.pp)[0]
    res = {"product": measure(c_rows, p)}
    drv.free()
    return res


def galerkin_level0() -> dict:
    from bmsparse_tpu_torch.format.layout import tiles_from_values
    from bmsparse_tpu_torch.ops import spgemm as sg

    _, cfg, traffic, _ = harness.load_cell(
        "hpcg-sa-amg.galerkin", harness.CHECKOUT / "BENCHMARK.json", {})
    run = harness.Run("cuda", torch.cuda.get_device_name(0))
    drv = harness.build(cfg, traffic, run)
    gal = drv.gals[0]
    p1, p2 = gal.ap.plan, gal.rap.plan
    a_flat = gal._tiles_a(drv.a0[0])
    c1 = sg._numeric_products(a_flat, p1.b_flat, p1.launches, p1.rows, True)
    res = {"a_p": measure(c1, p1)}
    ap_values = sg._numeric_from_plan(p1, True, a_flat, p1.b_flat)
    b_flat = tiles_from_values(ap_values, gal._ap_slots, p2.b_flat.shape[0])
    c2 = sg._numeric_products(p2.a_flat, b_flat, p2.launches, p2.rows, True)
    res["r_ap"] = measure(c2, p2)
    return res


def main(argv) -> int:
    ap = argparse.ArgumentParser(prog="compress_report",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compress_report: needs a CUDA device", file=sys.stderr)
        return 2
    from bmsparse_tpu_torch.ops.cuda import build

    t0 = time.perf_counter()
    build.load()
    line = {"card": cs.card_line(), "torch": torch.__version__,
            "hpcg-104.a2": a2()}
    gc.collect()
    torch.cuda.empty_cache()
    line["hpcg-sa-amg.galerkin.level0"] = galerkin_level0()
    line["seconds"] = time.perf_counter() - t0
    text = json.dumps(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
