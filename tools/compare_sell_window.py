#!/usr/bin/env python3
"""Time the windowed SELL groups of one checkout of the PyTorch/CUDA port
on the card, at road1M (`roadnet(1_048_576, seed=8)`, built as
chip_smoke.py builds it), and print one JSON line with the card's name and
power limit:

  * `prepare(m, stream="off")` host seconds and the `save_prepared` dump's
    bytes;
  * `sell_window` over the plan's windowed groups (the kernel, then its
    plain twin): L2-cold device ms (CUDA events behind a queued spin, a
    256 MB buffer written before each run: chip_smoke.cold_ms), L2-warm
    event ms (median of 20 single calls, host launch included) and
    L2-warm device busy ms (torch.profiler);
  * the kernel on each group alone, L2-cold, beside the group's pack or
    slab bytes: how its time splits into a part per byte and a part per
    launch;
  * the same function as one `torch.sparse_csr_tensor` matvec over the
    groups' rows (chip_smoke.windowed_csr), L2-cold and L2-warm;
  * the bound: each nonzero's value read once and each output row written
    once at 3,350 GB/s;
  * the bytes the kernel's operands hold (slabs and windows, or packs);
  * road1M's whole `spmv(p, v)`: event ms, device busy ms and idle share.

The checkout may predate the packs (its kernel then reads the slabs):
both kinds are timed through their own `sell_window`. The helpers come
from this file's chip_smoke.py, the package from the checkout. Two
versions compare only on one card, in turns, inside one call:

    python3 tools/compare_sell_window.py PARENT_CHECKOUT parent
    python3 tools/compare_sell_window.py . change
    python3 tools/compare_sell_window.py . change
    python3 tools/compare_sell_window.py PARENT_CHECKOUT parent

Needs a CUDA device; the checkout's kernels are built on first use.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def helpers():
    """This tree's chip_smoke.py as a module of its own name, so that the
    checkout's package is the one it drives."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_helpers", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    repo = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else ".")
    label = sys.argv[2] if len(sys.argv) > 2 else repo
    sys.path.insert(0, repo)
    import torch

    if not torch.cuda.is_available():
        print("compare_sell_window: no CUDA device", file=sys.stderr)
        return 1
    import bmsparse_tpu_torch as bt
    from bmsparse_tpu_torch.io.binary import save_prepared
    from bmsparse_tpu_torch.ops.cuda import build
    from bmsparse_tpu_torch.ops.cuda.sell_kernel import (
        sell_window, sell_window_plain,
    )
    from bmsparse_tpu_torch.utils.testmats import roadnet

    cs = helpers()
    build.load()
    card = cs.card_line()
    r, c, vals, shape = roadnet(1_048_576, seed=8)
    m = bt.coo_to_bmsparse(r, c, vals, shape, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p = bt.prepare(m, stream="off")
    torch.cuda.synchronize()
    t_prep = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(dir=repo, prefix=".compare_") as tmp:
        f = os.path.join(tmp, "road1M.plan")
        save_prepared(f, p)
        dump = os.path.getsize(f)

    v = torch.from_numpy(np.random.default_rng(0).standard_normal(
        m.num_cols).astype(np.float32)).to("cuda")
    n = m.block_cols * 8
    vpad = torch.zeros(n, device="cuda")
    vpad[: v.shape[0]] = v
    packs = getattr(p, "sell_pack", None)
    if packs is not None:
        ops = [(pk,) for pk in packs if pk is not None]
        args = (vpad, n)
        operand_bytes = sum(pk.nbytes() for (pk,) in ops)
    else:
        ops = [(d, rel, ws) for d, rel, ws in
               zip(p.sell_dense, p.sell_rel, p.sell_ws) if rel is not None]
        args = None
        operand_bytes = sum(cs.nbytes(*o) for o in ops)

    def one(fn, o):
        if args is not None:
            return fn(*o, *args)
        d, rel, ws = o
        return fn(d, rel, ws, vpad, d.shape[0], n)

    def groups(fn):
        return [one(fn, o) for o in ops]

    csr, nnz = cs.windowed_csr(torch, p, n)
    torch.testing.assert_close(
        csr @ vpad, torch.cat([o.reshape(-1) for o in groups(sell_window)]),
        **cs.TOL)
    out_rows = sum(d.shape[1] * 8 * 128 for d, rel in
                   zip(p.sell_dense, p.sell_rel) if rel is not None)
    row = {"label": label, "prepare_s": t_prep, "dump_bytes": dump,
           "nnz": nnz, "out_rows": out_rows, "operand_bytes": operand_bytes,
           "bound_ms": cs.bound(nnz * 4 + out_rows * 4, 2 * nnz)[0]}
    for what, fn in (("kernel", lambda: groups(sell_window)),
                     ("plain", lambda: groups(sell_window_plain)),
                     ("csr", lambda: csr @ vpad)):
        prof = cs.device_profile(fn, torch)
        row[what] = {"cold_ms": cs.cold_ms(fn, torch),
                     "warm_event_ms": cs.median_ms(fn, torch),
                     "warm_busy_ms": None if prof is None else prof[0]}
    row["kernel_per_group"] = [
        {"operand_bytes": (o[0].nbytes() if args is not None
                           else cs.nbytes(*o)),
         "cold_ms": cs.cold_ms(lambda o=o: one(sell_window, o), torch)}
        for o in ops]
    prof = cs.device_profile(lambda: bt.spmv(p, v), torch)
    row["spmv"] = {"event_ms": cs.median_ms(lambda: bt.spmv(p, v), torch),
                   "busy_ms": None if prof is None else prof[0],
                   "idle_share": (None if prof is None
                                  else 1 - prof[0] / prof[1])}
    row["card"] = card
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
