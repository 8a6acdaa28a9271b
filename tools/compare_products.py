#!/usr/bin/env python3
"""Time the SpGEMM products of one checkout of the PyTorch/CUDA port on the
card, for A*A at blockdense64k, band2M and fem1M, built as that checkout's
chip_smoke.py builds them. Prints one JSON line per matrix with the card's
name and power limit:

  * by default, the cached product: one `pp()` of `prepare_product(A, B)`,
    its event time (median of 20 single calls), device busy time and idle
    share (torch.profiler), and device time by operation;
  * with --oneshot, the one-shot `spgemm(A, B)`: its event time (median of
    20 single calls) and the median over 5 `spgemm(verbose=True)` calls of
    each phase (host µs, each phase ending with a CUDA sync; T_3 is the
    device plan, task list included).

Two versions compare only on one card, in turns, inside one call:

    python3 tools/compare_products.py PARENT_CHECKOUT parent [--oneshot]
    python3 tools/compare_products.py . change [--oneshot]
    python3 tools/compare_products.py . change [--oneshot]
    python3 tools/compare_products.py PARENT_CHECKOUT parent [--oneshot]

Needs a CUDA device; the checkout's kernels are built on first use.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import statistics
import sys

PHASE_RUNS = 5


def oneshot_phases(spgemm, a, b) -> dict:
    """Median host µs of each phase spgemm(verbose=True) reports."""
    runs = []
    for _ in range(PHASE_RUNS):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            spgemm(a, b, verbose=True)
        runs.append({k: float(v) for k, v in re.findall(
            r"^(T_\w+): (\d+)$", out.getvalue(), re.MULTILINE)})
    return {k: statistics.median(r[k] for r in runs) for k in runs[0]}


def main() -> int:
    args = [x for x in sys.argv[1:] if x != "--oneshot"]
    oneshot = len(args) < len(sys.argv) - 1
    repo = os.path.abspath(args[0] if args else ".")
    label = args[1] if len(args) > 1 else repo
    sys.path.insert(0, repo)
    import torch

    if not torch.cuda.is_available():
        print("compare_products: no CUDA device", file=sys.stderr)
        return 1
    import bmsparse_tpu_torch as bt
    import chip_smoke as cs

    card = cs.card_line()
    for name, load in cs.spgemm_matrices():
        if name == "Ragusa16":
            continue
        a, b = load()
        if oneshot:
            row = {"spgemm_ms": cs.median_ms(lambda: bt.spgemm(a, b), torch),
                   "phases_us": oneshot_phases(bt.spgemm, a, b)}
        else:
            pp = bt.prepare_product(a, b)
            prof = cs.device_profile(pp, torch)
            row = {"pp_ms": cs.median_ms(pp, torch),
                   "device_busy_ms": None if prof is None else prof[0],
                   "idle_share": (None if prof is None
                                  else 1 - prof[0] / prof[1]),
                   "by_op": cs.device_top(pp, torch, top=40)}
            del pp
        print(json.dumps({"label": label, "matrix": name, **row,
                          "card": card}), flush=True)
        del a, b
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
