#!/usr/bin/env python3
"""Time the cached SpGEMM products of one checkout of the PyTorch/CUDA port
on the card: one `pp()` of `prepare_product(A, B)` for A*A at
blockdense64k, band2M and fem1M, built as that checkout's chip_smoke.py
builds them. Prints one JSON line per matrix: the event time (median of
20 single calls), the device busy time and idle share (torch.profiler),
and the device time by operation, with the card's name and power limit.

Two versions compare only on one card, in turns, inside one call:

    python3 tools/compare_products.py PARENT_CHECKOUT parent
    python3 tools/compare_products.py . change
    python3 tools/compare_products.py . change
    python3 tools/compare_products.py PARENT_CHECKOUT parent

Needs a CUDA device; the checkout's kernels are built on first use.
"""

from __future__ import annotations

import json
import os
import sys


def main() -> int:
    repo = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else ".")
    label = sys.argv[2] if len(sys.argv) > 2 else repo
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
        pp = bt.prepare_product(a, b)
        ms = cs.median_ms(pp, torch)
        prof = cs.device_profile(pp, torch)
        print(json.dumps({
            "label": label, "matrix": name, "pp_ms": ms,
            "device_busy_ms": None if prof is None else prof[0],
            "idle_share": None if prof is None else 1 - prof[0] / prof[1],
            "by_op": cs.device_top(pp, torch, top=40), "card": card}),
            flush=True)
        del a, b, pp
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
