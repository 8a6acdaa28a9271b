"""SpMV command line — counterpart of ``bmsparse_tpu/cli/spmv.py``: the
reference benchmark binary (`bmsparse_spmv_float folder A_name [batched]`,
ref main: src/bmSparse_SPMV.cu:232-312) with the same positional surface
and output lines.

  * v is all ones (ref :279-281);
  * prints parse, plan and execution times (ref :262-306);
  * `batched` is accepted for compatibility (the reference's
    spmv_kernel_new variant); the tiered plan supersedes it.

Usage:
  python -m bmsparse_tpu_torch.cli.spmv data/real A_matrix [1] [--check]
      [--device {cuda,cpu}]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="bmsparse-spmv-torch", description=__doc__.splitlines()[0]
    )
    p.add_argument("folder", help="directory containing the .mtx file")
    p.add_argument("a_name", help="A matrix name (without .mtx)")
    p.add_argument("batched", nargs="?", type=int, default=0,
                   help="compat flag (reference kernel variant)")
    p.add_argument("--impl", default=None, choices=["auto", "cuda", "plain"],
                   help="kernel implementation (default: the config's)")
    p.add_argument("--dtype", default="float32",
                   choices=["bfloat16", "float32", "float64"],
                   help="value dtype (the reference SpMV binary uses float)")
    p.add_argument("--iters", type=int, default=10,
                   help="timed repetitions (median reported)")
    p.add_argument("--check", action="store_true",
                   help="verify against the scipy oracle")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="device to run on (default cuda)")
    return p


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        parser.error("--device cuda: no CUDA device is available "
                     "(use --device cpu)")

    from .. import mmread_bmsparse
    from ..ops.plan import prepare
    from ..ops.spmv import spmv
    from ..utils.timing import time_op

    dtype = getattr(torch, args.dtype)
    a_path = os.path.join(args.folder, args.a_name)

    t0 = time.perf_counter()
    a = mmread_bmsparse(a_path, dtype=dtype, device=args.device)
    print(f"Parsing data: {(time.perf_counter() - t0) * 1e6:.0f}")

    t0 = time.perf_counter()
    p = prepare(a, device=args.device)
    print(f"Execution plan: {(time.perf_counter() - t0) * 1e6:.0f}")

    v = torch.ones(a.num_cols, dtype=dtype, device=args.device)
    t_med, u = time_op(lambda: spmv(p, v, impl=args.impl),
                       iters=max(args.iters, 1), device=args.device)
    print(f"bmSparse SpMV execution: {t_med * 1e6:.0f}")

    if args.check:
        ref = np.asarray(a.to_scipy() @ np.ones(a.num_cols))
        got = u.cpu().to(torch.float64).numpy()
        err = float(np.max(np.abs(got - ref))
                    / max(np.max(np.abs(ref)), 1e-30))
        print(f"Final: {err}")
        return 0 if err < 1e-2 else 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
