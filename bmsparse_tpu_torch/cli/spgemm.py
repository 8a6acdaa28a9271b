"""SpGEMM command line — counterpart of ``bmsparse_tpu/cli/spgemm.py``: the
reference benchmark binary (`bmsparse_spgemm_float folder A_name B_name
[segmented] [tc_version] [verbose]`, ref main:
src/bmSparse_SPGEMM.cu:1226-1288) with the same positional surface and
output lines.

  * loads A untransposed and B transposed (ref :1261-1262); inputs cast to
    --dtype (default bfloat16, the counterpart of the reference's half),
    output C is float32 (ref OUTPUT_TYPE, :51);
  * one warm-up product, then one timed product;
  * prints parse time, execution time, C block count and C nnz in the
    reference's format (ref :1282-1285), and with --check the mean
    relative error against scipy as "Final:";
  * `segmented` and `tc_version` are accepted for compatibility; the
    numeric variant is chosen with --impl.

Usage:
  python -m bmsparse_tpu_torch.cli.spgemm data/real A_matrix B_matrix
      [segmented] [tc_version] [verbose] [--check] [--device {cuda,cpu}]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

# --check fails above this mean relative error (bf16 inputs, float32 C)
CHECK_BOUND = 1e-2


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="bmsparse-spgemm-torch", description=__doc__.splitlines()[0]
    )
    p.add_argument("folder", help="directory containing the .mtx files")
    p.add_argument("a_name", help="A matrix name (without .mtx)")
    p.add_argument("b_name", help="B matrix name (without .mtx)")
    p.add_argument("segmented", nargs="?", type=int, default=0,
                   help="compat flag (reference sort mode; ignored)")
    p.add_argument("tc_version", nargs="?", type=int, default=5,
                   help="compat flag (reference kernel variant; ignored)")
    p.add_argument("verbose", nargs="?", type=int, default=0,
                   help="1 = per-phase timings (reference VERBOSE)")
    p.add_argument("--impl", default=None,
                   choices=["auto", "cuda", "plain", "xla"],
                   help="numeric implementation (default: the config's); "
                        "'xla' is the chunked numeric, plain torch")
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32", "float64"],
                   help="input value dtype (the reference uses half)")
    p.add_argument("--check", action="store_true",
                   help="verify against the scipy oracle (compare())")
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

    from .. import mmread_bmsparse, set_config
    from ..ops.spgemm import spgemm
    from ..utils.timing import sync

    if args.verbose:
        set_config(verbose=True)
    dtype = getattr(torch, args.dtype)
    a_path = os.path.join(args.folder, args.a_name)
    b_path = os.path.join(args.folder, args.b_name)

    t0 = time.perf_counter()
    a = mmread_bmsparse(a_path, dtype=dtype, device=args.device)
    b = mmread_bmsparse(b_path, dtype=dtype, transposed=True,
                        device=args.device)
    print(f"Parsing data: {(time.perf_counter() - t0) * 1e6:.0f}")

    # warm-up: the first call builds the kernels (the reference warms the
    # CUDA context with cudaFree(0), ref :1233)
    sync(spgemm(a, b, impl=args.impl, verbose=False))
    t0 = time.perf_counter()
    c = sync(spgemm(a, b, impl=args.impl, verbose=bool(args.verbose)))
    print(f"bmSparse execution: {(time.perf_counter() - t0) * 1e6:.0f}")
    print(f"C blocks: {int(c.nb)}")
    print(f"C nnz: {c.nnz}")

    if args.check:
        from ..oracle.scipy_oracle import oracle_spgemm

        # compare() prints "Final: <mean rel err>" (reference semantics)
        err = c.compare(oracle_spgemm(a, b), verbose=True)
        return 0 if err < CHECK_BOUND else 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
