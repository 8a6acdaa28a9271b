"""What the solve kinds (cg, pagerank) share: the matrix converted and
planned by the program, the SpMV probes of a traced run, and the check of
one SpMV of the timed plan against the reference."""

from __future__ import annotations

import time

import torch

from portbench import judge, roofline
from portbench.seeds import generator

# spmv calls timed one by one for spmv_dispatch_us, and run back to back
# in the traced window that spmv_roofline reads
DISPATCH_CALLS = 240
DEVICE_CALLS = 20


class SolveDriver:
    """A solver's requests on `problem`'s value set 0, planned by the
    program's `prepare` with its defaults."""

    def __init__(self, problem, traffic: dict, run):
        import bmsparse_tpu_torch as bt

        self.bt, self.problem, self.traffic, self.run = bt, problem, traffic, run
        self.iters = int(traffic["iterations"])
        self.work = problem.nnz * self.iters * 1e-9   # Gnnz multiplied
        rows, cols, vals = problem.coo(0, 0)
        with run.span("convert"):
            m = bt.coo_to_bmsparse(rows, cols, vals, problem.shape,
                                   backend="device", device=run.device)
        del rows, cols, vals
        with run.span("plan"):
            self.p = bt.prepare(m)
        self.seed = None

    def set_seed(self, seed: int) -> None:
        """Draw the seed's request inputs and the checked SpMV's vector."""
        self.seed = seed
        n = self.problem.shape[1]
        g = generator(seed, "spmv.check", self.run.device)
        self.v = torch.rand(n, generator=g, device=self.run.device) * 2 - 1

    # -- the checked SpMV of the timed plan -------------------------------
    def check_output(self):
        return self.bt.spmv(self.p, self.v)

    def control_check_output(self):
        return self.problem.reference(0, self.seed, torch.bfloat16).apply(
            self.v)

    def judge_check(self, u) -> dict:
        ref = self.problem.reference(0, self.seed, torch.float64)
        v = self.v.double()
        return {"spmv_gap": judge.scaled_gap(u, ref.apply(v),
                                             ref.abs_apply(v))}

    # -- traced runs --------------------------------------------------------
    def least_spmv_s(self) -> float:
        n_rows, n_cols = self.problem.shape
        b = roofline.spmv_least_bytes(self.problem.nnz, n_rows, n_cols)
        return roofline.least_seconds(b, 0, self.run.card)[0]

    def least_request_s(self) -> float:
        """A solve's least time: its SpMVs' (the vector updates left
        out)."""
        return self.iters * self.least_spmv_s()

    def probes(self, run) -> None:
        """spmv_dispatch: host seconds from each call of spmv to its
        return, each after a synchronize; the window "spmv": calls back to
        back under the profiler."""
        spmv, p, v = self.bt.spmv, self.p, self.v
        times = []
        for _ in range(DISPATCH_CALLS):
            run.sync()
            t0 = time.perf_counter()
            spmv(p, v)
            times.append(time.perf_counter() - t0)
        run.spans["spmv_dispatch"] = times

        def calls():
            for _ in range(DEVICE_CALLS):
                spmv(p, v)

        run.capture("spmv", calls, DEVICE_CALLS, self.least_spmv_s)

    def free(self) -> None:
        self.p = None

