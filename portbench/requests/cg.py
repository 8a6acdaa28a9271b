"""Request kind `cg`: one fixed-iteration CG solve of A x = b_r through the
program's `examples/cg.py::cg` on the plan of A, ended by a synchronize.

The right-hand sides are b_r = A x*_r for `right_hand_sides` vectors x*_r
drawn from the seed, uniform in [0, 2] (HPCG uses x* = 1), made in
float64 by the reference and handed to both sides in float32; request i
solves b_(i mod R). Compared: x, and the norm of the recurrence's
residual after every step relative to |b|, against the reference's CG in
float64 from the same b.
"""

from __future__ import annotations

import torch

from portbench import judge
from portbench.reference import solvers
from portbench.requests._solve import SolveDriver
from portbench.seeds import generator


class Driver(SolveDriver):
    def set_seed(self, seed: int) -> None:
        super().set_seed(seed)
        r = int(self.traffic["right_hand_sides"])
        n = self.problem.shape[0]
        g = generator(seed, "cg.xstar", self.run.device)
        xs = torch.rand((r, n), generator=g, device=self.run.device) * 2
        ref = self.problem.reference(0, seed, torch.float64)
        self.b = torch.stack([ref.apply(x.double()) for x in xs]).float()
        self._ref = {}

    def request(self, i: int):
        from bmsparse_tpu_torch.examples.cg import cg

        x, hist = cg(self.p, self.b[i % len(self.b)], self.iters)
        self.run.sync()
        return x, hist

    def control(self, i: int):
        """The reference in bfloat16 in the program's place."""
        ref = self.problem.reference(0, self.seed, torch.bfloat16)
        return solvers.cg(ref.apply, self.b[i % len(self.b)].bfloat16(),
                          self.iters)

    def judge(self, held: list) -> dict:
        ref = self.problem.reference(0, self.seed, torch.float64)
        x_gap = res_gap = 0.0
        for i, (x, hist) in held:
            r = i % len(self.b)
            if r not in self._ref:
                self._ref[r] = solvers.cg(ref.apply, self.b[r].double(),
                                          self.iters)
            x_ref, h_ref = self._ref[r]
            x_gap = max(x_gap, judge.relative_gap(x, x_ref))
            res_gap = max(res_gap, judge.relative_gap(
                hist.double().sqrt(), h_ref.sqrt(), self.b[r].norm()))
        return {"x_gap": x_gap, "res_gap": res_gap}
