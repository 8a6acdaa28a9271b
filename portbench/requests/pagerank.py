"""Request kind `pagerank`: one PageRank solve of `iterations` steps
x <- damping * spmv(P, x) + (1 - damping) / n on the program's plan of P
(LDBC Graphalytics' PageRank), ended by a synchronize.

The start vectors are `start_vectors` random positive vectors drawn from
the seed, uniform in [0.5, 1.5] and scaled to sum 1; request i starts from
x0_(i mod R). Compared: the rank vector, entry by entry, against the
reference's power iteration in float64 from the same x0.
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
        r = int(self.traffic["start_vectors"])
        n = self.problem.shape[0]
        g = generator(seed, "pagerank.x0", self.run.device)
        x0 = torch.rand((r, n), generator=g, device=self.run.device) + 0.5
        self.x0 = x0 / x0.sum(dim=1, keepdim=True)
        self.damping = float(self.traffic["damping"])
        self.teleport = (1.0 - self.damping) / n
        self._ref = {}

    def request(self, i: int):
        spmv, p = self.bt.spmv, self.p
        x = self.x0[i % len(self.x0)]
        for _ in range(self.iters):
            x = spmv(p, x).mul_(self.damping).add_(self.teleport)
        self.run.sync()
        return x

    def control(self, i: int):
        """The reference in bfloat16 in the program's place."""
        ref = self.problem.reference(0, self.seed, torch.bfloat16)
        return solvers.pagerank(ref.apply,
                                self.x0[i % len(self.x0)].bfloat16(),
                                self.iters, self.damping)

    def judge(self, held: list) -> dict:
        ref = self.problem.reference(0, self.seed, torch.float64)
        gap = 0.0
        for i, x in held:
            r = i % len(self.x0)
            if r not in self._ref:
                self._ref[r] = solvers.pagerank(
                    ref.apply, self.x0[r].double(), self.iters, self.damping)
            gap = max(gap, judge.entrywise_gap(x, self._ref[r]))
        return {"rank_gap": gap}
