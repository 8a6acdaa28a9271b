"""Graph500's Kronecker graph (the specification's generator:
initiator A, B, C, D; scale; edge factor), made on the device, in the
undirected form of LDBC Graphalytics' graph500 data sets, as the matrix
P = A D^-1 that PageRank multiplies.

The edge list follows the reference `kronecker_generator.m`: each of
edgefactor * 2^scale edges picks one quadrant per level, then the vertex
labels are permuted at random (the final edge shuffle does not change the
graph and is left out). The graph is then made undirected: both
directions of every edge, self-loops and duplicate edges dropped, and
vertices with no edge removed (labels compacted in order). P[i, j] =
1 / deg(j) for every edge, so P is column-stochastic and no vertex dangles.

The structure comes from the configuration's `structure_seed`, not from
`--seed`: Graphalytics ships one fixed graph, and every run does the same
work.
"""

from __future__ import annotations

import torch

from portbench.reference.coo import Coo
from portbench.seeds import generator


class Problem:
    """The graph's matrix P = A D^-1 in coordinates."""

    def __init__(self, cfg: dict, device):
        self.cfg = cfg
        self.device = torch.device(device)
        scale, ef = int(cfg["scale"]), int(cfg["edgefactor"])
        a, b, c, _ = (float(x) for x in cfg["initiator"])
        nv, m = 1 << scale, ef << scale
        g = generator(int(cfg["structure_seed"]), "kronecker", self.device)
        ab, c_norm, a_norm = a + b, c / (1.0 - (a + b)), a / (a + b)
        ii = torch.zeros(m, dtype=torch.int64, device=self.device)
        jj = torch.zeros_like(ii)
        for ib in range(scale):
            ii_bit = torch.rand(m, generator=g, device=self.device) > ab
            thresh = torch.where(ii_bit, c_norm, a_norm)
            jj_bit = torch.rand(m, generator=g, device=self.device) > thresh
            ii += ii_bit.long() << ib
            jj += jj_bit.long() << ib
        perm = torch.randperm(nv, generator=g, device=self.device)
        ii, jj = perm[ii], perm[jj]
        src, dst = torch.cat([ii, jj]), torch.cat([jj, ii])
        del ii, jj, perm
        keep = src != dst
        key = torch.unique(src[keep] * nv + dst[keep])      # sorted
        del src, dst, keep
        rows, cols = key // nv, key % nv
        del key
        deg = torch.bincount(rows, minlength=nv)
        alive = deg > 0
        new_id = torch.cumsum(alive.long(), 0) - 1
        self.rows, self.cols = new_id[rows], new_id[cols]
        self.deg = deg[alive]
        n = int(self.deg.numel())
        self.shape = (n, n)
        self.nnz = int(self.rows.numel())
        self.vals = (1.0 / self.deg.double())[self.cols].float()

    def coo(self, value_set: int, seed: int):
        """rows, cols (int64, sorted by row then column) and float32
        values of P, on the device."""
        return self.rows, self.cols, self.vals

    def reference(self, value_set: int, seed: int, dtype) -> Coo:
        """The plain reference of P, computing in `dtype`, from the same
        float32 values the program gets."""
        return Coo(self.rows, self.cols, self.vals.to(dtype), self.shape)


def generate(cfg: dict, device) -> Problem:
    return Problem(cfg, device)
