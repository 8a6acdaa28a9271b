"""Sharded tiered execution plans — the multi-device fast path of SpMV;
counterpart of ``bmsparse_tpu/parallel/plan.py``.

The single-device plan (ops/plan.py) makes static per-matrix choices:
which diagonals, which SELL K-groups. `prepare_sharded` unifies them
across shards — the union of DIA offsets (by shard vote) and of SELL
K-groups, each padded to the largest chunk count any shard needs — and
stacks the per-shard DIA strips and row maps on a leading shard axis.
Shards that lack a diagonal carry a zero strip; groups a shard does not
fill carry padding chunks (rows without entries). The JAX package needs
one program for every shard; the port keeps the unified statics all the
same, so that the stacked arrays equal JAX's. Each shard's SELL tier is
its own GatherPack (ops/cuda/sell_gather_kernel.py), since the shards'
entry counts differ; forced layouts have no windowed group.

Coordinates: rows are shard-local (shard s owns global block rows
[s*bpr, (s+1)*bpr)); columns stay global, and the DIA offsets are global
diagonals read at the shard's column shift (ops/spmv.py::dia_apply).
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import BLOCK_HEIGHT, BLOCK_WIDTH, round_up
from ..ops.plan import MAX_DIAGS, _choose_diagonals, prepare
from .partition import ShardedBmSparse


@dataclasses.dataclass(frozen=True)
class ShardedPrepared:
    """Stacked per-shard tiered plans with unified static structure."""

    sm: ShardedBmSparse
    # DIA tier: (D, nd, r_loc, 128); offsets are global diagonals
    dia: torch.Tensor | None = None
    dia_offsets: tuple = ()
    # SELL tier: group g has sell_chunks[g] chunks of depth sell_ks[g] on
    # every shard; sell_gpack[s] holds shard s's nonzeros
    sell_ks: tuple = ()
    sell_chunks: tuple = ()
    sell_gpack: tuple = ()
    out_gather: torch.Tensor | None = None   # (D, nbr_loc) int32
    sell_rows: int = 0
    # Halo feasibility from the exact column dependencies: (halo_left,
    # halo_right) scalar columns, multiples of 128, covering every shard's
    # window into its neighbours' slices of v; None where some shard
    # needs more than one neighbour's slice (or a tall layout): the
    # all-gather path.
    halo: tuple | None = None

    def __getattr__(self, name):
        return getattr(object.__getattribute__(self, "sm"), name)


def prepare_sharded(sm: ShardedBmSparse) -> ShardedPrepared:
    """Per-shard plans with a unified static layout, stacked (host numpy
    planning; the plan lands on sm's device)."""
    d = sm.num_shards
    bpr = sm.rows_per_shard
    if (bpr * BLOCK_HEIGHT) % 128:
        raise ValueError(
            "rows_per_shard*8 must be a multiple of 128 for the sharded "
            f"plan (partition() aligns this with align=16; got bpr={bpr})")
    host = sm.to("cpu")
    # local shard matrices: rows localized, columns global
    locals_ = []
    for s in range(d):
        lm = host.shard_local(s)
        locals_.append(dataclasses.replace(
            lm, brow=lm.brow - s * bpr, num_rows=bpr * BLOCK_HEIGHT))

    # pass 1: union of per-shard diagonal choices (global offsets), capped
    # at MAX_DIAGS by shard vote (offsets dropped here fall back to those
    # shards' SELL tier)
    votes: dict = {}
    for s, lm in enumerate(locals_):
        rows, cols, _ = lm.generate_coo(order="any")
        offs = _choose_diagonals(rows, cols, lm.num_rows, lm.num_cols,
                                 col_shift=s * bpr * BLOCK_HEIGHT)
        for o in offs:
            votes[int(o)] = votes.get(int(o), 0) + 1
    keep = sorted(votes, key=lambda o: -votes[o])[:MAX_DIAGS]
    forced_dia = tuple(sorted(keep))

    def plan(s, lm, groups):
        return prepare(lm, force_layout=(forced_dia, groups),
                       col_shift=s * bpr * BLOCK_HEIGHT, sell_unit=8,
                       device="cpu")

    # pass 2: per-shard plans with the forced diagonals give each K
    # group's chunk count; pass 3 rebuilds them with the global grouping
    group_need: dict = {}
    for s, lm in enumerate(locals_):
        p = plan(s, lm, None)
        counts_by_k: dict = {}
        for kg, ch in zip(p.sell_ks, p.sell_chunks):
            counts_by_k[kg] = counts_by_k.get(kg, 0) + ch
        for k, c in counts_by_k.items():
            group_need[k] = max(group_need.get(k, 0), c)
    forced_groups = tuple(
        (k, group_need[k]) for k in sorted(group_need, reverse=True))
    plans = [plan(s, lm, forced_groups) for s, lm in enumerate(locals_)]
    # forced layouts gather every group
    assert not any(pk is not None for p in plans for pk in p.sell_pack)

    dev = sm.device

    def stack(get):
        return torch.stack([get(p) for p in plans]).to(dev)

    dia = stack(lambda p: p.dia) if forced_dia else None
    out_gather = (stack(lambda p: p.out_gather) if forced_groups
                  else torch.zeros((d, bpr), dtype=torch.int32, device=dev))
    return ShardedPrepared(
        sm=sm, dia=dia, dia_offsets=forced_dia,
        sell_ks=tuple(k for k, _ in forced_groups),
        sell_chunks=tuple(c for _, c in forced_groups),
        sell_gpack=tuple(p.sell_gpack.to(dev) for p in plans)
        if forced_groups else (),
        out_gather=out_gather,
        sell_rows=plans[0].sell_rows if plans else 0,
        halo=_halo(sm, locals_, forced_dia))


def _halo(sm: ShardedBmSparse, locals_, forced_dia: tuple):
    """The exact per-shard column windows: (halo_left, halo_right) when
    every shard reads at most its two neighbours' slices of v, else
    None."""
    d = sm.num_shards
    chunk = round_up(round_up(sm.num_cols, BLOCK_WIDTH), 128 * d) // d
    npad_loc = sm.rows_per_shard * BLOCK_HEIGHT
    if npad_loc < chunk:    # tall layouts: the shards' windows drift apart
        return None
    h_l = h_r = 0
    for s, lm in enumerate(locals_):
        own_lo, own_hi = s * chunk, (s + 1) * chunk
        lo, hi = own_lo, own_hi
        valid = ((lm.bmp_hi | lm.bmp_lo) != 0).numpy()
        if valid.any():
            bc = lm.bcol.numpy()[valid]
            lo = min(lo, int(bc.min()) * BLOCK_WIDTH)
            hi = max(hi, (int(bc.max()) + 1) * BLOCK_WIDTH)
        if forced_dia:
            base = s * npad_loc
            lo = min(lo, base + min(forced_dia))
            hi = max(hi, base + npad_loc + max(forced_dia))
        h_l = max(h_l, own_lo - lo)
        h_r = max(h_r, hi - own_hi)
        if own_lo - lo > chunk or hi - own_hi > chunk:
            return None     # needs more than one neighbour's slice
    halo = (round_up(h_l, 128), round_up(h_r, 128))
    return None if halo[0] > chunk or halo[1] > chunk else halo
