"""plan_sell_s: host seconds of `prepare`'s phase "plan.sell" in set-up,
the SELL and overflow tiers: the block sort, the K-groups, the window
plans and packs; the program's own clock (portbench/spans.py::kept)."""

from portbench import spans


def read(rec):
    return spans.kept(rec, "plan.sell")
