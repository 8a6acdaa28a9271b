"""plan_dia_s: host seconds of `prepare`'s phase "plan.dia" in set-up,
tier 1: the choice of diagonals and their strips; the program's own
clock (portbench/spans.py::kept)."""

from portbench import spans


def read(rec):
    return spans.kept(rec, "plan.dia")
