"""galerkin_plan_s: host seconds of the program's Galerkin set-up phase
"galerkin.plan" (`prepare_galerkin` of every level: R = P^T, the two
product plans and the value maps), summed over the levels; the program's
own clock (portbench/spans.py::kept)."""

from portbench import spans


def read(rec):
    return spans.kept(rec, "galerkin.plan")
