"""plan_coo_s: host seconds of `prepare`'s phase "plan.coo" in set-up,
the matrix's coordinates on the host (BmSparse.generate_coo and the
casts); the program's own clock (portbench/spans.py::kept)."""

from portbench import spans


def read(rec):
    return spans.kept(rec, "plan.coo")
