"""spmv_roofline: the least time of one SpMV (values, v and u each moved
once at the card's data-sheet bandwidth; portbench/roofline.py) over the
profiler's device busy time of one `spmv` call, calls run back to back in
the traced window "spmv", in %."""


def read(rec):
    w = rec.window("spmv")
    if w is None or not w.busy_s:
        return None
    return 100.0 * w.least_s / (w.busy_s / w.calls)
