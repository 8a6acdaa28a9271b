"""product_roofline: the least time of one product (A, B read and C
written once at the data-sheet bandwidth, or its FLOPs at the float32
peak, whichever is longer; portbench/roofline.py) over the profiler's
device busy time per product in the traced window of whole requests, in
%."""


def read(rec):
    w = rec.window("requests")
    if w is None or not w.busy_s:
        return None
    return 100.0 * w.least_s / (w.busy_s / w.calls)
