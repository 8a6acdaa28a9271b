"""idle_share.<kind> (idle_share.solve, idle_share.product): 1 - device
busy time over the traced window's length, over whole requests (each ends
in a synchronize), in %. One reader serves every kind, since the window
is the cell's own requests; the kind names the end-to-end metric it
moves."""


def read(rec):
    w = rec.window("requests")
    if w is None or not w.wall_s:
        return None
    return 100.0 * (1.0 - w.busy_s / w.wall_s)
