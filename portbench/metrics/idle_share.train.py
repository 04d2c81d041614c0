"""idle_share.train: the share (%) of the traced window in which no
operation ran on the card (1 - busy_s / window_s).  Moves the cell's own
end-to-end metric."""


def read(run):
    p = run.profile
    if p is None or p.busy_s <= 0 or p.window_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)
