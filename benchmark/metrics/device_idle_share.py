"""100 x (1 - busy / window) of the profiled stretch: the union of the
device operations' intervals in the device-only trace against the host
clock's length of the same stretch (synchronised at both ends)."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0 or t.n_ops == 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
