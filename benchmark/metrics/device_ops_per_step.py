"""Device operations (kernels, copies, fills) in the profiled stretch per
step: the load the host's dispatch puts on the card."""


def read(run):
    t = run.trace
    if t is None or t.n_ops == 0:
        return None
    return t.n_ops / t.steps
