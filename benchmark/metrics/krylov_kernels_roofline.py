"""100 x the summed least times of the stencil7 and helmholtz7 launches in
the profiled stretch (bytes over HBM bandwidth: each input read once,
the output written once; from each launch's shape) over the summed device
time of those two kernels, the least time scaled to the operations the
trace holds where it lost records. Nothing when the stretch launched
neither, or launched the Helmholtz kernel's padded form (a processor or
per-face BC, not counted here)."""
from harness import trace, work


def read(run):
    t = run.trace
    if t is None:
        return None
    least, launched = 0.0, 0
    for name, form, size, a in t.launches:
        if name == "stencil7_apply":
            n_bytes, flops = work.stencil7_work(*a[9:13], size)
        elif name == "helmholtz7_apply":
            if form != "bc_":      # the padded form: not counted here
                return None
            n_bytes, flops = work.helmholtz_bc_work(tuple(a[6:9]), size)
        else:
            continue
        launched += 1
        least += work.least_time(n_bytes, flops, work.simt_rate(size))[0]
    s1, n1 = trace.kernel_time(t, "stencil7_kernel")
    s2, n2 = trace.kernel_time(t, "helmholtz7_kernel")
    if not launched or s1 + s2 <= 0:
        return None
    # where the trace lost records, the least time of as many launches
    return 100.0 * least * (n1 + n2) / launched / (s1 + s2)
