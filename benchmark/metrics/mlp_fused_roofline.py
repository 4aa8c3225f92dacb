"""100 x the least time of the mlp_fused calls in the profiled stretch (the
larger of operations over the weights' type's peak and bytes over HBM
bandwidth, from each call's B, widths and S) over the device time of the
kernels whose names hold `mlp_fused`. Nothing when the stretch launched
none, or when the trace lost a record."""
from harness import trace, work

RATE = {2: "bfloat16", 4: "float32", 8: "float64"}


def read(run):
    t = run.trace
    if t is None:
        return None
    calls = [c for c in t.launches if c[0] == "mlp_fused"]
    dev_s, n_ops = trace.kernel_time(t, "mlp_fused")
    if not calls or dev_s <= 0:
        return None
    least = 0.0
    for _, _, wsize, a in calls:
        B, F, K1, H1, H2, H3, S = a[12:19]
        xsize = 4 if wsize == 2 else wsize
        n_bytes, flops = work.mlp_work(B, S, (F, H1, H2, H3, 1), wsize, xsize)
        least += work.least_time(n_bytes, flops, work.PEAK_FLOP_PER_S[RATE[wsize]])[0]
    return 100.0 * least / dev_s
