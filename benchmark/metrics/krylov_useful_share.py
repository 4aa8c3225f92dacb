"""100 x the lanes' summed iterations over trips x lanes, summed over the
program stretch's Krylov solves (counters `krylov.lane_iters` and
`krylov.lane_trips`): the share of lane trips that did work; a batched
solve runs every lane until the last converges, in blocks of CHECK_EVERY
trips."""
from harness import program


def read(run):
    iters = program.counter(run, "krylov.lane_iters")
    trips = program.counter(run, "krylov.lane_trips")
    if iters is None or not trips:
        return None
    return 100.0 * iters / trips
