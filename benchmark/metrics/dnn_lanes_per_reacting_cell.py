"""The lanes that mlp_fused ran on in the profiled stretch (the B of each
launch, from the spy on the program's launch function: one launch a call
of the nets, a call a step) over the cells above the frozen temperature
in the input of the same steps of a segment (the span stretch's
`hot_cells`). 1 where only the reacting cells go to the nets; cells over
reacting cells where every cell does. Nothing without a launch or a
reacting cell."""
from harness import main


def read(run):
    t = run.trace
    if t is None or not run.spans:
        return None
    lanes = sum(a[12] for name, _, _, a in t.launches if name == "mlp_fused")
    steps = range(main.TRACE_FROM_STEP, main.TRACE_FROM_STEP + t.steps)
    hot = sum(run.spans[i]["hot_cells"] for i in steps)
    if not lanes or not hot:
        return None
    return lanes / hot
