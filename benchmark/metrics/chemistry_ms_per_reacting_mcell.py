"""The benchmark's span around the chemistry model's correct(), synchronised
at both ends, in ms a step over the cells above the frozen temperature in
the step's input, in millions, over the span stretch: the chemistry's cost
a reacting cell. Nothing without a reacting cell."""


def read(run):
    if not run.spans:
        return None
    hot = sum(s["hot_cells"] for s in run.spans)
    if not hot:
        return None
    return 1e3 * sum(s["chem_s"] for s in run.spans) / (1e-6 * hot)
