"""Mean over the span stretch of iters_U + iters_Y + iters_h + iters_p
from each step's diag (BiCGStab of U, Y and h: the largest lane's; CG of p
summed over the correctors)."""


def read(run):
    if not run.spans or not all(s["iters"] for s in run.spans):
        return None
    return sum(sum(s["iters"].values()) for s in run.spans) / len(run.spans)
