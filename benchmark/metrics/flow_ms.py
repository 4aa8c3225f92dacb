"""Mean ms a step of the span stretch's step wall time less its chemistry
span: the flow solve (transport, Sigma, the Krylov solves, pressure)."""


def read(run):
    if not run.spans:
        return None
    return 1e3 * sum(s["step_s"] - s["chem_s"] for s in run.spans) / len(run.spans)
