"""Mean ms a step of the benchmark's span around the chemistry model's
correct() (DNNChemistry: DF-ODENet's rates), synchronised at both ends,
over the span stretch."""


def read(run):
    if not run.spans:
        return None
    return 1e3 * sum(s["chem_s"] for s in run.spans) / len(run.spans)
