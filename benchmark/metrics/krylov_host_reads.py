"""Host reads of "any lane active" a step, summed over the Krylov solves
(counter `krylov.host_reads`): the step path's reads from the device."""
from harness import program


def read(run):
    n = program.counter(run, "krylov.host_reads")
    if n is None:
        return None
    return n / len(run.program["steps"])
