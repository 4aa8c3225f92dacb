"""Device idle ms a step in the gaps whose innermost open program span on
the host was a Krylov solve (`krylov.cg`, `krylov.bicgstab`): the device
waiting for the solver loops' launches and host reads. The median over
the steps of the device-only profiled segment of `harness/program.idle`:
a stall of the host in one step moves it little."""
import statistics

from harness import program


def read(run):
    p = getattr(run, "program_idle", None)
    if not p:
        return None
    return 1e3 * statistics.median(program.krylov_idle_s(p["idle_by_span"]))
