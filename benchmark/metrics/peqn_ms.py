"""Mean device ms a step of the program's `lowmach.pEqn` span: the
pressure correctors, their CG solves and the flux and velocity updates."""
from harness import program


def read(run):
    return program.span_ms(run, ("lowmach.pEqn",))
