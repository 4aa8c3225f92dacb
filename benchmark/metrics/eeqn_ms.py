"""Mean device ms a step of the program's `lowmach.EEqn` span: the
enthalpy equation and its BiCGStab."""
from harness import program


def read(run):
    return program.span_ms(run, ("lowmach.EEqn",))
