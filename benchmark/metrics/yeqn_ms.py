"""Mean device ms a step of the program's `lowmach.YEqn` span: the
species' batched transport and its BiCGStab."""
from harness import program


def read(run):
    return program.span_ms(run, ("lowmach.YEqn",))
