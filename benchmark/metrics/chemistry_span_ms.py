"""Mean device ms a step of the program's `lowmach.chemistry` span: the
combustion model's correct() (DF-ODENet here), measured inside the program
(dnn_chemistry_ms's twin)."""
from harness import program


def read(run):
    return program.span_ms(run, ("lowmach.chemistry",))
