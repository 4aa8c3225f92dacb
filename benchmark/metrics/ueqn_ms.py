"""Mean device ms a step of the program's `lowmach.UEqn` span: the
momentum predictor and its BiCGStab (the tracer's CUDA events over a whole
segment, `harness/program.spans`)."""
from harness import program


def read(run):
    return program.span_ms(run, ("lowmach.UEqn",))
