"""Mean device ms a step of the program's `lowmach.props`,
`lowmach.thermo` and `lowmach.end` spans: continuity, the mixture and SGS
coefficients, T from h, and the step's closing reductions. With ueqn_ms,
yeqn_ms, eeqn_ms and peqn_ms: the whole flow solve, measured inside the
program (flow_ms's twin)."""
from harness import program


def read(run):
    return program.span_ms(run, ("lowmach.props", "lowmach.thermo",
                                 "lowmach.end"))
