"""Seconds from the start of benchmark/run.py to the first timed step:
imports, the kernel library's load (its build on a checkout's first run),
the case's build, the weights, the warm-up steps."""


def read(run):
    return run.setup_s
