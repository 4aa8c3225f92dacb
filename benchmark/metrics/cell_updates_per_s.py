"""Cells x steps completed in the measured window over the window's wall
seconds (host clock; the window ends in torch.cuda.synchronize())."""


def read(run):
    return run.cells * run.steps / run.wall_s
