"""100 x DF-ODENet's operations a step on the cells that react (above the
frozen temperature in the step's input, counted in the span stretch) over
(the measured window's wall seconds a step x the peak of the nets'
precision: bf16 tensor cores 989, float32 CUDA cores 67 TFLOP/s). The
work is the nets' own, whatever computes them: cells below the frozen
temperature need no pass through the nets."""
from harness import work


def read(run):
    if not run.spans:
        return None
    net = run.config["dfodenet"]
    ns = run.n_species
    widths = [ns + 2] + list(net["hidden"]) + [1]
    hot = sum(s["hot_cells"] for s in run.spans) / len(run.spans)
    flops = 2.0 * hot * (ns - 1) * work.macs(widths)
    step_s = run.wall_s / run.steps
    return 100.0 * flops / (step_s * work.PEAK_FLOP_PER_S[net["precision"]])
