"""Model FLOP utilization of the whole train step (%): the model FLOPs of
an optimizer step (``lib/modelflops.py``) over the step's time, over the
card's dense bf16 peak. The step's time is the untraced window's: its
wall time over its optimizer steps."""
from perfbench.lib import modelflops, peaks


def read(run):
    if not run.window_steps or run.window_s <= 0:
        return None
    step_s = run.window_s / run.window_steps
    flops = modelflops.step_flops(run.model, run.traffic)
    return 100.0 * flops / step_s / peaks.BF16_FLOPS
