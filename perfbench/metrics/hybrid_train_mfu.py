"""Model FLOP utilization of the whole train step of a ``hybrid_moe``
cell (%): the model FLOPs of an optimizer step (``hybrid_step_work.py``)
over the step's time, over the card's dense bf16 peak. The step's time
is the untraced window's: its wall time over its optimizer steps. Other
families have none (``train_mfu`` is theirs)."""
from perfbench.lib import catalog, peaks


def read(run):
    if (run.model.get("family") != "hybrid_moe" or not run.window_steps
            or run.window_s <= 0):
        return None
    step_s = run.window_s / run.window_steps
    flops = catalog.module("metrics", "hybrid_step_work").step_flops(
        run.model, run.traffic)
    return 100.0 * flops / step_s / peaks.BF16_FLOPS
