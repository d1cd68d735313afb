"""Device time of the optimizer per optimizer step (ms): what the kernels
launched inside the program's ``train_step/optimizer`` range took, over
the traced steps."""

SPAN = "train_step/optimizer"


def read(run):
    t = run.trace
    if t is None or not t.steps or t.spans.get(SPAN, (0.0, 0))[0] <= 0:
        return None
    return 1e3 * t.spans[SPAN][0] / t.steps
