"""Device time of the selective scan's backward per optimizer step (ms):
what ran under the autograd node ``SelectiveScanBackward`` (the backward
kernel's five launches on the card), over the traced steps. None where the
run has no such node."""

SPAN = "SelectiveScanBackward"


def read(run):
    t = run.trace
    if t is None or not t.steps or t.spans.get(SPAN, (0.0, 0))[0] <= 0:
        return None
    return 1e3 * t.spans[SPAN][0] / t.steps
