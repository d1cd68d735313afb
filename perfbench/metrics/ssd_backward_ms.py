"""Device time of the SSD scan's backward per optimizer step (ms): what
ran under the autograd node ``SSDScanBackward``, over the traced steps."""

SPAN = "SSDScanBackward"


def read(run):
    t = run.trace
    if t is None or not t.steps or t.spans.get(SPAN, (0.0, 0))[0] <= 0:
        return None
    return 1e3 * t.spans[SPAN][0] / t.steps
