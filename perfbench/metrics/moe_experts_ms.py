"""Device time of the held experts per optimizer step (ms): what ran under
the span ``moe/experts`` (the experts' products and the combine, in the
forward and in each layer's remat recompute) and under its autograd node
``MoEExpertsBackward`` (the backward, which recomputes the products),
over the traced steps. A program without the expert share has neither."""

SPANS = ("moe/experts", "MoEExpertsBackward")


def read(run):
    t = run.trace
    if t is None or not t.steps:
        return None
    total = sum(t.spans.get(s, (0.0, 0))[0] for s in SPANS)
    if total <= 0:
        return None
    return 1e3 * total / t.steps
