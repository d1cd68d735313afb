"""Kernel launches per optimizer step: the host's ``cudaLaunchKernel*``
and ``cuLaunchKernel*`` calls over the traced steps. The traced steps are
``Trainer.train_one`` calls alone, and the program's span ``train_step``
holds the whole of each (the backward's launches, made on autograd's own
thread, fall inside it in time), so these are the launches of the
program's train-step spans; None from a program without that span."""
from perfbench.lib.phases import LAUNCHES


def read(run):
    t = run.trace
    if t is None or not t.steps or "train_step" not in t.spans:
        return None
    n = sum(calls for key, (_, calls) in t.spans.items()
            if key.startswith(LAUNCHES))
    return n / t.steps if n else None
