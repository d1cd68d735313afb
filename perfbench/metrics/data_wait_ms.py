"""Host wall time of the data feed per optimizer step (ms): the program's
span ``train_step/data`` in ``Trainer.train_one`` (the batch from its
source and its copy to the card), as the program times it while the
profiler records (``lib/counters.py``), over the traced steps."""
from perfbench.lib import counters


def read(run):
    ns = (counters.of(run) or {}).get("train_step/data:host_ns")
    if not ns or not run.trace.steps:
        return None
    return ns / 1e6 / run.trace.steps
