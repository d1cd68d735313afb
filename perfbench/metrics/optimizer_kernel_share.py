"""Share of the optimizer's elements that the AdamW kernel updated (%):
the program's counters ``optimizer/kernel_elements`` over
``optimizer/elements`` in the traced steps (``lib/counters.py``): the
first counted by a launch of the kernel (``kernels/adamw.py``), the
second by every update (``train/optimizer.py``). 100 where every step's
update went through the kernel, 0 where it took the eager version; None
from a program without these counters."""
from perfbench.lib import counters


def read(run):
    c = counters.of(run) or {}
    if not c.get("optimizer/elements"):
        return None
    return 100.0 * c.get("optimizer/kernel_elements", 0) \
        / c["optimizer/elements"]
