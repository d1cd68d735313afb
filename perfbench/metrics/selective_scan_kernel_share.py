"""Share of the selective scan's calls that ran the hand-written kernel
(%): the program's counters ``selective_scan/kernel_calls`` over
``selective_scan/calls`` in the traced steps (``lib/counters.py``): the
first counted at each launch of the forward or the backward kernel
(``kernels/selective_scan.py``), the second by every forward call and every
backward. 100 where each forward and each backward went through the
kernels; below it where some ran the plain version; None from a program
without these counters."""
from perfbench.lib import counters


def read(run):
    c = counters.of(run) or {}
    if not c.get("selective_scan/calls"):
        return None
    return 100.0 * c.get("selective_scan/kernel_calls", 0) \
        / c["selective_scan/calls"]
