"""Share of the SSD scan's backward passes that ran the hand-written
backward kernel (%): the program's counters ``ssd/backward_kernel_calls``
over ``ssd/backward_calls`` in the traced steps (``lib/counters.py``): the
first counted at each launch of the kernel (``kernels/ssd_scan.py``), the
second by every backward of ``SSDScan``. 100 where every backward went
through the kernel, 0 where each recomputed ``ssd_chunked`` under
autograd; None from a program without these counters."""
from perfbench.lib import counters


def read(run):
    c = counters.of(run) or {}
    if not c.get("ssd/backward_calls"):
        return None
    return 100.0 * c.get("ssd/backward_kernel_calls", 0) \
        / c["ssd/backward_calls"]
