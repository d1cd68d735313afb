"""Share of the rows the model's RMS norms normed through the hand-written
norm kernel (%): the program's counters ``norm/kernel_rows`` over
``norm/rows`` in the traced steps (``lib/counters.py``): the first counted
at each launch of the norm's forward kernel (``kernels/rms_norm.py``), the
second by every forward call of ``models/layers.rms_norm``. 100 where every
norm went through the kernel; below it where some normed a float32 input
(``add_norm``'s sum) by the eager chain; None from a program without these
counters."""
from perfbench.lib import counters


def read(run):
    c = counters.of(run) or {}
    if not c.get("norm/rows"):
        return None
    return 100.0 * c.get("norm/kernel_rows", 0) / c["norm/rows"]
