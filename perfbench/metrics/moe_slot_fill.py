"""Share of the MoE dispatch's expert slots that hold a token (%): the
program's counters ``moe/kept`` (choices that found a slot) over
``moe/slots`` (G x E x C a layer) in the forwards of the traced steps
(``models/moe.py``, ``lib/counters.py``). The expert GEMMs compute every
slot, so 100 less this is expert work spent on zeros."""
from perfbench.lib import counters


def read(run):
    c = counters.of(run) or {}
    if not c.get("moe/slots"):
        return None
    return 100.0 * c.get("moe/kept", 0) / c["moe/slots"]
