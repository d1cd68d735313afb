"""Share of the held experts' slots that hold a token (%): the program's
counters ``moe/held_kept`` (choices routed to a held expert that found a
slot) over ``moe/held_slots`` (G x held x C a layer) in the forwards of
the traced steps (``models/moe.py``, ``lib/counters.py``). The held
experts' products compute every slot, so 100 less this is their work
spent on empty slots."""
from perfbench.lib import counters


def read(run):
    c = counters.of(run) or {}
    if not c.get("moe/held_slots"):
        return None
    return 100.0 * c.get("moe/held_kept", 0) / c["moe/held_slots"]
