"""Share of the traced steps' wall time in which no kernel, copy or fill
ran on the card (%): 1 - the union of the device's activity intervals over
the traced wall time. Host dispatch, synchronisation and data waits show
here."""


def read(run):
    t = run.trace
    if t is None or t.busy_s <= 0 or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
