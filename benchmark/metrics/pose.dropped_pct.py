"""Dynamic boxes the fleet-wide orientation budget dropped
(saturation.orientation_dropped) over those it was offered (run plus
dropped), over the window."""

from benchmark.readers import counted


def read(rec):
    run, dropped = counted(rec, 1).sum(), counted(rec, 2).sum()
    return 100.0 * dropped / (run + dropped) if run + dropped else None
