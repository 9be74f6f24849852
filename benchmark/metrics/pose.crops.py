"""Valid crops the orientation net ran a tick (the fleet's valid poses),
the mean over the window's ticks."""

from benchmark.readers import counted


def read(rec):
    return float(counted(rec, 1).mean())
