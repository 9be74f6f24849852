"""Blocking host reads of device values a tick: the program's gv.sync
spans (every NMS sweep's test, and each other sync of the tick) over the
span segment's host-clock ticks (benchmark/spans.py)."""

from benchmark.spans import host_per_tick


def read(rec):
    return host_per_tick(rec, "sync", 0)
