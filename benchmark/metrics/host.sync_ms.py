"""Host time a tick inside the program's gv.sync spans, the host waiting
for the device at its syncs, over the span segment's host-clock ticks
(benchmark/spans.py)."""

from benchmark.spans import host_per_tick


def read(rec):
    return host_per_tick(rec, "sync", 1, 1e3)
