"""Host clock around each fleet call (Engine.fleet), the mean over all
the window's ticks; the syncs inside the tick (NMS) included."""

from benchmark.readers import mean_ms


def read(rec):
    return mean_ms(rec, "dispatch_s")
