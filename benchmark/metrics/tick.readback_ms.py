"""Host clock of a closed-loop tick's outputs' copy to the host, the
mean over all the window's ticks."""

from benchmark.readers import mean_ms


def read(rec):
    return mean_ms(rec, "readback_s")
