"""Device time a tick of the operations launched under the program's gv.grid
span in the span segment (benchmark/spans.py): the grid (the carve or
rasterize update through the int8 export)."""

from benchmark.spans import device_ms


def read(rec):
    return device_ms(rec, "grid")
