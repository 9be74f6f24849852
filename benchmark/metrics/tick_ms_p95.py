"""The 95th percentile (linear) over all the window's ticks of a
closed-loop tick's latency: its dispatch to its published outputs on the
host."""

import numpy as np


def read(rec):
    lat = [t["latency_s"] for t in rec.ticks if "latency_s" in t]
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
