"""Device busy time a tick (the union of its operations' intervals) in
the traced segment."""

def read(rec):
    if rec.trace is None or not rec.work["ticks"]:
        return None
    return rec.trace.busy_s / rec.work["ticks"] * 1e3
