"""Device operations (kernels, copies) a tick in the traced segment."""

def read(rec):
    if rec.trace is None or not rec.work["ticks"]:
        return None
    return rec.trace.launches / rec.work["ticks"]
