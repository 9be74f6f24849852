"""torch.cuda.max_memory_allocated over the measured window (the peak
statistics reset after the warm-up), in GiB."""

def read(rec):
    return rec.memory_peak_bytes / 2 ** 30 if rec.memory_peak_bytes else None
