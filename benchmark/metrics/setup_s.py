"""Process start to the first timed dispatch: imports, the CUDA context,
kernels loaded or built, scenes rendered, weights loaded and folded, the
cell's shapes warmed."""

def read(rec):
    return rec.setup_s
