"""Rig-frames of every tick completed in the window over the window's
wall time (first draw to last readback)."""

def read(rec):
    return rec.frames / rec.window_s
