"""The benchmark of grid_vision_tpu_torch on the card: `run.py` runs one
cell of BENCHMARK.json once (core.py: traffic, window, judge); configs/,
traffic/, limits/ and metrics/ hold each cell's data and each metric's
reader by name; reference.py is the plain reference that decides
`correct`, counts.py and peaks.json the yardstick's arithmetic."""
