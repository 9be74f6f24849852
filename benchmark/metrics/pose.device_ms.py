"""Device time a tick of the operations launched under the program's gv.pose
span in the span segment (benchmark/spans.py): the pose branch (compaction,
the orientation front kernel and net, MultiBin, the scatter back)."""

from benchmark.spans import device_ms


def read(rec):
    return device_ms(rec, "pose")
