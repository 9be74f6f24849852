"""The span segment's share of time with the device idle while the host
was inside the program's gv.step (benchmark/spans.py): the idle the tick
leaves the card, apart from the harness's between ticks."""

from benchmark.spans import segment


def read(rec):
    s = segment(rec)
    if s is None or not s.launches or "step" not in s.seen:
        return None
    return 100.0 * s.idle_in_step_s / s.window_s
