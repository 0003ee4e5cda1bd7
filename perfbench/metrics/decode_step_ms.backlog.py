"""Wall time inside the engine's decode windows over their decode steps
(engine ``decode`` spans: one a window, with its K), for the windows
that start in the measured window."""

from perfbench.metrics_common import decode_step_ms


def read(b):
    return decode_step_ms(b)
