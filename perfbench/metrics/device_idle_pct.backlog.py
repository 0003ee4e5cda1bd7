"""Share of the traced span with no kernel, copy or set running on the
card (torch.profiler's CUDA activity)."""

from perfbench.metrics_common import device_idle_pct


def read(b):
    return device_idle_pct(b)
