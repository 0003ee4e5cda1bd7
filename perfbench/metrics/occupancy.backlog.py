"""Rows decoded per decode step over the window: the engine's
``occupancy_sum`` over its ``steps``, from the counters' change across
the window."""


def read(b):
    steps = b.stats1["steps"] - b.stats0["steps"]
    if steps <= 0:
        return None
    return (b.stats1["occupancy_sum"] - b.stats0["occupancy_sum"]) / steps
