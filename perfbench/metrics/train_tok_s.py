"""Tokens of the train steps completed inside the window, over its
seconds: the window runs from one step's start to a later step's start,
so it holds whole steps only."""


def read(b):
    if len(b.steps) < 2:
        return None
    n = len(b.steps) - 1
    return n * b.extra["tokens_per_step"] / (b.steps[-1] - b.steps[0])
