"""The train step's share of the card's bf16 peak over the window: model
FLOPs of the steps completed in it (6 N T plus the dense attention, as
the architecture's ``train_flops`` counts them, no recomputation), over
the window's seconds at 989 TFLOP/s."""

from perfbench import flops


def read(b):
    if len(b.steps) < 2:
        return None
    n = len(b.steps) - 1
    f = b.arch.train_flops(b.sizes, b.extra["batch"], b.extra["seq"])
    return 100.0 * n * f / flops.PEAK_BF16_FLOPS / (b.steps[-1] - b.steps[0])
