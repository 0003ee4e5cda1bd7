"""The held experts' grouped products' share of their roofline: the
FLOPs those products need in the whole steps that the traced span
holds, forward and backward and no recomputation, at the mean load
(every held expert routed top_k x H / E of each token's rows, as the
architecture's ``expert_flops`` counts them: the measured rows are the
counters ``train.moe.rows_held`` and ``train.moe.rows_max``), at
989 TFLOP/s bf16, over the device time of the grouped-GEMM kernels
(CUTLASS's, named for their ``GroupProblemShape``) in those steps."""

from perfbench import flops, profiling

GROUPED = "GroupProblemShape"


def read(b):
    tr = b.trace
    count = getattr(b.arch, "expert_flops", None)
    if tr is None or count is None:
        return None
    walls = [b.wall(t) for t in b.steps]
    whole = [(a, e) for a, e in zip(walls, walls[1:])
             if tr.t0 <= a and e <= tr.t1]
    if not whole:
        return None
    busy = sum(profiling.seconds_by(tr.kernels, a, e,
                                    lambda n: GROUPED in n)
               for a, e in whole)
    if busy <= 0:
        return None
    need = len(whole) * count(b.sizes, b.extra["batch"], b.extra["seq"])
    return 100.0 * need / flops.PEAK_BF16_FLOPS / busy
