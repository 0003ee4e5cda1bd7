"""Share of the traced steps' kernel time in kernels that are neither a
matrix product nor attention (classified by name, ``profiling.family``):
norms, activations, casts, the loss, the optimizer's arithmetic."""

from perfbench import profiling


def read(b):
    tr = b.trace
    if tr is None:
        return None
    total = profiling.seconds_by(tr.kernels, tr.t0, tr.t1, lambda n: True)
    other = profiling.seconds_by(tr.kernels, tr.t0, tr.t1,
                                 lambda n: profiling.family(n) == "other")
    return 100.0 * other / total if total > 0 else None
