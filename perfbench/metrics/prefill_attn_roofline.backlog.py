"""Prefill attention's share of its roofline: the visible q.k and p.v
FLOPs of the prefill calls that run the flash-attention kernel (whole
prompts, ``path == "direct"``) in the traced span, at 989 TFLOP/s bf16,
over the device time of that kernel in the span."""

from perfbench import flops, profiling, work


def read(b):
    tr = b.trace
    if tr is None:
        return None
    t0, t1 = tr.t0, tr.t1
    w = b.sizes.get("window")
    need = sum(work.share(a, e, t0, t1) * b.arch.attn_flops(
        b.sizes, b.arch.attn_pairs_prefill(off, n, w))
        for a, e, off, n, path in work.prefill_calls(b) if path == "direct")
    busy = profiling.seconds_by(
        tr.kernels, t0, t1, lambda n: profiling.family(n) == "prefill_attn")
    if busy <= 0 or need <= 0:
        return None
    return 100.0 * need / flops.PEAK_BF16_FLOPS / busy
