"""Decode attention's share of its roofline: the least time in which the
card's HBM (3.35 TB/s) could deliver the K/V bytes that the traced
span's decode steps needed (each row's context, by the architecture's
``decode_kv_bytes``), over the device time of the decode-attention
kernels in that span."""

from perfbench import flops, profiling, work


def read(b):
    tr = b.trace
    if tr is None:
        return None
    t0, t1 = tr.t0, tr.t1
    kv_bytes = b.arch.decode_kv_bytes
    need = sum(work.share(a, e, t0, t1) * kv_bytes(b.sizes, pos)
               for a, e, pos in work.decode_rows(b))
    busy = profiling.seconds_by(
        tr.kernels, t0, t1, lambda n: profiling.family(n) == "decode_attn")
    if busy <= 0 or need <= 0:
        return None
    return 100.0 * need / flops.PEAK_HBM_BYTES / busy
