"""The whole serving step's share of the card's bf16 peak: model FLOPs
of every token computed in the traced span (prompt tokens of each
prefill call and each row's kept decode steps: 2 N_active a token plus
the visible attention), over the span's seconds at 989 TFLOP/s."""

from perfbench import flops, work


def read(b):
    tr = b.trace
    if tr is None:
        return None
    t0, t1 = tr.t0, tr.t1
    s, w, arch = b.sizes, b.sizes.get("window"), b.arch
    total = 0.0
    for a, e, off, n, _ in work.prefill_calls(b):
        total += work.share(a, e, t0, t1) * arch.token_flops(
            s, n, arch.attn_pairs_prefill(off, n, w))
    for a, e, pos in work.decode_rows(b):
        pairs = sum(min(t + 1, w) if w else t + 1 for t in pos)
        total += work.share(a, e, t0, t1) * arch.token_flops(
            s, len(pos), pairs)
    if total <= 0:
        return None
    return 100.0 * total / flops.PEAK_BF16_FLOPS / (t1 - t0)
