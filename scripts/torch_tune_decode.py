"""Time the flash-decode kernels at the four decode shapes of PERF.md over
a range of split lengths, beside the one ``split_plan`` picks:

    python3 scripts/torch_tune_decode.py

Needs a CUDA card. Prints one JSON line per shape: the card, the length
``split_plan`` picks, and for each split length (in tiles) its time
(``torch_time_kernels.time_ms``: the median of 50 CUDA-event timings,
each launch after a 64 MB L2 flush). The split plan's constants
(``decode_attention._WARPS_PER_SM`` and the rest) are read off these
lines.
"""

from __future__ import annotations

import json
import math

import torch

# First: it puts the checkout's src/ on sys.path.
from torch_time_kernels import nvidia_smi, time_ms

from repro_torch.kernels import decode_attention as dec

# label: B, H, KV, dh, valid slots per row (of L = 2048), paged
SHAPES = {
    "K1 qwen2-1.5b B=8": (8, 12, 2, 128, [2048] * 8, False),
    "K1 recurrentgemma-2b B=1": (1, 10, 1, 256, [2048], False),
    "K1 recurrentgemma-2b B=8": (8, 10, 1, 256,
                                 [2048, 1500, 77, 2048, 2000, 1024, 300,
                                  2048], False),
    "K2 qwen2-1.5b B=8 ps=16": (8, 12, 2, 128, [2048] * 8, True),
}
L, PS = 2048, 16
SPLIT_TILES = (1, 2, 3, 4, 6, 8, 16, 64)


def _inputs(gen, B, H, KV, dh, lengths, paged):
    bf16 = dict(dtype=torch.bfloat16, device="cuda")
    q = torch.randn((B, H, dh), generator=gen, device="cuda").to(**bf16)
    valid = (torch.arange(L, device="cuda")[None, :]
             < torch.as_tensor(lengths, device="cuda")[:, None])
    if not paged:
        k, v = (torch.randn((B, L, KV, dh), generator=gen,
                            device="cuda").to(**bf16) for _ in range(2))
        return lambda: dec.decode_attention(q, k, v, valid)
    n = L // PS
    P = B * n + 1
    kp, vp = (torch.randn((P, PS, KV, dh), generator=gen,
                          device="cuda").to(**bf16) for _ in range(2))
    pages = torch.randperm(P, generator=gen, device="cuda")[:B * n]
    pages = pages.to(torch.int32).reshape(B, n).contiguous()
    return lambda: dec.paged_decode_attention(q, kp, vp, pages, valid)


def main() -> None:
    smi = nvidia_smi("name,power.limit")
    sms = dec._num_sms(torch.device("cuda"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    plan = dec.split_plan
    for label, (B, H, KV, dh, lengths, paged) in SHAPES.items():
        call = _inputs(gen, B, H, KV, dh, lengths, paged)
        picked = plan(L, B * KV, H // KV, 2, sms)
        times = {}
        for tiles in SPLIT_TILES:
            split_len = tiles * dec.TILE
            dec.split_plan = (lambda *_, s=split_len:
                              (s, math.ceil(L / s)))
            try:
                times[tiles] = time_ms(call)
            finally:
                dec.split_plan = plan
        print(json.dumps({"shape": label, "device": smi,
                          "split_plan_tiles": picked[0] // dec.TILE,
                          "n_splits": picked[1],
                          "split_plan_ms": time_ms(call),
                          "ms_by_split_tiles": times}), flush=True)


if __name__ == "__main__":
    main()
