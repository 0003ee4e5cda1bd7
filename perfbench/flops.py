"""The yardstick's arithmetic: the card's peaks, and the operations and
bytes that the work needs, counted from shapes and lengths alone.

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, dense rates at the full
700 W (``roofline/analysis.py`` of the port holds the same constants)."""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


def matmul_params(s: dict, active: bool = True) -> int:
    """Weights that multiply each token: q, k, v, o and the MLP (with
    ``active``, an MoE's top-k experts and its router; else every expert)
    over every layer, and the LM head. Norms, biases and the embedding
    lookup multiply nothing."""
    d, f, dh = s["d"], s["f"], s["dh"]
    attn = d * s["h"] * dh * 2 + d * s["kv"] * dh * 2
    if s["experts"]:
        k = s["top_k"] if active else s["experts"]
        mlp = k * 3 * d * f + d * s["experts"]
    else:
        mlp = 3 * d * f
    return s["layers"] * (attn + mlp) + d * s["vocab"]


def param_count(s: dict) -> int:
    """Every parameter (the embedding once when tied)."""
    d, f, dh = s["d"], s["f"], s["dh"]
    attn = d * s["h"] * dh * 2 + d * s["kv"] * dh * 2
    if s["qkv_bias"]:
        attn += (s["h"] + 2 * s["kv"]) * dh
    mlp = (s["experts"] * 3 * d * f + d * s["experts"] if s["experts"]
           else 3 * d * f)
    emb = s["vocab"] * d * (1 if s["tie"] else 2)
    return s["layers"] * (attn + mlp + 2 * d) + emb + d


def attn_pairs_prefill(t0: int, n: int, window=None) -> int:
    """Visible (query, key) pairs when ``n`` causal queries at positions
    t0 .. t0+n-1 attend to every earlier position (within ``window``)."""
    if window is None:
        return n * t0 + n * (n + 1) // 2
    return sum(min(t0 + i + 1, window) for i in range(n))


def attn_flops(s: dict, pairs: int) -> float:
    """q.k and p.v over ``pairs`` (query, key) pairs in every layer."""
    return 4.0 * pairs * s["h"] * s["dh"] * s["layers"]


def kv_bytes_per_token(s: dict, itemsize: int = 2) -> int:
    """K and V of one position in every layer."""
    return 2 * s["kv"] * s["dh"] * itemsize * s["layers"]


def decode_kv_bytes(s: dict, positions: list[int], itemsize: int = 2
                    ) -> float:
    """K/V bytes that decode steps at these positions must read: a step
    at position t reads t + 1 cached positions (within the window)."""
    w = s.get("window")
    n = sum(min(t + 1, w) if w else t + 1 for t in positions)
    return float(n) * kv_bytes_per_token(s, itemsize)


def train_flops(s: dict, batch: int, seq: int) -> float:
    """Model FLOPs of one train step, as PaLM counts them: 6 N T over the
    matmul weights, and q.k and p.v over the full S x S square (which the
    dense attention computes) three times, forward and backward; no
    recomputation counted."""
    pairs = batch * seq * seq
    return (6.0 * matmul_params(s) * batch * seq
            + 3.0 * attn_flops(s, pairs))


def token_flops(s: dict, tokens: int, pairs: int) -> float:
    """Model FLOPs of ``tokens`` forward tokens whose attention covers
    ``pairs`` visible pairs: 2 N_active a token plus the attention."""
    return 2.0 * matmul_params(s) * tokens + attn_flops(s, pairs)
