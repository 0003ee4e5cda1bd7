"""The decoder-only GQA transformer: RMSNorm, RoPE with one theta, one
attention window (or none) in every layer, and a SwiGLU MLP, dense or a
softmax top-k mixture of experts with a capacity. Qwen2 and Mixtral.

What the benchmark knows of it, found by the configuration's
``"bench_arch": "transformer"``: the plain dict of sizes the reference
and the counts read, the port's ``ModelConfig``, the layout of the
weights, the plain reference, the operations and bytes that the work
needs, and the configuration at a size a CPU test holds.

The configuration file holds the source's own keys (its
``config.json``), ``reduced`` (the keys changed from it), ``port`` (what
the port needs beside them: its registered architecture, layer pattern,
dtypes, the MoE's capacity rule), and the deployment's settings under
``serve`` and ``train``. Nothing here imports the program but
``program_config``, when it is called."""

from __future__ import annotations

import copy

from perfbench.reference import transformer as reference  # noqa: F401

# The source's key -> the reference's name for it.
_KEYS = {
    "num_hidden_layers": "layers",
    "hidden_size": "d",
    "num_attention_heads": "h",
    "num_key_value_heads": "kv",
    "intermediate_size": "f",
    "vocab_size": "vocab",
    "rms_norm_eps": "eps",
    "rope_theta": "theta",
    "tie_word_embeddings": "tie",
    "num_local_experts": "experts",
    "num_experts_per_tok": "top_k",
}

# Every width cut for the CPU tests.
TINY_SIZES = {"hidden_size": 64, "intermediate_size": 128,
              "num_attention_heads": 4, "num_key_value_heads": 2,
              "num_hidden_layers": 2, "vocab_size": 256}


def sizes(conf: dict) -> dict:
    """The plain dict of sizes and rules the reference and the FLOP
    counts read."""
    port = conf.get("port", {})
    out = {v: conf[k] for k, v in _KEYS.items() if k in conf}
    out.setdefault("experts", 0)
    out.setdefault("top_k", 0)
    out["dh"] = conf.get("head_dim") or out["d"] // out["h"]
    out["qkv_bias"] = bool(port.get("qkv_bias", False))
    out["window"] = port.get("window")
    out["capacity_factor"] = float(port.get("moe_capacity_factor", 0.0))
    out["group_tokens"] = int(port.get("moe_group_tokens", 0))
    out["router_aux_loss"] = float(conf.get("router_aux_loss_coef", 0.0))
    out["compute_dtype"] = port.get("compute_dtype", "bfloat16")
    out["param_dtype"] = port.get("param_dtype", "float32")
    return out


def program_config(conf: dict):
    """The port's ``ModelConfig`` for this file: the registered
    architecture ``port.arch`` with the file's sizes set over it. A width
    that differs from the registered one is refused: the file may cut
    depth, never a width."""
    import dataclasses

    from repro_torch import configs

    s = sizes(conf)
    port = conf["port"]
    base = configs.get(port["arch"])
    cfg = dataclasses.replace(
        base, num_layers=s["layers"], d_model=s["d"], num_heads=s["h"],
        num_kv_heads=s["kv"], d_ff=s["f"], vocab_size=s["vocab"],
        head_dim=s["dh"], norm_eps=s["eps"], rope_theta=s["theta"],
        tie_embeddings=s["tie"], qkv_bias=s["qkv_bias"],
        pattern=tuple(port["pattern"]), window=s["window"],
        num_experts=s["experts"], experts_per_token=s["top_k"],
        moe_capacity_factor=(s["capacity_factor"] or
                             base.moe_capacity_factor),
        router_aux_loss=s["router_aux_loss"] or base.router_aux_loss,
        compute_dtype=s["compute_dtype"], param_dtype=s["param_dtype"])
    for f in ("d_model", "num_heads", "num_kv_heads", "d_ff", "head_dim",
              "num_experts", "experts_per_token"):
        if getattr(cfg, f) != getattr(base, f) and not conf.get("tiny"):
            raise ValueError(f"{conf['name']}: {f} {getattr(cfg, f)} is not "
                             f"the published {getattr(base, f)}")
    return cfg


def tiny(conf: dict) -> dict:
    """A copy of ``conf`` at a size a CPU test holds, in float32 compute:
    the port then agrees with the reference to rounding, and a fault
    stands out against any committed limit."""
    conf = copy.deepcopy(conf)
    conf.update(TINY_SIZES, tiny=True)
    conf["port"]["compute_dtype"] = "float32"
    return conf


def layout(s: dict) -> list[tuple[tuple, tuple, str]]:
    """[(path, shape, kind)] in drawing order; kind is "matrix",
    "matrix_rows", "bias" or "scale" (``weights.draw``)."""
    d, f, V = s["d"], s["f"], s["vocab"]
    hq, hk = s["h"] * s["dh"], s["kv"] * s["dh"]
    out = [(("embed", "tokens"), (V, d), "matrix_rows")]
    if not s["tie"]:
        out.append((("embed", "head", "kernel"), (d, V), "matrix"))
    for r in range(s["layers"]):
        b = ("blocks", r, "0")
        out.append((b + ("norm", "scale"), (d,), "scale"))
        for name, width in (("wq", hq), ("wk", hk), ("wv", hk)):
            out.append((b + ("attn", name, "kernel"), (d, width), "matrix"))
            if s["qkv_bias"]:
                out.append((b + ("attn", name, "bias"), (width,), "bias"))
        out.append((b + ("attn", "wo", "kernel"), (hq, d), "matrix"))
        out.append((b + ("mlp_norm", "scale"), (d,), "scale"))
        if s["experts"]:
            e = s["experts"]
            out += [(b + ("mlp", "router", "kernel"), (d, e), "matrix"),
                    (b + ("mlp", "w_gate"), (e, d, f), "matrix"),
                    (b + ("mlp", "w_up"), (e, d, f), "matrix"),
                    (b + ("mlp", "w_down"), (e, f, d), "matrix")]
        else:
            out += [(b + ("mlp", "w_gate", "kernel"), (d, f), "matrix"),
                    (b + ("mlp", "w_up", "kernel"), (d, f), "matrix"),
                    (b + ("mlp", "w_down", "kernel"), (f, d), "matrix")]
    out.append((("final_norm", "scale"), (d,), "scale"))
    return out


# ---------------------------------------------------------------------------
# Operations and bytes, from shapes and lengths alone (the peaks they are
# held to are ``flops.py``'s)
# ---------------------------------------------------------------------------

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
