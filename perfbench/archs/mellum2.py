"""Mellum2's decoder: GQA with RMSNorm, three sliding-window layers then
one full layer in every period of four, plain RoPE on the sliding
layers and YaRN on the full ones, and in every layer a sparse MLP: a
softmax router over all the experts, the top-k renormalised, and SwiGLU
experts of which this device holds a share, computed for every token
routed to them with nothing dropped.

What the benchmark knows of it, found by the configuration's
``"bench_arch": "mellum2"``: the sizes the reference and the counts
read, the port's ``ModelConfig``, the layout of the weights, the plain
reference (``reference/mellum2.py``), the operations that the work
needs, and the configuration at a size a CPU test holds.

The configuration file holds the source's own keys (its
``config.json``), where ``num_experts`` counts the experts held here
and the published count is under ``published``; ``reduced``;
``deployment``; ``assumed``; ``port`` (the port's registered
architecture, dtypes and the assumed aux-loss coefficient) and the
training settings under ``train``. Nothing here imports the program but
``program_config``, when it is called."""

from __future__ import annotations

import copy

from perfbench.reference import mellum2 as reference  # noqa: F401

KINDS = {"sliding_attention": "swa", "full_attention": "attn"}

# Every width cut for the CPU tests: 16 experts top-4 of which 8 are
# held, a window of 4 (the tiny runs' sequences are 16 long), and the
# published YaRN, whose ramp at head_dim 16 blends frequency pairs 3-4.
TINY_SIZES = {"hidden_size": 64, "moe_intermediate_size": 32,
              "num_attention_heads": 4, "num_key_value_heads": 2,
              "head_dim": 16, "num_hidden_layers": 8, "vocab_size": 256,
              "num_experts": 8, "num_experts_per_tok": 4,
              "sliding_window": 4}
TINY_PUBLISHED_EXPERTS = 16


def sizes(conf: dict) -> dict:
    """The plain dict of sizes and rules the reference and the counts
    read."""
    port = conf["port"]
    rope = conf["rope_parameters"]
    full = rope["full_attention"]
    kinds = [KINDS[t] for t in conf["layer_types"]]
    if conf["num_hidden_layers"] != len(kinds):
        raise ValueError("layer_types does not name every layer")
    held = int(conf["num_experts"])
    return {
        "layers": conf["num_hidden_layers"], "kinds": kinds,
        "d": conf["hidden_size"], "h": conf["num_attention_heads"],
        "kv": conf["num_key_value_heads"], "dh": conf["head_dim"],
        "f": conf["moe_intermediate_size"], "vocab": conf["vocab_size"],
        "eps": conf["rms_norm_eps"], "tie": conf["tie_word_embeddings"],
        "window": conf["sliding_window"],
        "theta": rope["sliding_attention"]["rope_theta"],
        "yarn": {"theta": full["rope_theta"], "factor": full["factor"],
                 "original_max_positions":
                     full["original_max_position_embeddings"],
                 "beta_fast": full["beta_fast"],
                 "beta_slow": full["beta_slow"],
                 "attention_factor": full["attention_factor"]},
        "experts": int(conf["published"]["num_experts"]),
        "held": (0, held), "top_k": conf["num_experts_per_tok"],
        "norm_topk": bool(conf["norm_topk_prob"]),
        "router_aux_loss": float(port["router_aux_loss"]),
        "compute_dtype": port.get("compute_dtype", "bfloat16"),
        "param_dtype": port.get("param_dtype", "float32"),
    }


def program_config(conf: dict):
    """The port's ``ModelConfig``: the registered ``port.arch`` with this
    file's depth, vocabulary, held experts and dtypes. A width, the
    window, the routing or the RoPE that differs from the registered
    configuration is refused (a tiny file may cut widths)."""
    import dataclasses

    from repro_torch import configs

    s = sizes(conf)
    base = configs.get(conf["port"]["arch"])
    period = len(base.pattern)
    if s["kinds"] != list(base.pattern) * (s["layers"] // period):
        raise ValueError(f"{conf['name']}: layer_types is not whole periods "
                         f"of {base.pattern}")
    y = s["yarn"]
    cfg = dataclasses.replace(
        base, num_layers=s["layers"], d_model=s["d"], num_heads=s["h"],
        num_kv_heads=s["kv"], head_dim=s["dh"], d_ff=s["f"],
        vocab_size=s["vocab"], norm_eps=s["eps"], tie_embeddings=s["tie"],
        window=s["window"], rope_theta=s["theta"],
        rope_yarn=dataclasses.replace(
            base.rope_yarn, factor=y["factor"],
            original_max_positions=y["original_max_positions"],
            beta_fast=y["beta_fast"], beta_slow=y["beta_slow"],
            attention_factor=y["attention_factor"]),
        num_experts=s["experts"], experts_per_token=s["top_k"],
        experts_held=s["held"], router_aux_loss=s["router_aux_loss"],
        compute_dtype=s["compute_dtype"], param_dtype=s["param_dtype"])
    if y["theta"] != s["theta"]:
        raise ValueError(f"{conf['name']}: the port rotates every layer by "
                         "one theta")
    if not s["norm_topk"]:
        raise ValueError(f"{conf['name']}: the port renormalises the top-k")
    for f in ("d_model", "num_heads", "num_kv_heads", "d_ff", "head_dim",
              "num_experts", "experts_per_token", "window", "rope_theta",
              "rope_yarn", "norm_eps", "tie_embeddings"):
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
    conf["layer_types"] = conf["layer_types"][:TINY_SIZES[
        "num_hidden_layers"]]
    conf["published"]["num_experts"] = TINY_PUBLISHED_EXPERTS
    conf["port"]["compute_dtype"] = "float32"
    return conf


def layout(s: dict) -> list[tuple[tuple, tuple, str]]:
    """[(path, shape, kind)] in drawing order; kind is "matrix",
    "matrix_rows" or "scale" (``weights.draw``). Block ``i`` of period
    ``r`` is layer 4r + i."""
    d, f, V = s["d"], s["f"], s["vocab"]
    hq, hk = s["h"] * s["dh"], s["kv"] * s["dh"]
    lo, hi = s["held"]
    out = [(("embed", "tokens"), (V, d), "matrix_rows")]
    if not s["tie"]:
        out.append((("embed", "head", "kernel"), (d, V), "matrix"))
    for layer in range(s["layers"]):
        b = ("blocks", layer // 4, str(layer % 4))
        out.append((b + ("norm", "scale"), (d,), "scale"))
        for name, width in (("wq", hq), ("wk", hk), ("wv", hk)):
            out.append((b + ("attn", name, "kernel"), (d, width), "matrix"))
        out.append((b + ("attn", "wo", "kernel"), (hq, d), "matrix"))
        out.append((b + ("mlp_norm", "scale"), (d,), "scale"))
        out += [(b + ("mlp", "router", "kernel"), (d, s["experts"]),
                 "matrix"),
                (b + ("mlp", "w_gate"), (hi - lo, d, f), "matrix"),
                (b + ("mlp", "w_up"), (hi - lo, d, f), "matrix"),
                (b + ("mlp", "w_down"), (hi - lo, f, d), "matrix")]
    out.append((("final_norm", "scale"), (d,), "scale"))
    return out


# ---------------------------------------------------------------------------
# Operations, from shapes and lengths alone (the peaks they are held to
# are ``flops.py``'s)
# ---------------------------------------------------------------------------

def held_share(s: dict) -> float:
    """The mean number of a token's choices that land on a held expert,
    top_k x H / E, if the router spreads the tokens evenly."""
    lo, hi = s["held"]
    return s["top_k"] * (hi - lo) / s["experts"]


def matmul_params(s: dict) -> float:
    """Weights that multiply each token: q, k, v, o, the router, the held
    experts at the mean load, in every layer, and the LM head."""
    d, f, dh = s["d"], s["f"], s["dh"]
    attn = d * s["h"] * dh * 2 + d * s["kv"] * dh * 2
    mlp = held_share(s) * 3 * d * f + d * s["experts"]
    return s["layers"] * (attn + mlp) + d * s["vocab"]


def param_count(s: dict) -> int:
    """Every parameter held here: the held experts' and the sliced
    vocabulary's."""
    d, f, dh = s["d"], s["f"], s["dh"]
    lo, hi = s["held"]
    attn = d * s["h"] * dh * 2 + d * s["kv"] * dh * 2
    mlp = (hi - lo) * 3 * d * f + d * s["experts"]
    emb = s["vocab"] * d * (1 if s["tie"] else 2)
    return s["layers"] * (attn + mlp + 2 * d) + emb + d


def attn_pairs(s: dict, seq: int) -> int:
    """Visible (query, key) pairs of one causal sequence over every
    layer: min(t + 1, window) at position t in a sliding layer, t + 1 in
    a full one."""
    w = s["window"]
    full = seq * (seq + 1) // 2
    band = full if seq <= w else w * (w + 1) // 2 + (seq - w) * w
    return sum(band if k == "swa" else full for k in s["kinds"])


def train_flops(s: dict, batch: int, seq: int) -> float:
    """Model FLOPs of one train step: 6 N T over the matmul weights, the
    held experts at the mean load (``held_share``), and q.k and p.v over
    the visible pairs (not the square that the dense path computes),
    three times, forward and backward; no recomputation counted. So
    ``mfu.train`` here counts visible pairs, where ``archs/transformer``
    counts the whole S x S square of every layer: its readings compare
    across architectures only with that difference in mind."""
    attn = 4.0 * attn_pairs(s, seq) * s["h"] * s["dh"] * batch
    return 6.0 * matmul_params(s) * batch * seq + 3.0 * attn


def expert_flops(s: dict, batch: int, seq: int) -> float:
    """FLOPs of the held experts' products in one train step at the mean
    load: three products of 2 d f a routed row, forward and backward (3
    x), in every layer; no recomputation counted."""
    rows = held_share(s) * batch * seq * s["layers"]
    return 3.0 * rows * 3 * 2.0 * s["d"] * s["f"]
