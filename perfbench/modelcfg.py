"""A configuration file -> the program's ``ModelConfig`` and the plain
dict of sizes the reference reads.

The file holds the source's own keys (its ``config.json``), ``reduced``
(the keys changed from it), ``port`` (what the port needs beside them:
its registered architecture, layer pattern, dtypes, the MoE's capacity
rule), and the deployment's settings under ``serve`` and ``train``."""

from __future__ import annotations

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
