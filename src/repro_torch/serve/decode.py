"""Serving steps: prefill and single-token decode with greedy/temperature
sampling — the port of ``repro.serve.decode``.

PyTorch runs eagerly, so there is no executable cache: the K-step decode
window is a Python loop whose feed tokens and positions stay device
tensors, and the host syncs once per window (on the token block). CUDA
graphs for the window are later work.

Randomness comes from an explicit ``torch.Generator``. Greedy decoding
(temperature 0) is exact across frameworks; sampled tokens cannot match
``jax.random`` and are tested for sync invariance and distribution.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig


def make_sampler(temperature: float = 0.0, top_k: Optional[int] = None):
    """(logits [B,1,V], generator?) -> tokens [B,1] int32.

    temperature == 0 (or no generator) is exact argmax; otherwise
    gumbel-max sampling with noise drawn from the generator, optionally
    truncated to the ``top_k`` highest logits.
    """
    temperature = float(temperature)

    def sample(logits: torch.Tensor,
               gen: Optional[torch.Generator] = None) -> torch.Tensor:
        if temperature <= 0.0 or gen is None:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        x = logits.float()
        if top_k is not None:
            kth = torch.topk(x, top_k, dim=-1).values[..., -1:]
            x = x.masked_fill(x < kth, float("-inf"))
        u = torch.rand(x.shape, generator=gen, device=x.device)
        u = u.clamp_(min=torch.finfo(torch.float32).tiny)
        noise = -torch.log(-torch.log(u))
        return torch.argmax(x / temperature + noise, dim=-1).to(torch.int32)

    return sample


def make_serve_step(cfg: ModelConfig, temperature: float = 0.0,
                    top_k: Optional[int] = None, attn_impl: str = "auto"):
    """(params, state, tokens [B,1], t, gen?) -> (next_tokens [B,1],
    state)."""
    sampler = make_sampler(temperature, top_k)

    def serve_step(params, state, tokens, t, gen=None):
        logits, state = transformer.decode_step(cfg, params, state, tokens,
                                                t, attn_impl=attn_impl)
        return sampler(logits, gen), state

    return serve_step


def make_fused_serve_step(cfg: ModelConfig, steps: int,
                          temperature: float = 0.0,
                          top_k: Optional[int] = None,
                          attn_impl: str = "auto"):
    """``steps`` decode+sample iterations per host sync.

    (params, state, tokens [B,1], t [B], gen?, pages?) ->
        (token_block [B,steps], state, next_tokens [B,1], t + steps, gen)

    Tokens and positions stay on the device through the window; the
    caller syncs once, on the token block. With ``pages`` (paged KV),
    a multi-step window gathers the pool into the equivalent flat per-row
    view once, runs the flat step, and scatters the pages the window
    touched back at the end; a K=1 window decodes against the pool
    directly (the paged flash-decode kernel's path).
    """
    sampler = make_sampler(temperature, top_k)

    def fused(params, state, tokens, t, gen=None, pages=None):
        use_view = pages is not None and steps > 1
        pool_state, t0 = state, t
        if use_view:
            state = transformer.paged_window_view(cfg, state, pages)
        step_pages = None if use_view else pages
        toks = []
        tok = tokens
        for _ in range(steps):
            logits, state = transformer.decode_step(
                cfg, params, state, tok, t, attn_impl=attn_impl,
                pages=step_pages)
            tok = sampler(logits, gen)
            toks.append(tok[:, 0])
            t = t + 1
        if use_view:
            state = transformer.paged_window_scatter(cfg, pool_state, state,
                                                     pages, t0, steps)
        return torch.stack(toks, dim=1), state, tok, t, gen

    return fused


def make_prefill(cfg: ModelConfig, context_len: Optional[int] = None):
    def prefill_step(params, tokens):
        return transformer.prefill(cfg, params, tokens=tokens,
                                   context_len=context_len)
    return prefill_step


_MASKABLE = {"attn", "swa", "local", "xattn"}


def _check_ragged_supported(cfg: ModelConfig, S: int, context_len: int):
    kinds = set(cfg.pattern) | set(cfg.remainder)
    if kinds - _MASKABLE:
        raise ValueError(
            f"ragged generate (lengths=...) needs an attention-only stack; "
            f"{cfg.name} has {sorted(kinds - _MASKABLE)} blocks whose "
            "recurrent state would absorb the pad tokens. Serve those "
            "architectures through the engine (exact-length prefill) or "
            "with equal-length prompts.")
    if context_len < S or (cfg.window is not None and cfg.window < S):
        raise ValueError(
            f"ragged generate needs the KV ring (context_len={context_len}, "
            f"window={cfg.window}) to hold the padded prompt (S={S}): a "
            "shorter ring wraps pad K/V onto slots the position mask "
            "treats as valid history.")


def generate(cfg: ModelConfig, params, prompt: torch.Tensor, max_new: int,
             context_len: Optional[int] = None, temperature: float = 0.0,
             gen: Optional[torch.Generator] = None,
             lengths=None, top_k: Optional[int] = None,
             attn_impl: str = "auto") -> torch.Tensor:
    """Prefill + decode: prompt [B, S] -> tokens [B, S + max_new] (int32,
    on the prompt's device).

    ``lengths`` ([B], optional) marks the true length of each
    right-padded row: row ``b`` continues from its own last real token at
    positions ``lengths[b] + i`` and its tokens land at
    ``out[b, lengths[b]:lengths[b]+max_new]``; the tail keeps the pad.
    """
    B, S = prompt.shape
    device = prompt.device
    context_len = context_len or (S + max_new)
    if lengths is not None and bool((np.asarray(lengths) == S).all()):
        lengths = None          # nothing is padded: every stack serves this
    if lengths is not None:
        _check_ragged_supported(cfg, S, context_len)
        t0 = torch.as_tensor(np.asarray(lengths), device=device).to(
            torch.int32)
    else:
        t0 = torch.full((B,), S, dtype=torch.int32, device=device)
    logits, state = transformer.prefill(cfg, params, tokens=prompt,
                                        context_len=context_len)
    rows = torch.arange(B, device=device)
    last_logits = logits[rows, (t0 - 1).long()][:, None]
    sampler = make_sampler(temperature, top_k)
    tok = sampler(last_logits, gen)
    step = make_serve_step(cfg, temperature, top_k, attn_impl)
    out_toks = [tok]
    for i in range(max_new - 1):
        tok, state = step(params, state, tok, t0 + i, gen)
        out_toks.append(tok)
    gen_block = torch.cat(out_toks, dim=1)                    # [B, max_new]
    out = torch.zeros((B, S + max_new), dtype=torch.int32, device=device)
    out[:, :S] = prompt.to(torch.int32)
    cols = (t0[:, None] + torch.arange(max_new, device=device)[None]).long()
    out[rows[:, None], cols] = gen_block
    return out
