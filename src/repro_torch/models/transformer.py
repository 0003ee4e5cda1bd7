"""Backbone assembly for attention-only stacks: the port of
``repro.models.transformer``.

Parameters are a dict tree like the JAX package's, except that
``params["blocks"]`` is a *list* with one superblock dict per repeat
(the JAX tree stacks them along a leading axis for ``lax.scan``; here the
repeat loop is a Python loop). The decode state keeps the JAX layout
exactly: leaves under ``"blocks"`` are stacked ``[repeats, ...]`` (batch
on axis 1, or the page pool on axis 1 in paged mode) and ``"tail"``
leaves are batch-leading, so a state converts leaf by leaf through numpy.
Repeat ``r`` of the stack reads and writes its own view ``leaf[r]`` in
place.

Blocks of kind RGLRU, MAMBA or XATTN, and experts, are not ported yet and
raise ``NotImplementedError`` naming the ROADMAP.md queue item that ports
them.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.models import attention, layers
from repro_torch.models.config import (ATTN, LOCAL, MAMBA, RGLRU, SWA, XATTN,
                                       ModelConfig)

_ATTN_KINDS = (ATTN, SWA, LOCAL)


def check_supported(cfg: ModelConfig) -> None:
    """Raise for what this slice of the port does not run yet."""
    kinds = set(cfg.pattern) | set(cfg.remainder)
    if kinds & {RGLRU, MAMBA}:
        raise NotImplementedError(
            f"{cfg.name}: RG-LRU / Mamba blocks are not ported yet — "
            "ROADMAP.md queue item Q2 (recurrent families with K4/K5)")
    if XATTN in kinds or cfg.num_experts or cfg.conv_pos:
        raise NotImplementedError(
            f"{cfg.name}: cross-attention, experts and audio frontends are "
            "not ported yet — ROADMAP.md queue item Q5 (MoE, VLM and audio)")
    if kinds - set(_ATTN_KINDS):
        raise ValueError(f"unknown block kinds {sorted(kinds)}")


def _layers(cfg: ModelConfig):
    """(group, repeat or None, index, kind) for every block in order."""
    for r in range(cfg.num_repeats):
        for i, kind in enumerate(cfg.pattern):
            yield "blocks", r, str(i), kind
    for i, kind in enumerate(cfg.remainder):
        yield "tail", None, str(i), kind


def _block_params(params: dict, group: str, r: Optional[int], i: str):
    return params[group][r][i] if group == "blocks" else params[group][i]


def _leaf_view(state: dict, group: str, r: Optional[int], i: str) -> dict:
    s = state[group][i]
    return {k: v[r] for k, v in s.items()} if group == "blocks" else s


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_block(cfg: ModelConfig, kind: str, gen, device, dtype) -> dict:
    return {"norm": layers.init_norm(cfg, device),
            "attn": attention.init_attention(cfg, gen, device, dtype),
            "mlp_norm": layers.init_norm(cfg, device),
            "mlp": layers.init_mlp(cfg, gen, device, dtype)}


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda",
                dtype=None) -> dict:
    """Seeded random weights, drawn on ``device`` from a
    ``torch.Generator`` (not the JAX stream: to compare with the JAX
    package, convert its tree with ``models.convert.params_from_numpy``).
    Matrices are stored in ``dtype`` (default: the compute dtype)."""
    check_supported(cfg)
    device = torch.device(device)
    dtype = layers.to_dtype(dtype or cfg.compute_dtype)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    params: dict[str, Any] = {
        "embed": layers.init_embed(cfg, gen, device, dtype)}
    if cfg.num_repeats:
        params["blocks"] = [
            {str(i): _init_block(cfg, kind, gen, device, dtype)
             for i, kind in enumerate(cfg.pattern)}
            for _ in range(cfg.num_repeats)]
    if cfg.remainder:
        params["tail"] = {str(i): _init_block(cfg, kind, gen, device, dtype)
                          for i, kind in enumerate(cfg.remainder)}
    params["final_norm"] = layers.init_norm(cfg, device)
    return params


def params_device(params: dict) -> torch.device:
    return params["embed"]["tokens"].device


# ---------------------------------------------------------------------------
# Full sequence (train-style forward / prefill)
# ---------------------------------------------------------------------------

def _mlp_half(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    h = layers.apply_norm(cfg, p["mlp_norm"], x)
    return x + layers.apply_mlp(cfg, p["mlp"], h)


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)


def forward(cfg: ModelConfig, params: dict, *,
            tokens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward. Returns (hidden [B,S,D], aux_loss)."""
    check_supported(cfg)
    x = layers.embed_tokens(cfg, params["embed"], tokens)
    B, S = x.shape[:2]
    positions = _positions(B, S, x.device)
    for group, r, i, kind in _layers(cfg):
        p = _block_params(params, group, r, i)
        h = layers.apply_norm(cfg, p["norm"], x)
        x = x + attention.self_attention(cfg, p["attn"], h, positions, kind)
        x = _mlp_half(cfg, p, x)
    x = layers.apply_norm(cfg, params["final_norm"], x)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def logits_from_hidden(cfg: ModelConfig, params: dict,
                       x: torch.Tensor) -> torch.Tensor:
    return layers.lm_logits(cfg, params["embed"], x)


def prefill(cfg: ModelConfig, params: dict, *, tokens: torch.Tensor,
            context_len: Optional[int] = None,
            cache_dtype=torch.bfloat16):
    """Full-sequence forward that also builds the decode state.

    Returns (logits [B,S,V], decode_state positioned at t = S).
    """
    check_supported(cfg)
    x = layers.embed_tokens(cfg, params["embed"], tokens)
    B, S = x.shape[:2]
    context_len = context_len or S
    positions = _positions(B, S, x.device)
    caches: dict[tuple, dict] = {}
    for group, r, i, kind in _layers(cfg):
        p = _block_params(params, group, r, i)
        h = layers.apply_norm(cfg, p["norm"], x)
        h, (k, v) = attention.self_attention(cfg, p["attn"], h, positions,
                                             kind, return_kv=True)
        caches[group, r, i] = attention.build_cache_from_full(
            cfg, k, v, context_len, kind, cache_dtype)
        x = _mlp_half(cfg, p, x + h)
    x = layers.apply_norm(cfg, params["final_norm"], x)
    logits = layers.lm_logits(cfg, params["embed"], x)
    return logits, _assemble_state(cfg, caches)


def _assemble_state(cfg: ModelConfig, caches: dict) -> dict:
    state: dict[str, Any] = {}
    if cfg.num_repeats:
        state["blocks"] = {
            str(i): {leaf: torch.stack([caches["blocks", r, str(i)][leaf]
                                        for r in range(cfg.num_repeats)])
                     for leaf in ("k", "v")}
            for i in range(len(cfg.pattern))}
    if cfg.remainder:
        state["tail"] = {str(i): caches["tail", None, str(i)]
                         for i in range(len(cfg.remainder))}
    return state


# ---------------------------------------------------------------------------
# Decode state
# ---------------------------------------------------------------------------

def init_decode_state(cfg: ModelConfig, batch: int, context_len: int,
                      dtype=torch.bfloat16, page_size: Optional[int] = None,
                      num_pages: Optional[int] = None,
                      device="cuda") -> dict:
    """Zeroed decode state in the JAX package's layout.

    With ``page_size``/``num_pages`` set, full-context ATTN layers hold
    one shared ``[num_pages, page_size, KV, dh]`` pool addressed through a
    per-row page table instead of per-row ``[batch, L]`` rings; windowed
    rings stay per-row.
    """
    check_supported(cfg)

    def shape(kind: str) -> tuple:
        if kind == ATTN and page_size is not None:
            return attention.paged_kv_cache_shape(cfg, num_pages, page_size)
        return attention.kv_cache_shape(cfg, batch, context_len, kind)

    def zeros(shp):
        return torch.zeros(shp, dtype=dtype, device=device)

    state: dict[str, Any] = {}
    if cfg.num_repeats:
        state["blocks"] = {
            str(i): {leaf: zeros((cfg.num_repeats,) + shape(kind))
                     for leaf in ("k", "v")}
            for i, kind in enumerate(cfg.pattern)}
    if cfg.remainder:
        state["tail"] = {str(i): {leaf: zeros(shape(kind))
                                  for leaf in ("k", "v")}
                         for i, kind in enumerate(cfg.remainder)}
    return state


def _kinds(cfg: ModelConfig, group: str):
    return cfg.pattern if group == "blocks" else cfg.remainder


def _groups(state: dict):
    """(group, batch/page axis) of each group present in ``state``."""
    return [(g, 1 if g == "blocks" else 0) for g in ("blocks", "tail")
            if g in state]


def write_decode_slot(cfg: ModelConfig, state: dict, slot_state: dict,
                      index: int) -> dict:
    """Write a batch-1 decode-state tree into row ``index`` of a batched
    one, in place (leaves under "blocks" carry the repeat dim first, so
    batch is axis 1; "tail" leaves are batch-leading)."""
    for group, axis in _groups(state):
        for i in state[group]:
            for leaf, dst in state[group][i].items():
                src = slot_state[group][i][leaf]
                dst.select(axis, int(index)).copy_(src.select(axis, 0))
    return state


def _paged_leaf_write(dst: torch.Tensor, src: torch.Tensor,
                      row_pages: torch.Tensor, start_page: int,
                      page_size: int, page_axis: int) -> None:
    """Scatter a B=1 flat cache leaf into the shared page pool, skipping
    the ``start_page`` leading *shared* (copy-on-write prefix) pages."""
    n_log = row_pages.shape[0]
    seq_axis = page_axis + 1
    shape = (src.shape[:page_axis] + (n_log, page_size)
             + src.shape[seq_axis + 1:])
    sp = src.reshape(shape).to(dst.dtype)          # batch-1 axis -> pages
    owned = row_pages[start_page:].long()
    if page_axis == 0:
        dst[owned] = sp[start_page:]
    else:
        dst[:, owned] = sp[:, start_page:]         # stacked repeat leads


def write_paged_slot(cfg: ModelConfig, state: dict, slot_state: dict,
                     index: int, row_pages: torch.Tensor, start_page: int,
                     page_size: int) -> dict:
    """Paged counterpart of ``write_decode_slot``: land a B=1 prefill
    state into row ``index``, scattering full-context ATTN leaves into the
    shared pool through ``row_pages`` ([n_log] int32, trash page 0 past
    the reservation) and skipping the ``start_page`` shared prefix pages,
    which already hold exactly this content. Other leaves write per row.

    Logical pages past the reservation all point at the trash page; their
    writes land there (undefined winner, read by nobody), as in the JAX
    package.
    """
    start_page = int(start_page)
    for group, axis in _groups(state):
        for i, kind in enumerate(_kinds(cfg, group)):
            dst_leaves = state[group][str(i)]
            src_leaves = slot_state[group][str(i)]
            for leaf, dst in dst_leaves.items():
                src = src_leaves[leaf]
                if kind == ATTN:
                    _paged_leaf_write(dst, src, row_pages, start_page,
                                      page_size, axis)
                else:
                    dst.select(axis, int(index)).copy_(src.select(axis, 0))
    return state


def gather_paged_slot(cfg: ModelConfig, state: dict, index: int,
                      row_pages: torch.Tensor, page_size: int) -> dict:
    """Row ``index`` of a paged decode state as a new B=1 *flat* state
    (what ``prefill_extend`` consumes): ATTN leaves gather the row's page
    list into its logical [1, n_log*page_size] view; other leaves copy
    the row."""
    n_log = row_pages.shape[0]
    idx = row_pages.long()
    out: dict[str, Any] = {}
    for group, axis in _groups(state):
        out[group] = {}
        for i, kind in enumerate(_kinds(cfg, group)):
            leaves = {}
            for leaf, pool in state[group][str(i)].items():
                if kind == ATTN:
                    g = pool.index_select(axis, idx)
                    leaves[leaf] = g.reshape(pool.shape[:axis]
                                             + (1, n_log * page_size)
                                             + pool.shape[axis + 2:])
                else:
                    leaves[leaf] = pool.narrow(axis, int(index), 1).clone()
            out[group][str(i)] = leaves
    return out


def paged_window_view(cfg: ModelConfig, state: dict,
                      pages: torch.Tensor) -> dict:
    """Gather a paged decode state into the equivalent flat per-row view
    (ATTN pool leaves -> ``[..., B, n_log*ps, KV, dh]`` copies by walking
    each row's page list); other leaves pass through. Done once per fused
    window, instead of walking the pool in every step."""
    B, n_log = pages.shape
    idx = pages.long().reshape(-1)
    out: dict[str, Any] = {}
    for group, axis in _groups(state):
        out[group] = {}
        for i, kind in enumerate(_kinds(cfg, group)):
            leaves = state[group][str(i)]
            if kind != ATTN:
                out[group][str(i)] = leaves
                continue
            out[group][str(i)] = {
                leaf: pool.index_select(axis, idx).reshape(
                    pool.shape[:axis] + (B, n_log * pool.shape[axis + 1])
                    + pool.shape[axis + 2:])
                for leaf, pool in leaves.items()}
    return out


def paged_window_scatter(cfg: ModelConfig, state: dict, flat: dict,
                         pages: torch.Tensor, t0, steps: int) -> dict:
    """Inverse of ``paged_window_view`` after a ``steps``-long window:
    only the ``1 + ceil((steps-1)/ps)`` logical pages per row that the
    window's positions can reach scatter back into the pool (in place);
    pages the window did not actually write get identity writes, which
    keeps shared copy-on-write prefix pages intact. Non-ATTN leaves come
    from the flat tree."""
    B, n_log = pages.shape
    t0 = torch.as_tensor(t0, device=pages.device).to(torch.int32)
    if t0.dim() == 0:
        t0 = t0.expand(B)
    for group, axis in _groups(state):
        for i, kind in enumerate(_kinds(cfg, group)):
            if kind != ATTN:
                state[group][str(i)] = flat[group][str(i)]
                continue
            for leaf, pool in state[group][str(i)].items():
                fl = flat[group][str(i)][leaf]
                ps = pool.shape[axis + 1]
                L = n_log * ps
                ntouch = min(n_log, 1 + (max(steps - 1, 0) + ps - 1) // ps)
                j0 = torch.div(torch.remainder(t0, L), ps,
                               rounding_mode="floor")
                jj = torch.remainder(
                    j0[:, None] + torch.arange(ntouch, dtype=torch.int32,
                                               device=pages.device)[None],
                    n_log).long()                              # [B, C]
                pid = torch.gather(pages.long(), 1, jj)        # [B, C]
                fr = fl.reshape(fl.shape[:axis] + (B, n_log, ps)
                                + fl.shape[axis + 2:])
                bb = torch.arange(B, device=pages.device)[:, None]
                if axis == 0:
                    pool[pid] = fr[bb, jj].to(pool.dtype)
                else:
                    pool[:, pid] = fr[:, bb, jj].to(pool.dtype)
    return state


# ---------------------------------------------------------------------------
# Decode: single-token step with per-layer state
# ---------------------------------------------------------------------------

def decode_step(cfg: ModelConfig, params: dict, state: dict,
                tokens: torch.Tensor, t, attn_impl: str = "auto",
                pages: Optional[torch.Tensor] = None):
    """One decode step. tokens [B,1]; ``t`` = absolute position, a scalar
    or a ``[B]`` vector. ``attn_impl`` ("auto" | "dense" | "flash") picks
    the attention leaf of every ATTN/SWA/LOCAL block. With ``pages``
    ([B, n_log] int32), full-context ATTN layers read their state as the
    shared page pool. The state is updated in place and returned.
    Returns (logits [B,1,V], state).
    """
    x = layers.embed_tokens(cfg, params["embed"], tokens)
    for group, r, i, kind in _layers(cfg):
        p = _block_params(params, group, r, i)
        cache = _leaf_view(state, group, r, i)
        h = layers.apply_norm(cfg, p["norm"], x)
        if kind == ATTN and pages is not None:
            h, _ = attention.paged_decode_attention(cfg, p["attn"], h, cache,
                                                    t, pages, impl=attn_impl)
        else:
            h, _ = attention.decode_attention(cfg, p["attn"], h, cache, t,
                                              kind, impl=attn_impl)
        x = _mlp_half(cfg, p, x + h)
    x = layers.apply_norm(cfg, params["final_norm"], x)
    return layers.lm_logits(cfg, params["embed"], x), state


# ---------------------------------------------------------------------------
# Chunked prefill: extend a decode state by a block of prompt tokens
# ---------------------------------------------------------------------------

def prefill_extend(cfg: ModelConfig, params: dict, state: dict,
                   tokens: torch.Tensor, t0):
    """Advance a (flat) decode state, in place, by a chunk of ``C``
    prompt tokens at positions ``t0 .. t0+C-1``. Returns (last-position
    logits [B,1,V], state positioned at ``t0 + C``)."""
    x = layers.embed_tokens(cfg, params["embed"], tokens)
    for group, r, i, kind in _layers(cfg):
        p = _block_params(params, group, r, i)
        cache = _leaf_view(state, group, r, i)
        h = layers.apply_norm(cfg, p["norm"], x)
        h, _ = attention.extend_attention(cfg, p["attn"], h, cache, t0, kind)
        x = _mlp_half(cfg, p, x + h)
    x = layers.apply_norm(cfg, params["final_norm"], x[:, -1:])
    return layers.lm_logits(cfg, params["embed"], x), state
