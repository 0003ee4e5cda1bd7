"""Backbone assembly for every block kind of the JAX package (attention,
cross-attention, RG-LRU, Mamba; dense or MoE MLPs): the port of
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

RG-LRU blocks keep fp32 ``{"h": [B, W], "conv": [B, K-1, W]}`` state,
per row, and Mamba blocks fp32 ``{"h": [B, Di, N], "conv": [B, K-1,
Di]}``; a Mamba block has no MLP half, as in the JAX package. XATTN
blocks keep ``{"k_mem", "v_mem": [B, T, KV, dh]}``, the frontend memory's
K/V projected once by the prefill (``memory=``), in the cache dtype. With
``cfg.num_experts`` every MLP half is the MoE of ``models.moe``, and
``forward`` returns the sum of its auxiliary losses. Audio encoders take
``embeddings=`` in place of tokens and add the conv positional embedding.

The JAX package's ``shard`` constraints sit where it has them: the
residual stream after every block of a full-sequence forward (and at
superblock boundaries, feature-sharded with ``resid_tp``), the embedded
input of every entry point and the logits it returns. Without a sharding
context they are no-ops. Positions are ``[1, S]`` and broadcast over the
batch (the JAX package broadcasts them to ``[B, S]``): the same numbers,
and under a mesh a plain tensor that no batch shard has to hold.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.utils.checkpoint
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.kernels import _shards
from repro_torch.models import attention, layers, moe, rglru, ssm
from repro_torch.models.config import (ATTN, LOCAL, MAMBA, RGLRU, SWA, XATTN,
                                       ModelConfig)
from repro_torch.sharding import shard

_ATTN_KINDS = (ATTN, SWA, LOCAL)
_RECURRENT_KINDS = (RGLRU, MAMBA)


def block_kinds(cfg: ModelConfig) -> set[str]:
    """The kinds of block the stack holds."""
    return set(cfg.pattern) | set(cfg.remainder)


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a block kind the port does not know."""
    kinds = block_kinds(cfg)
    if kinds - set(_ATTN_KINDS) - set(_RECURRENT_KINDS) - {XATTN}:
        raise ValueError(f"unknown block kinds {sorted(kinds)}")


def _memory(cfg: ModelConfig, memory: Optional[torch.Tensor],
            x: torch.Tensor) -> Optional[torch.Tensor]:
    """The frontend memory in x's dtype; a stack with cross-attention
    blocks cannot run without it."""
    if memory is None:
        if XATTN in block_kinds(cfg):
            raise ValueError(f"{cfg.name} has cross-attention blocks: pass "
                             "memory= (frontend embeddings [B, T, D])")
        return None
    return memory.to(x.dtype)


def _embed(cfg: ModelConfig, params: dict, tokens, embeddings):
    """Token embeddings, or the audio frontend's frame embeddings in the
    compute dtype; then the conv positional embedding where the config
    has one."""
    if embeddings is not None:
        x = embeddings.to(layers.cdtype(cfg))
    else:
        x = layers.embed_tokens(cfg, params["embed"], tokens)
    return layers.add_conv_pos(cfg, params["embed"], x)


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
    p = {"norm": layers.init_norm(cfg, device)}
    if kind == MAMBA:                   # no MLP half
        p["mamba"] = ssm.init_mamba_block(cfg, gen, device, dtype)
        return p
    if kind == RGLRU:
        p["rglru"] = rglru.init_rglru_block(cfg, gen, device, dtype)
    else:
        p["attn"] = attention.init_attention(cfg, gen, device, dtype)
    p["mlp_norm"] = layers.init_norm(cfg, device)
    if cfg.num_experts:
        p["mlp"] = moe.init_moe(cfg, gen, device, dtype)
    else:
        p["mlp"] = layers.init_mlp(cfg, gen, device, dtype)
    return p


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda",
                dtype=None) -> dict:
    """Seeded random weights, drawn on ``device`` from a
    ``torch.Generator`` (not the JAX stream: to compare with the JAX
    package, convert its tree with ``models.convert.params_from_numpy``).
    Matrices are stored in ``dtype`` (default: the compute dtype)."""
    check_supported(cfg)
    device = torch.device(device)
    dtype = layers.to_dtype(dtype or cfg.compute_dtype)
    # Meta tensors (``param_shapes``) draw nothing; a CPU generator
    # stands in for the meta device, which has none.
    gen = torch.Generator(device="cpu" if device.type == "meta" else device
                          ).manual_seed(int(seed))
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


def param_shapes(cfg: ModelConfig) -> dict:
    """The parameter tree as meta tensors (no allocation), with the JAX
    package's ``param_shapes`` leaves' shapes and dtypes (all
    ``cfg.param_dtype``), ``blocks`` a list of per-repeat dicts."""
    return init_params(cfg, 0, device="meta", dtype=cfg.param_dtype)


def params_device(params: dict) -> torch.device:
    return params["embed"]["tokens"].device


# ---------------------------------------------------------------------------
# Full sequence (train-style forward / prefill)
# ---------------------------------------------------------------------------

def _mlp_half(cfg: ModelConfig, kind: str, p: dict, x: torch.Tensor):
    """(x + MLP(norm(x)), the MoE's aux loss or None, the rows each held
    expert computed [H] or None: ``_Block``)."""
    if kind == MAMBA:                   # the Mamba block subsumes the MLP
        return x, None, None
    h = layers.apply_norm(cfg, p["mlp_norm"], x)
    if cfg.moe_dropless:
        h, aux, rows = moe.apply_dropless(cfg, p["mlp"], h)
        return x + h, aux, rows
    if cfg.num_experts:
        h, aux = moe.apply_moe(cfg, p["mlp"], h)
        return x + h, aux, None
    return x + layers.apply_mlp(cfg, p["mlp"], h), None, None


def _positions(S: int, device) -> torch.Tensor:
    """[1, S]: broadcast over the batch."""
    return torch.arange(S, dtype=torch.int32, device=device)[None]


def _apply_block(cfg: ModelConfig, kind: str, p: dict, x: torch.Tensor,
                 positions: torch.Tensor, memory: Optional[torch.Tensor],
                 impl: str):
    """One block over the full sequence: (x, the MoE's aux loss or None,
    its held experts' rows or None)."""
    h = layers.apply_norm(cfg, p["norm"], x)
    if kind == RGLRU:
        h, _ = rglru.apply_rglru_block(cfg, p["rglru"], h, impl=impl)
    elif kind == MAMBA:
        h, _ = ssm.apply_mamba_block(cfg, p["mamba"], h, impl=impl)
    elif kind == XATTN:
        h = attention.cross_attention(cfg, p["attn"], h, memory, impl=impl)
    else:
        h = attention.self_attention(cfg, p["attn"], h, positions, kind,
                                     impl=impl)
    return _residual(cfg, kind, p, x, h)


def _residual(cfg: ModelConfig, kind: str, p: dict, x: torch.Tensor,
              h: torch.Tensor):
    """x + h, then the MLP half: (x, the MoE's aux loss or None, the held
    experts' rows or None), the residual stream batch-sharded after each
    add (the JAX package's constraints in ``_apply_block``; here in every
    entry point's blocks, since DTensor otherwise may leave the stream
    sharded over its sequence)."""
    x, aux, rows = _mlp_half(cfg, kind, p, shard(x + h, "dp", None, None))
    return shard(x, "dp", None, None), aux, rows


def forward(cfg: ModelConfig, params: dict, *,
            tokens: Optional[torch.Tensor] = None,
            embeddings: Optional[torch.Tensor] = None,
            memory: Optional[torch.Tensor] = None,
            remat: bool = False,
            impl: str = "auto",
            resid_tp: bool = False,
            stats: Optional[dict] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward over ``tokens`` [B,S] or frame
    ``embeddings`` [B,S,D] (audio), with frontend ``memory`` [B,T,D] for
    cross-attention blocks. Returns (hidden [B,S,D], aux_loss: the sum of
    the MoE layers' load-balance losses, fp32, 0 without experts).
    ``impl`` picks the attention and scan route (see ``prefill``;
    ``"train"``, the gradient pass's, is ``models.attention``'s).

    ``remat=True`` recomputes each block in the backward pass instead of
    keeping its activations (``torch.utils.checkpoint``; the JAX
    package's ``jax.checkpoint`` with ``nothing_saveable``, which it
    applies to a superblock): only the residual stream between blocks is
    saved, so the backward pass rebuilds one block at a time, not a
    whole period of the pattern. The ``tail`` blocks are not recomputed,
    as in the JAX package. Nothing in a block draws random numbers, so no
    RNG state is kept for the recomputation.

    With ``stats`` (a dict), a stack of dropless expert layers puts
    there ``moe_rows`` [layers, H] fp32: the rows each held expert of
    each layer computed.

    ``resid_tp`` feature-shards the residual stream at superblock
    boundaries under a sharding context (FSDP+SP): the tensors remat
    saves shrink by the TP width at the cost of per-layer feature
    all-gathers. Without a context it changes nothing."""
    check_supported(cfg)
    x = _embed(cfg, params, tokens, embeddings)
    resid_spec = ("dp", None, "tp") if resid_tp else ("dp", None, None)
    x = shard(x, *resid_spec)
    memory = _memory(cfg, memory, x)
    S = x.shape[1]
    positions = _positions(S, x.device)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    rows = []
    for blk in params.get("blocks", []):
        for i, kind in enumerate(cfg.pattern):
            args = (cfg, kind, blk[str(i)], x, positions, memory, impl)
            if remat:
                x, a, r = torch.utils.checkpoint.checkpoint(
                    _apply_block, *args, use_reentrant=False,
                    preserve_rng_state=False)
            else:
                x, a, r = _apply_block(*args)
            if a is not None:
                aux_total = aux_total + a
            if r is not None:
                rows.append(r)
        x = shard(x, *resid_spec)
    for i, kind in enumerate(cfg.remainder):
        x, a, r = _apply_block(cfg, kind, params["tail"][str(i)], x,
                               positions, memory, impl)
        if a is not None:
            aux_total = aux_total + a
        if r is not None:
            rows.append(r)
    if stats is not None and rows:
        stats["moe_rows"] = torch.stack(rows)
    x = layers.apply_norm(cfg, params["final_norm"], x)
    return x, aux_total


def logits_from_hidden(cfg: ModelConfig, params: dict,
                       x: torch.Tensor) -> torch.Tensor:
    logits = layers.lm_logits(cfg, params["embed"], x)
    return shard(logits, "dp", None, "tp")


def cross_entropy(cfg: ModelConfig, logits: torch.Tensor,
                  labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token NLL in fp32 (over ``mask``'s ones where given).

    The true logit is gathered by index. The JAX package contracts the
    logits with a one-hot of the labels, whose every other term is an
    exact zero, so the number is the same; the one-hot would be a
    [B, S, V] tensor (2.5 GB at Qwen2's vocabulary of 151936 for a
    4 x 1024 microbatch)."""
    logits = logits.float()
    if isinstance(logits, DTensor) and any(
            isinstance(p, Shard) and p.dim == logits.dim() - 1
            for p in logits.placements):
        lse, true_logit = _lse_and_true_logit_sharded(logits, labels)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        true_logit = torch.gather(logits, -1,
                                  labels.long()[..., None])[..., 0]
    nll = lse - true_logit
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


class _ShardedLogSumExp(torch.autograd.Function):
    """logsumexp over the last dim of a DTensor whose last dim is sharded:
    the shards' maxima and exponential sums reduce to [..., 1], and the
    gradient is the softmax, formed shard by shard. (Left to itself,
    DTensor's backward of the same expression gathers the whole
    tensor.)"""

    @staticmethod
    def forward(ctx, x):
        m = x.amax(-1, keepdim=True)
        lse = m + torch.log(torch.exp(x - m).sum(-1, keepdim=True))
        ctx.save_for_backward(x, lse)
        return lse[..., 0]

    @staticmethod
    def backward(ctx, g):
        x, lse = ctx.saved_tensors
        return g[..., None] * torch.exp(x - lse)


def _lse_and_true_logit_sharded(logits, labels):
    """``cross_entropy``'s two reductions over vocab-sharded DTensor
    logits, each vocab shard working on its own columns (the JAX
    package's one-hot contraction does the same under XLA): the
    log-sum-exp from the shards' maxima and exponential sums, and the
    true logit as a masked local gather whose shards are summed. Neither
    gathers the [B, S, V] logits."""
    lse = _ShardedLogSumExp.apply(logits)
    mesh, last = logits.device_mesh, logits.dim() - 1
    vocab = [i for i, p in enumerate(logits.placements)
             if isinstance(p, Shard) and p.dim == last]
    lab_pl = tuple(Replicate() if i in vocab else p
                   for i, p in enumerate(logits.placements))
    out_pl = tuple(Partial() if i in vocab else p
                   for i, p in enumerate(lab_pl))

    def local(lg, lb):
        coord = mesh.get_coordinate()
        shard_idx = 0
        for i in vocab:
            shard_idx = shard_idx * mesh.size(i) + coord[i]
        v = lg.shape[-1]
        idx = lb - shard_idx * v
        ok = (idx >= 0) & (idx < v)
        got = torch.gather(lg, -1, idx.clamp(0, v - 1)[..., None])[..., 0]
        return torch.where(ok, got, torch.zeros_like(got))

    true_logit = _shards.on_shards(local, (logits, labels.long()),
                                   (tuple(logits.placements), lab_pl),
                                   out_pl)
    return lse, true_logit


def loss_fn(cfg: ModelConfig, params: dict, batch: dict,
            remat: bool = False, impl: str = "auto",
            resid_tp: bool = False) -> tuple[torch.Tensor, dict]:
    """Language-model / masked-prediction loss over one (micro)batch of
    tensors: ``tokens`` and ``labels`` (causal: the next token within
    the sequence, optionally under ``mask``), or HuBERT's frame
    ``embeddings`` with per-frame ``targets`` at ``mask``; plus
    ``image_embeds`` for cross-attention stacks. The MoE aux loss is
    added. ``impl`` reaches ``forward``: training passes "train", the
    route with a backward pass (the flash attention's kernels where they
    take the input, else dense; the scans' plain route), since the
    inference kernels have none. ``resid_tp`` reaches ``forward``.
    A stack of dropless expert layers also reports ``moe_rows``, the rows
    each held expert of each layer computed (``forward``'s ``stats``)."""
    stats: dict = {}
    hidden, aux = forward(
        cfg, params,
        tokens=batch.get("tokens"),
        embeddings=batch.get("embeddings"),
        memory=batch.get("image_embeds"),
        remat=remat, impl=impl, resid_tp=resid_tp, stats=stats)
    logits = logits_from_hidden(cfg, params, hidden)
    mask = batch.get("mask")
    if cfg.causal and "targets" not in batch:
        # Next-token prediction: shift within the provided sequence.
        ce = cross_entropy(cfg, logits[:, :-1], batch["labels"][:, 1:],
                           mask[:, 1:] if mask is not None else None)
    else:
        # Encoder (HuBERT): predict per-position targets at masked frames.
        ce = cross_entropy(cfg, logits, batch["targets"], mask)
    return ce + aux, {"ce": ce, "aux": aux, **stats}


def prefill(cfg: ModelConfig, params: dict, *,
            tokens: Optional[torch.Tensor] = None,
            memory: Optional[torch.Tensor] = None,
            embeddings: Optional[torch.Tensor] = None,
            context_len: Optional[int] = None,
            cache_dtype=torch.bfloat16, impl: str = "auto"):
    """Full-sequence forward that also builds the decode state.

    ``impl`` ("auto" | "dense" | "flash") picks the route of every
    attention block (the flash-attention kernel or the dense einsum) and
    every RG-LRU and selective scan (the scan kernel or the plain loop);
    "auto" means the kernels on a CUDA device. Cross-attention blocks
    attend to ``memory`` [B,T,D] and store its K/V in ``cache_dtype``.

    Returns (logits [B,S,V], decode_state positioned at t = S).
    """
    check_supported(cfg)
    x = shard(_embed(cfg, params, tokens, embeddings), "dp", None, None)
    memory = _memory(cfg, memory, x)
    S = x.shape[1]
    context_len = context_len or S
    positions = _positions(S, x.device)
    caches: dict[tuple, dict] = {}
    for group, r, i, kind in _layers(cfg):
        p = _block_params(params, group, r, i)
        h = layers.apply_norm(cfg, p["norm"], x)
        if kind == RGLRU:
            h, caches[group, r, i] = rglru.apply_rglru_block(
                cfg, p["rglru"], h, want_state=True, impl=impl)
        elif kind == MAMBA:
            h, caches[group, r, i] = ssm.apply_mamba_block(
                cfg, p["mamba"], h, want_state=True, impl=impl)
        elif kind == XATTN:
            h, (k, v) = attention.cross_attention(
                cfg, p["attn"], h, memory, impl=impl, return_kv=True)
            caches[group, r, i] = {"k_mem": k.to(cache_dtype),
                                   "v_mem": v.to(cache_dtype)}
        else:
            h, (k, v) = attention.self_attention(
                cfg, p["attn"], h, positions, kind, return_kv=True,
                impl=impl)
            caches[group, r, i] = attention.build_cache_from_full(
                cfg, k, v, context_len, kind, cache_dtype)
        x, _, _ = _residual(cfg, kind, p, x, h)
    x = layers.apply_norm(cfg, params["final_norm"], x)
    logits = layers.lm_logits(cfg, params["embed"], x)
    return shard(logits, "dp", None, "tp"), _assemble_state(cfg, caches)


def _assemble_state(cfg: ModelConfig, caches: dict) -> dict:
    state: dict[str, Any] = {}
    if cfg.num_repeats:
        state["blocks"] = {
            str(i): {leaf: torch.stack([caches["blocks", r, str(i)][leaf]
                                        for r in range(cfg.num_repeats)])
                     for leaf in caches["blocks", 0, str(i)]}
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
    rings stay per-row. Cross-attention blocks hold ``[batch, T, KV,
    dh]`` memory K/V (T = ``cfg.frontend_tokens``), per row.
    """
    check_supported(cfg)

    def block_state(kind: str, lead: tuple) -> dict:
        if kind in _RECURRENT_KINDS:        # fp32 whatever ``dtype`` says
            one = (rglru.init_rglru_state(cfg, batch, device) if kind == RGLRU
                   else ssm.init_mamba_state(cfg, batch, device))
            return {leaf: z.new_zeros(lead + z.shape)
                    for leaf, z in one.items()}
        leaves = ("k", "v")
        if kind == XATTN:
            leaves = ("k_mem", "v_mem")
            shp = (batch, cfg.frontend_tokens, cfg.num_kv_heads,
                   cfg.head_dim)
        elif kind == ATTN and page_size is not None:
            shp = attention.paged_kv_cache_shape(cfg, num_pages, page_size)
        else:
            shp = attention.kv_cache_shape(cfg, batch, context_len, kind)
        return {leaf: torch.zeros(lead + shp, dtype=dtype, device=device)
                for leaf in leaves}

    state: dict[str, Any] = {}
    if cfg.num_repeats:
        state["blocks"] = {str(i): block_state(kind, (cfg.num_repeats,))
                           for i, kind in enumerate(cfg.pattern)}
    if cfg.remainder:
        state["tail"] = {str(i): block_state(kind, ())
                         for i, kind in enumerate(cfg.remainder)}
    return state


def decode_state_spec(cfg: ModelConfig, batch: int, context_len: int,
                      dtype=torch.bfloat16, page_size: Optional[int] = None,
                      num_pages: Optional[int] = None) -> dict:
    """``init_decode_state``'s tree as meta tensors (no allocation): the
    JAX package's ``decode_state_spec``, leaf for leaf."""
    return init_decode_state(cfg, batch, context_len, dtype, page_size,
                             num_pages, device="meta")


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
    the attention leaf of every ATTN/SWA/LOCAL block and of every
    cross-attention block (over the stored memory K/V); RG-LRU and Mamba
    blocks take one recurrence step (no kernel, as in the JAX package).
    With ``pages`` ([B, n_log] int32), full-context ATTN layers read their
    state as the shared page pool. The state is updated in place and returned.
    Returns (logits [B,1,V], state).
    """
    x = shard(layers.embed_tokens(cfg, params["embed"], tokens),
              "dp", None, None)
    for group, r, i, kind in _layers(cfg):
        p = _block_params(params, group, r, i)
        cache = _leaf_view(state, group, r, i)
        h = layers.apply_norm(cfg, p["norm"], x)
        if kind in _RECURRENT_KINDS:
            if kind == RGLRU:
                h, new = rglru.apply_rglru_block(cfg, p["rglru"], h, cache)
            else:
                h, new = ssm.apply_mamba_block(cfg, p["mamba"], h, cache)
            for leaf, dst in cache.items():
                dst.copy_(new[leaf])
        elif kind == XATTN:
            h = attention.cross_decode_attention(cfg, p["attn"], h, cache,
                                                 impl=attn_impl)
        elif kind == ATTN and pages is not None:
            h, _ = attention.paged_decode_attention(cfg, p["attn"], h, cache,
                                                    t, pages, impl=attn_impl)
        else:
            h, _ = attention.decode_attention(cfg, p["attn"], h, cache, t,
                                              kind, impl=attn_impl)
        x, _, _ = _residual(cfg, kind, p, x, h)
    x = layers.apply_norm(cfg, params["final_norm"], x)
    logits = layers.lm_logits(cfg, params["embed"], x)
    return shard(logits, "dp", None, "tp"), state


# ---------------------------------------------------------------------------
# Chunked prefill: extend a decode state by a block of prompt tokens
# ---------------------------------------------------------------------------

def prefill_extend(cfg: ModelConfig, params: dict, state: dict,
                   tokens: torch.Tensor, t0):
    """Advance a (flat) decode state, in place, by a chunk of ``C``
    prompt tokens at positions ``t0 .. t0+C-1``. Returns (last-position
    logits [B,1,V], state positioned at ``t0 + C``). Attention-only
    stacks: the engine gates recurrent ones to exact-length prefill, as
    the JAX package does. An MoE layer routes each chunk on its own, so
    its capacity is the chunk's (as in the JAX package), not the whole
    prompt's."""
    kinds = block_kinds(cfg)
    if kinds - set(_ATTN_KINDS):
        raise ValueError(f"{cfg.name}: chunked prefill needs an "
                         f"attention-only stack, not {sorted(kinds)}")
    x = shard(layers.embed_tokens(cfg, params["embed"], tokens),
              "dp", None, None)
    for group, r, i, kind in _layers(cfg):
        p = _block_params(params, group, r, i)
        cache = _leaf_view(state, group, r, i)
        h = layers.apply_norm(cfg, p["norm"], x)
        h, _ = attention.extend_attention(cfg, p["attn"], h, cache, t0, kind)
        x, _, _ = _residual(cfg, kind, p, x, h)
    x = layers.apply_norm(cfg, params["final_norm"], x[:, -1:])
    logits = layers.lm_logits(cfg, params["embed"], x)
    return shard(logits, "dp", None, "tp"), state
