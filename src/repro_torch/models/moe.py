"""Mixtral-style token-choice top-k MoE — the port of ``repro.models.moe``.

The function is the JAX package's exactly, including which tokens are
dropped: router logits in x's dtype, then fp32 softmax; the top-k breaks
ties toward the lower expert index (``jax.lax.top_k``'s order; a stable
descending sort gives it, ``torch.topk`` promises none); the chosen gates
are renormalised over the top-k before capacity is applied, and a token
whose position in its expert's buffer (``cumsum(mask) * mask - 1`` along
the sequence, per row) reaches the capacity ``C`` has its gate zeroed.

Only the dispatch is formulated differently. The JAX package multiplies
one-hot ``[B, S, E, C]`` dispatch and combine tensors into its einsums
(TPU-friendly, no gather); here each kept (token, choice) is scattered
by index into its slot of ``[E, B*C, D]`` expert buffers, the experts run
as batched products over those buffers, and the combine gathers each
token's K expert outputs back by the same index. A one-hot product with a
single non-zero term per output is exact, so the buffers hold the same
values; the combine sums the K gated outputs in fp32 and rounds once to
x's dtype, as an einsum with fp32 accumulation does. There is no CUDA
kernel here: the JAX MoE runs no Pallas kernel either (XLA einsums), and
the batched products go to ``torch.bmm`` as the JAX package leaves them
to XLA. Every expert's weights are read on every call, whatever the
routing, as in the JAX package's stacked einsums.

On DTensors (a sharding context) each device routes its own rows: the
tokens are batch-sharded and replicated over TP, as the JAX package's
``shard`` keeps its expert buffers, and the expert weights sharded over
TP on their hidden width, as it keeps the expert hidden state; the
dispatch above then runs on the local shards (``local_map``), and the
TP shards' partial outputs are summed. Routing is per row, so every
device's rows route as they would unsharded; the load-balance means are
averaged over the batch shards.

``apply_dropless`` is the other route, the one of a device that holds a
share of the experts (``cfg.experts_held``, expert parallelism without
its exchange) and drops nothing (``cfg.moe_dropless``): the router's
softmax and top-k over every expert as above, then each (token, choice)
whose expert is held is computed by that expert, with no capacity, and
the rest are left out. The pairs are sorted by held expert (the others
last) with the offsets kept on the device, so a CUDA graph can hold the
pass: no ``nonzero``, no boolean indexing, no count read to the host.
The experts' products are grouped over those offsets
(``grouped_mm``), their cost following the rows routed here, and so is
the work around them: the gather of the held pairs' rows, SwiGLU and the
combine are the kernels of ``kernels/moe_pairs.py``, which read the held
count on the device and touch no row past it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.kernels import _shards, moe_pairs
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import shard

# Tokens are routed within groups of at most this many tokens when the
# sequence is a whole number of groups longer than one (GShard grouping);
# capacity is then per group. Tests shrink it, on both packages alike.
GROUP_TOKENS = 4096


def init_moe(cfg: ModelConfig, gen: torch.Generator, device, dtype) -> dict:
    """Router and stacked expert weights in the JAX tree's layout:
    ``router`` [D, E], ``w_gate``/``w_up`` [H, D, F], ``w_down`` [H, F, D]
    for the H experts held (all E unless ``cfg.experts_held``)."""
    lo, hi = cfg.held_range
    d, f, e = cfg.d_model, cfg.d_ff, hi - lo
    s_in, s_out = d ** -0.5, f ** -0.5

    def normal(shape, scale):
        return (torch.randn(shape, generator=gen, device=device)
                * scale).to(dtype)

    return {
        "router": layers.init_linear(gen, d, cfg.num_experts, device,
                                     dtype),
        "w_gate": normal((e, d, f), s_in),
        "w_up": normal((e, d, f), s_in),
        "w_down": normal((e, f, d), s_out),
    }


def topk_mask(probs: torch.Tensor, k: int) -> tuple[torch.Tensor,
                                                    torch.Tensor]:
    """[.., E] -> (indices [.., k] of the top-k, highest first and ties
    to the lower index; the 0/1 mask [.., E] in ``probs``' dtype)."""
    idx = torch.sort(probs, dim=-1, descending=True, stable=True).indices
    idx = idx[..., :k]
    mask = torch.zeros_like(probs).scatter_(-1, idx, 1.0)
    return idx, mask


def route(cfg: ModelConfig, p: dict, x: torch.Tensor) -> dict:
    """The router's decisions for x [B, S, D] (one group): ``probs`` and
    the top-k ``mask`` [B,S,E] fp32, ``idx`` [B,S,K] the chosen experts,
    ``pos`` [B,S,E] each token's buffer position (-1 where not chosen),
    ``in_cap`` [B,S,E] the choices that fit the capacity ``C`` (a chosen
    expert outside it is a dropped token), ``gates`` [B,S,E] fp32,
    renormalised over the top-k and zero where dropped."""
    E, K, S = cfg.num_experts, cfg.experts_per_token, x.shape[1]
    C = max(int(cfg.moe_capacity_factor * K * S / E), 1)
    logits = layers.apply_linear(p["router"], x).float()         # [B,S,E]
    probs = torch.softmax(logits, dim=-1)
    idx, mask = topk_mask(probs, K)
    gates = probs * mask
    gates = gates / (gates.sum(-1, keepdim=True) + 1e-9)
    pos = torch.cumsum(mask, dim=1) * mask - 1.0
    in_cap = (pos >= 0) & (pos < C)
    gates = torch.where(in_cap, gates, torch.zeros_like(gates))
    return {"probs": probs, "mask": mask, "idx": idx, "pos": pos,
            "in_cap": in_cap, "gates": gates, "C": C}


def apply_moe(cfg: ModelConfig, p: dict, x: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, D] -> (out [B, S, D] in x's dtype, aux_loss fp32 scalar)."""
    if isinstance(x, DTensor):
        return _apply_moe_sharded(cfg, p, x)
    y, f_e, p_e = _moe(cfg, p, x)
    return y, _aux_loss(cfg, f_e, p_e)


def grouped_mm(a: torch.Tensor, b: torch.Tensor,
               ends: torch.Tensor) -> torch.Tensor:
    """Rows of a [M, K] in groups, group g being rows ends[g-1] ..
    ends[g] - 1 (``ends`` [G] int32, on a's device), each times its
    matrix b[g] [K, N]: [M, N], with rows past ends[-1] unspecified.
    On a card ``torch._grouped_mm`` (CUTLASS's grouped GEMM, which reads
    the offsets on the device and computes the rows they hold); on the
    CPU the plain loop over the groups."""
    if a.is_cuda:
        return torch._grouped_mm(a, b, offs=ends)
    parts, start = [], 0
    for g, end in enumerate(ends.tolist()):
        parts.append(a[start:end] @ b[g])
        start = end
    parts.append(a.new_zeros((a.shape[0] - start, b.shape[-1])))
    return torch.cat(parts)


class _CastCat(torch.autograd.Function):
    """[a | b] along the last dim in ``dtype``: the two casts write into
    one tensor, and the gradient's halves go back in a's and b's dtypes."""

    @staticmethod
    def forward(ctx, a, b, dtype):
        ctx.dtypes, ctx.fa = (a.dtype, b.dtype), a.shape[-1]
        out = a.new_empty((*a.shape[:-1], a.shape[-1] + b.shape[-1]),
                          dtype=dtype)
        out[..., :ctx.fa] = a
        out[..., ctx.fa:] = b
        return out

    @staticmethod
    def backward(ctx, g):
        whole = torch.contiguous_format
        return (g[..., :ctx.fa].to(ctx.dtypes[0], memory_format=whole),
                g[..., ctx.fa:].to(ctx.dtypes[1], memory_format=whole), None)


def sort_pairs(idx: torch.Tensor, lo: int, hi: int
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The (token, choice) pairs of idx [N, K] (the chosen experts)
    sorted by held expert, experts lo .. hi-1 held: (order [N*K], the
    pairs in that order; pos [N, K], each pair's row in it; ends [H]
    int32, each held expert's end row, so ends[-1] pairs are held). Each
    pair's key is its held expert, or H for the others, sorted stably:
    each expert's rows stay in token order and the others come last."""
    N, K = idx.shape
    H = hi - lo
    local = idx - lo
    held = (local >= 0) & (local < H)
    key = torch.where(held, local, torch.full_like(local, H)).reshape(-1)
    key, order = torch.sort(key, stable=True)
    ends = torch.searchsorted(key, torch.arange(H, device=idx.device),
                              right=True, out_int32=True)
    pos = torch.empty_like(order).scatter_(
        0, order, torch.arange(order.numel(), device=idx.device))
    return order, pos.view(N, K), ends


def apply_dropless(cfg: ModelConfig, p: dict, x: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [B, S, D] -> (what the held experts give each token [B, S, D] in
    x's dtype, the load-balance loss over every expert, fp32, and the
    rows each held expert computed [H] fp32). ``p`` holds the router
    over all ``num_experts`` and the held experts' weights, [H, ..]."""
    if isinstance(x, DTensor):
        raise NotImplementedError("the dropless expert layer runs on "
                                  "plain tensors, not under a mesh")
    B, S, D = x.shape
    K = cfg.experts_per_token
    lo, hi = cfg.held_range
    N = B * S
    xf = x.reshape(N, D)
    logits = layers.apply_linear(p["router"], xf).float()        # [N, E]
    probs = torch.softmax(logits, dim=-1)
    idx, mask = topk_mask(probs, K)
    gates = probs * mask
    gates = gates / (gates.sum(-1, keepdim=True) + 1e-9)
    k_gate = torch.gather(gates, -1, idx).to(x.dtype)             # [N, K]

    order, pos, ends = sort_pairs(idx, lo, hi)

    # The held pairs' rows (ends[-1] of them, the rest left unspecified):
    # gathered, through one grouped product against [w_gate | w_up],
    # SwiGLU and the down product, then each token's gated and summed in
    # choice order in fp32, rounded once to x's dtype.
    xs = moe_pairs.gather(xf, torch.div(order, K, rounding_mode="floor"),
                          pos, ends)                              # [NK, D]
    w_in = _CastCat.apply(p["w_gate"], p["w_up"], x.dtype)      # [H,D,2F]
    h = moe_pairs.swiglu(grouped_mm(xs, w_in, ends), ends)        # [NK, F]
    ye = grouped_mm(h, p["w_down"].to(x.dtype), ends)
    y = moe_pairs.combine(ye, k_gate, pos, ends)

    rows = torch.diff(ends, prepend=ends.new_zeros(1)).float()
    aux = _aux_loss(cfg, mask.mean(dim=0), probs.mean(dim=0))
    return y.view(B, S, D), aux, rows


def _aux_loss(cfg: ModelConfig, f_e, p_e):
    """Switch-style load-balance loss, E * sum_e f_e * P_e."""
    return cfg.num_experts * torch.sum(f_e * p_e) * cfg.router_aux_loss


def _moe(cfg: ModelConfig, p: dict, x: torch.Tensor):
    """(out [B, S, D], the routed share f_e [E], the mean router
    probability P_e [E]) for plain tensors."""
    B0, S0, D = x.shape
    if S0 > GROUP_TOKENS and S0 % GROUP_TOKENS == 0:
        n = S0 // GROUP_TOKENS
        out, f_e, p_e = _moe(cfg, p, x.reshape(B0 * n, GROUP_TOKENS, D))
        return out.reshape(B0, S0, D), f_e, p_e

    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    r = route(cfg, p, x)
    C, idx = r["C"], r["idx"]

    # Each (token, choice): its buffer slot in [E, B, C] and its gate.
    k_pos = torch.gather(r["pos"], -1, idx).long()               # [B,S,K]
    k_gate = torch.gather(r["gates"], -1, idx).to(x.dtype)
    k_kept = torch.gather(r["in_cap"], -1, idx)
    rows = torch.arange(B, device=x.device)[:, None, None]
    slot = (idx * B + rows) * C + k_pos
    trash = E * B * C                                            # dropped
    slot = torch.where(k_kept, slot, torch.full_like(slot, trash))

    # Dispatch: scatter the kept tokens into the expert buffers (the
    # dropped ones all land on the trash row, which is cut off).
    xe = x.new_zeros((trash + 1, D))
    src = x[:, :, None, :].expand(B, S, K, D).reshape(-1, D)
    xe.index_put_((slot.reshape(-1),), src)
    xe = xe[:trash].view(E, B * C, D)

    w_gate = p["w_gate"].to(x.dtype)
    w_up = p["w_up"].to(x.dtype)
    w_down = p["w_down"].to(x.dtype)
    h = F.silu(torch.bmm(xe, w_gate)) * torch.bmm(xe, w_up)      # [E,BC,F]
    ye = torch.bmm(h, w_down).reshape(E * B * C, D)

    # Combine: each token's K gated expert outputs, summed in fp32. A
    # dropped choice reads row 0 under a zero gate.
    got = ye[torch.where(k_kept, slot, torch.zeros_like(slot))]  # [B,S,K,D]
    y = (k_gate.float()[..., None] * got.float()).sum(dim=2).to(x.dtype)

    f_e = r["mask"].mean(dim=(0, 1))                             # routed share
    p_e = r["probs"].mean(dim=(0, 1))                            # router prob
    return y, f_e, p_e


class _GradScale(torch.autograd.Function):
    """Identity forward; the gradient times ``s``."""

    @staticmethod
    def forward(ctx, t, s: float):
        ctx.s = s
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.s, None


def _apply_moe_sharded(cfg: ModelConfig, p: dict, x):
    """``apply_moe`` on DTensors: each device routes its own rows against
    its TP shard of every expert (see the module docstring)."""
    mesh = x.device_mesh
    x = shard(x, "dp", None, None)
    router = shard(p["router"]["kernel"], None, None)
    w_gate = shard(p["w_gate"], None, None, "tp")
    w_up = shard(p["w_up"], None, None, "tp")
    w_down = shard(p["w_down"], None, "tp", None)
    # Rows split over the batch shards: their means average, and a
    # partial sum of mean / n_rows_shards is exact to a rounding.
    n_row_shards = 1
    for i, pl in enumerate(x.placements):
        if isinstance(pl, Shard):
            n_row_shards *= mesh.size(i)
    y_pl = tuple(Shard(0) if isinstance(a, Shard) else
                 Partial() if isinstance(b, Shard) else Replicate()
                 for a, b in zip(x.placements, w_down.placements))
    mean_pl = tuple(Partial() if isinstance(a, Shard) else Replicate()
                    for a in x.placements)

    # Every TP shard routes the same rows the same way, so the gradient
    # the load-balance loss sends back through the router arrives whole
    # on each; the TP shards' gradients are summed (their expert shares
    # differ), so that one is cut to its share.
    n_tp = 1
    for i, pl in enumerate(y_pl):
        if isinstance(pl, Partial):
            n_tp *= mesh.size(i)

    def local(x, router, w_gate, w_up, w_down):
        y, f_e, p_e = _moe(cfg, {"router": {"kernel": router},
                                 "w_gate": w_gate, "w_up": w_up,
                                 "w_down": w_down}, x)
        if n_tp > 1:
            p_e = _GradScale.apply(p_e, 1.0 / n_tp)
        if n_row_shards > 1:
            f_e, p_e = f_e / n_row_shards, p_e / n_row_shards
        return y, f_e, p_e

    args = (x, router, w_gate, w_up, w_down)
    y, f_e, p_e = _shards.on_shards(
        local, args, tuple(tuple(a.placements) for a in args),
        (y_pl, mean_pl, mean_pl))
    rep = (Replicate(),) * mesh.ndim
    return y, _aux_loss(cfg, f_e.redistribute(mesh, rep),
                        p_e.redistribute(mesh, rep))
