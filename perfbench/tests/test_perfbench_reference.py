"""The plain reference against the port, at each configuration's
``reduced()`` size on the CPU, in float32: the port's prefill (dense
attention, its MoE's capacity rule included) and its serving engine's
greedy tokens, decoded through the KV cache, against the reference's
forward over the same tokens."""

import numpy as np
import pytest
import torch

from perfbench import spec
from perfbench import weights as wts
from repro_torch import configs
from repro_torch.models import transformer
from repro_torch.serve.engine import ServeEngine

ARCH = spec.arch("transformer")
reference = ARCH.reference


def _reduced(arch: str):
    cfg = configs.get_reduced(arch)
    s = {"layers": cfg.num_layers, "d": cfg.d_model, "h": cfg.num_heads,
         "kv": cfg.num_kv_heads, "f": cfg.d_ff, "vocab": cfg.vocab_size,
         "eps": cfg.norm_eps, "theta": cfg.rope_theta,
         "tie": cfg.tie_embeddings, "experts": cfg.num_experts,
         "top_k": cfg.experts_per_token, "dh": cfg.head_dim,
         "qkv_bias": cfg.qkv_bias, "window": cfg.window,
         "capacity_factor": cfg.moe_capacity_factor if cfg.num_experts
         else 0.0, "group_tokens": 4096}
    import dataclasses
    return dataclasses.replace(cfg, compute_dtype="float32"), s


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mixtral-8x7b"])
def test_reference_matches_the_port_prefill(arch):
    cfg, s = _reduced(arch)
    w = wts.draw(ARCH.layout(s), 11, "cpu", torch.float32)
    wts.check_layout(w, transformer.param_shapes(cfg))
    toks = np.random.default_rng(1).integers(0, s["vocab"], 40)
    with torch.no_grad():
        logits, _ = transformer.prefill(
            cfg, w, tokens=torch.as_tensor(toks[None]), context_len=64,
            impl="dense")
    # One sequence per prefix length: the last position of each is a
    # prompt's last token, routed with that whole prompt.
    seqs = [(np.r_[toks[:n], 0], n) for n in (1, 17, 40)]
    ref = reference.serve_logits(s, w, seqs, None, "cpu")
    port = logits[0].float()
    for (t, n), r in zip(seqs, ref):
        if n == 40 or not s["experts"]:
            torch.testing.assert_close(port[n - 1:n], r, atol=2e-5,
                                       rtol=2e-5)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mixtral-8x7b"])
def test_engine_tokens_are_the_reference_argmax(arch):
    cfg, s = _reduced(arch)
    w = wts.draw(ARCH.layout(s), 12, "cpu", torch.float32)
    eng = ServeEngine(cfg, w, num_slots=4, context_len=96, max_new=12,
                      prefill_chunk=16, device="cpu",
                      page_size=8 if not s["experts"] else None)
    rng = np.random.default_rng(2)
    futs = [eng.submit(rng.integers(0, s["vocab"], n).astype(np.int32))
            for n in (5, 20, 33)]
    while not all(f.done() for f in futs):
        eng.step()
    outs = [f.result() for f in futs]
    seqs = [(o, n) for o, n in zip(outs, (5, 20, 33))]
    gaps = reference.served_gaps(s, w, seqs, 16, "cpu")
    assert max(float(g.max()) for g in gaps) < 1e-4


def test_the_fp8_control_departs_from_the_reference():
    cfg, s = _reduced("qwen2-1.5b")
    w = wts.draw(ARCH.layout(s), 13, "cpu", torch.float32)
    toks = np.random.default_rng(3).integers(0, s["vocab"], 60)
    seqs = [(toks, 10)]
    ref = reference.serve_logits(s, w, seqs, None, "cpu")[0]
    low = reference.serve_logits(s, w, seqs, None, "cpu", quant="fp8")[0]
    rel = float((low - ref).abs().max() / ref.abs().max())
    assert 1e-3 < rel < 0.5
    assert max(float(g.max()) for g in reference.control_gaps(
        s, w, seqs, None, "cpu")) > 0.0
