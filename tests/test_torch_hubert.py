"""The port's audio encoder (HuBERT) against the JAX package, on the CPU:
the conv positional embedding (``layers.add_conv_pos``) and the
bidirectional stack over frame embeddings (``transformer.forward(
embeddings=...)``), reduced hubert-xlarge (2 layers, d 64, 4 heads,
LayerNorm, GELU MLP with biases, conv width 8 over 4 groups) at fp32
compute, weights converted from the JAX tree through numpy, seeded numpy
frame embeddings.

Tolerances: atol/rtol 1e-5 on the conv embedding and 1e-4 on hidden
states and logits (summation order only; the grouped convolution is
``lax.conv`` in JAX and ``F.conv1d`` here, neither a Pallas kernel).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jlayers
from repro.models import transformer as jt
from repro_torch import configs as tconfigs
from repro_torch.models import convert
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as tt
from repro_torch.serve.engine import ServeEngine

torch.set_num_threads(1)

HUB = dataclasses.replace(tconfigs.get_reduced("hubert-xlarge"),
                          compute_dtype="float32")
CONV_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def hubert():
    jp = jt.init_params(HUB, jax.random.key(0))
    tp = convert.params_from_numpy(HUB, jax.tree.map(np.asarray, jp),
                                   device="cpu")
    return jp, tp


def _frames(B, S, seed=0, cfg=HUB):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("width", [8, 7])
@pytest.mark.parametrize("S", [3, 8, 13])
def test_add_conv_pos_matches_jax(width, S):
    """SAME padding: an even width pads one more zero on the right (3
    left, 4 right at width 8), an odd one pads both sides alike; S below,
    at and above the width."""
    cfg = dataclasses.replace(HUB, conv_pos_width=width)
    jembed = jlayers.init_embed(cfg, jax.random.key(S))
    tembed = convert.params_from_numpy(
        cfg, {"embed": jax.tree.map(np.asarray, jembed)},
        device="cpu")["embed"]
    x = _frames(2, S, seed=S)
    jo = jlayers.add_conv_pos(cfg, jembed, jnp.asarray(x))
    to = tlayers.add_conv_pos(cfg, tembed, torch.from_numpy(x))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **CONV_TOL)


def test_conv_pos_padding_is_xla_same():
    """A delta at frame 0 with a one-hot kernel tap shows where the
    window sits: with width 8 the output at frame s reads frames s-3 ..
    s+4."""
    cfg = dataclasses.replace(HUB, conv_pos_width=8, conv_pos_groups=64)
    D = cfg.d_model
    w = np.zeros((8, 1, D), np.float32)
    w[7, 0, :] = 1.0                     # the last tap: frame s + 4
    x = np.zeros((1, 10, D), np.float32)
    x[0, 5] = 1.0
    out = tlayers.add_conv_pos(cfg, {"conv_pos": torch.from_numpy(w)},
                               torch.from_numpy(x)) - torch.from_numpy(x)
    hit = np.nonzero(out[0, :, 0].numpy())[0]
    np.testing.assert_array_equal(hit, [1])


def test_init_keeps_the_jax_layout():
    cfg = tconfigs.get_reduced("hubert-xlarge")
    tp = tt.init_params(cfg, seed=0, device="cpu")
    shapes = jt.param_shapes(cfg)
    assert tuple(tp["embed"]["conv_pos"].shape) == \
        shapes["embed"]["conv_pos"].shape == (8, 16, 64)


@pytest.mark.parametrize("impl", ["dense", "flash"])
@pytest.mark.parametrize("S", [16, 11])
def test_forward_embeddings_matches_jax(hubert, impl, S):
    """S = 16 (a multiple of the conv width) and 11 (not): hidden
    states and masked-prediction logits."""
    jp, tp = hubert
    x = _frames(2, S, seed=S)
    jh, _ = jt.forward(HUB, jp, embeddings=jnp.asarray(x))
    th, aux = tt.forward(HUB, tp, embeddings=torch.from_numpy(x), impl=impl)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    jl = jt.logits_from_hidden(HUB, jp, jh)
    tl = tt.logits_from_hidden(HUB, tp, th)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert float(aux) == 0.0


def test_encoder_is_bidirectional(hubert):
    """A change to the last frame reaches the first frame's output."""
    _, tp = hubert
    x = _frames(1, 12, seed=3)
    y = x.copy()
    y[0, -1] += 1.0
    a, _ = tt.forward(HUB, tp, embeddings=torch.from_numpy(x))
    b, _ = tt.forward(HUB, tp, embeddings=torch.from_numpy(y))
    assert float((a[0, 0] - b[0, 0]).abs().max()) > 1e-4


def test_bf16_forward_close_to_jax():
    cfg = tconfigs.get_reduced("hubert-xlarge")
    jp = jt.init_params(cfg, jax.random.key(1))
    tp = convert.params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                   device="cpu")
    x = _frames(2, 12, seed=4)
    jh, _ = jt.forward(cfg, jp, embeddings=jnp.asarray(x))
    th, _ = tt.forward(cfg, tp, embeddings=torch.from_numpy(x))
    assert th.dtype == torch.bfloat16
    np.testing.assert_allclose(th.float().numpy(),
                               np.asarray(jh, np.float32), rtol=0, atol=0.1)


def test_engine_refuses_the_encoder(hubert):
    _, tp = hubert
    with pytest.raises(ValueError, match="no autoregressive decode step"):
        ServeEngine(HUB, tp, device="cpu")
