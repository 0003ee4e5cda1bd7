"""An architecture is a module the harness finds by the name that a
configuration gives under ``"bench_arch"``, as it finds a metric's
reader: a new one is new files only. Here one is written to a
temporary folder, a GQA transformer with RMSNorm over each head's q and
k (the port's qk-norm, Qwen3's), and trained through a whole tiny run;
the transformer's own counts and layout stay what they were."""

import hashlib
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from perfbench import harness, spec
from perfbench.tests.tiny import tiny_cell

SEED = 2 ** 31 + 777
ARCHS = sorted(f[:-3] for f in os.listdir(os.path.join(spec.HERE, "archs"))
               if f.endswith(".py"))


def test_an_architecture_dropped_into_its_folder_is_found_by_name(tmp_path):
    (tmp_path / "archs").mkdir()
    (tmp_path / "archs" / "new-arch.py").write_text(
        "def sizes(conf):\n    return {'d': 2 * conf['hidden_size']}\n")
    mod = spec.arch("new-arch", base=str(tmp_path))
    assert mod.sizes({"hidden_size": 4}) == {"d": 8}
    assert spec.arch("new-arch", base=str(tmp_path)) is mod
    assert spec.arch_of({"bench_arch": "new-arch"}, str(tmp_path)) is mod


def test_an_unknown_architecture_is_refused_with_its_folder(tmp_path):
    (tmp_path / "archs").mkdir()
    (tmp_path / "archs" / "known.py").write_text("")
    with pytest.raises(KeyError, match="archs.*known"):
        spec.arch("no-such-arch", base=str(tmp_path))
    with pytest.raises(KeyError, match="no-such-arch"):
        spec.arch_of({"bench_arch": "no-such-arch"})


def test_a_configuration_that_names_no_architecture_is_refused():
    conf = spec.load_json(f"{spec.HERE}/configs/qwen2-1.5b.json")
    assert spec.arch_of(conf) is spec.arch("transformer")
    del conf["bench_arch"]
    with pytest.raises(ValueError, match="bench_arch"):
        spec.arch_of(conf)
    cell = spec.cell("qwen2-1.5b.train-b8s1024")
    cell.config = conf
    with pytest.raises(ValueError, match="bench_arch"):
        cell.arch


@pytest.mark.parametrize("name", ARCHS)
def test_a_reference_loads_nothing_of_the_program_or_of_jax(name):
    root = os.path.dirname(spec.HERE)
    code = ("import sys\n"
            "from perfbench import spec\n"
            f"ref = spec.arch({name!r}).reference\n"
            "assert callable(ref.train_steps)\n"
            "found = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('repro_torch', 'repro', 'jax', 'jaxlib'))\n"
            "assert not found, found\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root, os.path.join(root, "src")]))
    res = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]


# The parameter count, the FLOPs of a train step of 8 x 1024 tokens and
# the weight layout (its length and the SHA-256 of its JSON) as the
# harness counted them before the transformer moved into archs/.
PINNED = {
    "qwen2-1.5b": (1_543_714_304, 80198850576384.0, 338,
                   "d8c70c0293bc67012ec5537cd899da71"
                   "cf571c63e38db83695ee5977a797310e"),
    "mixtral-8x7b": (23_482_470_400, 323127569547264.0, 163,
                     "1391d73c90d57aef1f6d783074835e8e"
                     "1302d7792dd481f77d6bd56facc5f12d"),
}


@pytest.mark.parametrize("config", sorted(PINNED))
def test_the_transformer_counts_and_lays_out_what_it_did(config):
    arch = spec.arch("transformer")
    s = arch.sizes(spec.load_json(f"{spec.HERE}/configs/{config}.json"))
    lay = arch.layout(s)
    params, flops, n, digest = PINNED[config]
    assert arch.param_count(s) == params
    assert arch.train_flops(s, 8, 1024) == flops
    assert len(lay) == n
    assert hashlib.sha256(json.dumps(lay).encode()).hexdigest() == digest


# ---------------------------------------------------------------------------
# A new architecture, as new files only
# ---------------------------------------------------------------------------

QK_NORM_ARCH = '''"""The GQA transformer with RMSNorm over each head's q and k before
RoPE (Qwen3's qk-norm): two more scales a layer."""

import functools
import types

import torch
import torch.nn.functional as F

from perfbench import spec
from perfbench.reference import common as C

T = spec.arch("transformer")
sizes, program_config, tiny = T.sizes, T.program_config, T.tiny
train_flops, token_flops = T.train_flops, T.token_flops
attn_flops, attn_pairs_prefill = T.attn_flops, T.attn_pairs_prefill
decode_kv_bytes = T.decode_kv_bytes


def layout(s):
    return T.layout(s) + [
        (("blocks", r, "0", "attn", n, "scale"), (s["dh"],), "scale")
        for r in range(s["layers"]) for n in ("q_norm", "k_norm")]


def param_count(s):
    return T.param_count(s) + 2 * s["dh"] * s["layers"]


def _attn(s, p, x, prec):
    S = x.shape[0]
    q = C.linear(x, p, prec, "wq").view(S, s["h"], s["dh"])
    k = C.linear(x, p, prec, "wk").view(S, s["kv"], s["dh"])
    v = C.linear(x, p, prec, "wv").view(S, s["kv"], s["dh"])
    q = C.rms_norm(q, p["q_norm"]["scale"], s["eps"])
    k = C.rms_norm(k, p["k_norm"]["scale"], s["eps"])
    q, k = C.rope(q, s["theta"]), C.rope(k, s["theta"])
    o = C.attention(q, k, v, s["window"], prec).reshape(S, -1)
    return C.linear(o, p, prec, "wo")


def _layer(s, p, x, prec):
    h = x + _attn(s, p["attn"], C.rms_norm(
        x, p["norm"]["scale"], s["eps"]), prec)
    return h + C.dense_mlp(p["mlp"], C.rms_norm(
        h, p["mlp_norm"]["scale"], s["eps"]), prec)


def _loss(s, params, tokens, prec):
    outs = []
    for xb in params["embed"]["tokens"][tokens.long()].float():
        for lp in params["blocks"]:
            xb = _layer(s, lp["0"], xb, prec)
        outs.append(xb)
    hid = C.rms_norm(torch.stack(outs), params["final_norm"]["scale"],
                     s["eps"])
    head = (params["embed"]["tokens"].T if s["tie"] else
            params["embed"]["head"]["kernel"])
    logits = prec.a(hid[:, :-1]) @ prec.w(head)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           tokens[:, 1:].reshape(-1).long())


def train_steps(s, params, batches, opt, num_micro, leaves_fn, quant=None):
    return C.adamw_steps(functools.partial(_loss, s), params, batches, opt,
                         num_micro, leaves_fn, quant)


reference = types.SimpleNamespace(train_steps=train_steps)
'''

CELL = "qwen3-qk.train-small"


def _qk_norm_cell(tmp_path):
    """The files of a new architecture and of a cell that trains it,
    written only under ``tmp_path``, and that cell at a tiny size."""
    for sub in ("archs", "configs", "traffic", "limits"):
        (tmp_path / sub).mkdir()
    (tmp_path / "archs" / "qk_norm.py").write_text(QK_NORM_ARCH)
    conf = spec.load_json(f"{spec.HERE}/configs/qwen2-1.5b.json")
    conf.update(name="qwen3-qk", bench_arch="qk_norm",
                tie_word_embeddings=False)
    conf["port"].update(arch="qwen3-8b", qkv_bias=False)
    conf_path = tmp_path / "configs" / "qwen3-qk.json"
    conf_path.write_text(json.dumps(conf))
    mix = spec.load_json(f"{spec.HERE}/traffic/train-b8s1024.json")
    (tmp_path / "traffic" / "train-small.json").write_text(json.dumps(mix))
    limits = spec.load_json(
        f"{spec.HERE}/limits/qwen2-1.5b.train-b8s1024.json")
    (tmp_path / "limits" / f"{CELL}.json").write_text(json.dumps(limits))
    bench = {
        "configs": [{"name": "qwen3-qk", "file": str(conf_path)}],
        "workloads": [{"name": CELL, "config": "qwen3-qk",
                       "traffic": "train-small", "chips": 1}],
        "end_to_end": [{"name": "train_tok_s", "unit": "tokens/s",
                        "workloads": [CELL]},
                       {"name": "setup_s", "unit": "s"}],
        "per_layer": [{"name": "mfu.train", "unit": "%",
                       "moves": "train_tok_s", "workloads": [CELL]}]}
    return tiny_cell(CELL, root="/", bench=bench, base=str(tmp_path))


def _run(cell, trace=False):
    return harness.run_cell(cell, SEED, 1.2, trace, torch.device("cpu"),
                            time.perf_counter())


@pytest.mark.parametrize("trace", [False, True])
def test_a_new_architecture_trains_correct_from_new_files_alone(tmp_path,
                                                                 trace):
    before = {p: os.path.getmtime(p) for p in _committed_files()}
    cell = _qk_norm_cell(tmp_path)
    s = cell.arch.sizes(cell.config)
    assert len(cell.arch.layout(s)) == len(
        spec.arch("transformer").layout(s)) + 2 * s["layers"]
    out = _run(cell, trace)
    assert out["correct"], out["check"]
    assert out["attempted"] > 0 and out["failed"] == 0
    names = {"mfu.train"} if trace else {"train_tok_s", "setup_s"}
    assert set(out["metrics"]) == names
    assert {p: os.path.getmtime(p) for p in _committed_files()} == before


def _unchanged_state(monkeypatch):
    from repro_torch.train import optimizer
    monkeypatch.setattr(optimizer, "apply_updates",
                        lambda cfg, params, grads, state:
                        (params, state, {}))


def _half_batch(monkeypatch):
    import dataclasses

    from repro_torch.launch import train
    orig = train.make_grad_fn

    def half(model_cfg, train_cfg):
        fn = orig(model_cfg, dataclasses.replace(train_cfg,
                                                 num_microbatches=1))

        def compute(params, batch):
            n = batch["tokens"].shape[0] // 2
            return fn(params, {k: v[:n] for k, v in batch.items()})
        return compute

    monkeypatch.setattr(train, "make_grad_fn", half)


def _qk_norm_left_out(monkeypatch):
    from repro_torch.models import attention
    monkeypatch.setattr(attention, "_headwise_rms",
                        lambda x, scale, eps: x)


@pytest.mark.parametrize("fault", [_unchanged_state, _half_batch,
                                   _qk_norm_left_out],
                         ids=lambda f: f.__name__.strip("_"))
def test_a_new_architecture_with_its_timed_path_broken_is_not_correct(
        tmp_path, monkeypatch, fault):
    cell = _qk_norm_cell(tmp_path)
    fault(monkeypatch)
    out = _run(cell)
    assert not out["correct"], out["check"]


def _committed_files():
    return sorted(os.path.join(d, f) for d, _, fs in os.walk(spec.HERE)
                  if "__pycache__" not in d for f in fs)
