"""The port's serving path on the CPU: decode loop, ServeEngine, the
serve program, and import hygiene.

Engine invariants are ported from ``tests/test_engine.py`` (the
attention-only cases); "solo" is the port's own ``generate``. Greedy
tokens are also held against the JAX package at fp32 compute, where they
are exact; sampled paths are checked for sync invariance and for their
distribution (``jax.random`` streams cannot be reproduced).
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as jt
from repro.serve import decode as jdecode
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch import core as lp
from repro_torch.launch import serve as tserve
from repro_torch.models import convert
from repro_torch.serve import decode as serve_lib
from repro_torch.serve.engine import ServeEngine

torch.set_num_threads(1)

CFG = jconfigs.get_reduced("qwen2-1.5b")
CFG32 = dataclasses.replace(CFG, compute_dtype="float32")
L = 24          # engine context (slot ring length)
MAX_NEW = 4
SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")


@pytest.fixture(autouse=True)
def _reset_port_inproc_registry():
    """Each test gets a clean in-process courier registry (the port's)."""
    from repro_torch.core.courier import inprocess
    inprocess.reset()
    yield
    inprocess.reset()


@pytest.fixture(scope="module")
def jax_params():
    return jt.init_params(CFG, jax.random.key(0))


@pytest.fixture(scope="module")
def params(jax_params):
    return convert.params_from_numpy(CFG, jax.tree.map(np.asarray,
                                                       jax_params),
                                     device="cpu")


def _prompts(lens, seed=0, vocab=CFG.vocab_size):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


def _run(engine, futs, max_steps=500):
    steps = 0
    while not all(f.done() for f in futs):
        engine.step()
        steps += 1
        assert steps < max_steps, "engine made no progress"


def _solo(params, prompt, max_new=MAX_NEW, cfg=CFG, impl="auto"):
    return serve_lib.generate(cfg, params, torch.from_numpy(prompt[None]),
                              max_new=max_new, context_len=L,
                              attn_impl=impl)[0].numpy()


def _engine(params, **kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("context_len", L)
    kw.setdefault("max_new", MAX_NEW)
    return ServeEngine(kw.pop("cfg", CFG), params, device="cpu", **kw)


# -- decode loop against the JAX package --------------------------------------

@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_generate_greedy_matches_jax(impl):
    """fp32 compute: greedy tokens are exact across frameworks, including
    ragged right-padded rows decoded at their own positions."""
    jp = jt.init_params(CFG32, jax.random.key(2))
    tp = convert.params_from_numpy(CFG32, jax.tree.map(np.asarray, jp),
                                   device="cpu")
    prompt = np.stack(_prompts([10, 10, 10], seed=1))
    for lengths in (None, np.array([10, 6, 3], np.int32)):
        jo = jdecode.generate(CFG32, jp, jnp.asarray(prompt), 6,
                              context_len=20, lengths=lengths,
                              attn_impl=impl)
        to = serve_lib.generate(CFG32, tp, torch.from_numpy(prompt), 6,
                                context_len=20, lengths=lengths,
                                attn_impl=impl)
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))


def test_engine_stream_matches_jax_engine():
    """One greedy request stream through the JAX ServeEngine and the
    port's gives the same tokens (fp32 compute, paged + chunked)."""
    jp = jt.init_params(CFG32, jax.random.key(3))
    tp = convert.params_from_numpy(CFG32, jax.tree.map(np.asarray, jp),
                                   device="cpu")
    prompts = _prompts([5, 11, 7, 14], seed=2)
    kw = dict(num_slots=2, context_len=L, max_new=5, page_size=4,
              num_pages=16, prefill_chunk=4)
    outs = []
    for eng in (JaxServeEngine(CFG32, jp, **kw),
                ServeEngine(CFG32, tp, device="cpu", **kw)):
        futs = [eng.submit(p) for p in prompts]
        _run(eng, futs)
        outs.append([f.result() for f in futs])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def test_sampler_distribution_and_top_k():
    """Gumbel-max with torch.Generator noise: empirical frequencies match
    softmax(logits / T), top-k never leaves the k best, and the same seed
    gives the same draws."""
    logits = torch.tensor([[[2.0, 1.0, 0.5, -1.0, 0.0]]])
    n = 4000
    sample = serve_lib.make_sampler(temperature=0.8)
    gen = torch.Generator().manual_seed(0)
    draws = torch.cat([sample(logits, gen) for _ in range(n)]).flatten()
    freq = torch.bincount(draws.long(), minlength=5).float() / n
    expect = torch.softmax(logits[0, 0] / 0.8, dim=-1)
    assert (freq - expect).abs().max() < 0.03      # ~4 sigma at n=4000
    top2 = serve_lib.make_sampler(temperature=5.0, top_k=2)
    gen = torch.Generator().manual_seed(1)
    picks = {int(top2(logits, gen)) for _ in range(200)}
    assert picks == {0, 1}
    a = sample(logits.expand(3, 1, 5), torch.Generator().manual_seed(7))
    b = sample(logits.expand(3, 1, 5), torch.Generator().manual_seed(7))
    assert torch.equal(a, b)
    assert int(sample(logits, None)) == 0          # no generator: greedy


# -- ServeEngine invariants (ported from tests/test_engine.py) ----------------

def test_engine_matches_solo_serving(params):
    engine = _engine(params, num_slots=3)
    prompts = _prompts([5, 9, 7, 5, 12])
    futs = [engine.submit(p) for p in prompts]
    _run(engine, futs)
    for p, f in zip(prompts, futs):
        out = f.result()
        assert out.shape == (len(p) + MAX_NEW,)
        np.testing.assert_array_equal(out, _solo(params, p))


def test_slot_reuse_and_full_pool_queues(params):
    engine = _engine(params)
    prompts = _prompts([5] * 7, seed=2)
    futs = [engine.submit(p) for p in prompts]
    assert engine.stats()["queue_depth"] == 7     # nothing admitted yet
    _run(engine, futs)
    for p, f in zip(prompts, futs):
        assert f.result().shape == (len(p) + MAX_NEW,)
    s = engine.stats()
    assert s["admitted"] == 7 and s["retired"] == 7
    assert s["peak_occupancy"] <= 2
    assert s["free_slots"] == 2 and s["queue_depth"] == 0


def test_interleaved_admission_preserves_inflight_decode(params):
    a, b = _prompts([6, 10], seed=3)
    engine = _engine(params)
    fa = engine.submit(a)
    engine.step()
    engine.step()                                 # A is mid-decode
    fb = engine.submit(b)
    _run(engine, [fa, fb])
    np.testing.assert_array_equal(fa.result(), _solo(params, a))
    np.testing.assert_array_equal(fb.result(), _solo(params, b))


def test_per_request_failure_delivery(params):
    engine = _engine(params)
    good1 = engine.submit(_prompts([5], seed=4)[0])
    bad = engine.submit(np.arange(L, dtype=np.int32))   # L + max_new > L
    good2 = engine.submit(_prompts([7], seed=5)[0])
    with pytest.raises(ValueError, match="context_len"):
        bad.result(timeout=5)
    _run(engine, [good1, good2])
    assert good1.result().shape == (5 + MAX_NEW,)
    assert good2.result().shape == (7 + MAX_NEW,)
    assert engine.stats()["failed"] == 0          # rejected pre-queue
    assert engine.stats()["retired"] == 2


def test_eos_retires_slot_immediately(params):
    prompt = _prompts([6], seed=6)[0]
    probe = _engine(params, num_slots=1)
    f = probe.submit(prompt)
    _run(probe, [f])
    first_tok = int(f.result()[len(prompt)])
    engine = _engine(params, num_slots=1, eos_id=first_tok)
    f1 = engine.submit(prompt)
    f2 = engine.submit(_prompts([9], seed=7)[0])
    _run(engine, [f1, f2])
    out = f1.result()
    assert out.shape == (len(prompt) + 1,)        # stopped at EOS
    assert out[-1] == first_tok
    s = engine.stats()
    assert s["retired"] == 2 and s["free_slots"] == 1


def test_stop_fails_pending_requests(params):
    engine = _engine(params, num_slots=1)
    fut = engine.submit(_prompts([5], seed=8)[0])
    engine.stop()
    with pytest.raises(RuntimeError, match="stopped"):
        fut.result(timeout=5)
    with pytest.raises(RuntimeError, match="stopped"):
        engine.submit(_prompts([5], seed=9)[0]).result(timeout=5)


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_dead_engine_loop_fails_requests_at_once(params):
    """If the decode loop dies, queued requests fail with its error right
    away (instead of waiting out their callers' timeouts), and the engine
    refuses new work."""
    engine = _engine(params)

    def boom():
        raise RuntimeError("boom")

    engine.step = boom
    fut = engine.submit(_prompts([5], seed=30)[0])
    engine.start()
    with pytest.raises(RuntimeError, match="loop died"):
        fut.result(timeout=30)
    assert not engine.alive
    with pytest.raises(RuntimeError, match="stopped"):
        engine.submit(_prompts([5], seed=31)[0]).result(timeout=5)
    engine.stop()


def test_background_loop_serves(params):
    with _engine(params) as engine:
        prompts = _prompts([5, 8, 11], seed=10)
        futs = [engine.submit(p) for p in prompts]
        for p, f in zip(prompts, futs):
            assert f.result(timeout=120).shape == (len(p) + MAX_NEW,)
    assert engine.stats()["retired"] == 3


@pytest.mark.parametrize("sync_every", [1, 8])
@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_fused_and_flash_match_solo(params, sync_every, impl):
    prompts = _prompts([5, 9, 12], seed=11)
    engine = _engine(params, sync_every=sync_every, decode_impl=impl)
    futs = [engine.submit(p) for p in prompts]
    _run(engine, futs)
    for p, f in zip(prompts, futs):
        np.testing.assert_array_equal(f.result(),
                                      _solo(params, p, impl=impl))


def test_chunked_prefill_matches_solo(params):
    engine = _engine(params, num_slots=3, prefill_chunk=4)
    prompts = _prompts([3, 8, 9, 14, 6], seed=12)
    futs = [engine.submit(p) for p in prompts]
    _run(engine, futs)
    for p, f in zip(prompts, futs):
        np.testing.assert_array_equal(f.result(), _solo(params, p))
    s = engine.stats()
    assert s["admitted"] == 5 and s["retired"] == 5
    assert s["free_slots"] == 3                   # no slot leaked by chunking


def test_fused_windows_batch_host_syncs(params):
    engine = _engine(params, num_slots=4, max_new=8, sync_every=8).warmup()
    futs = [engine.submit(p, max_new=8)
            for p in _prompts([5, 7, 6, 9], seed=13)]
    _run(engine, futs)
    s = engine.stats()
    assert s["generated_tokens"] == 32
    assert s["host_syncs"] < s["generated_tokens"] / 2
    assert s["syncs_per_token"] <= 0.3


def test_fused_sampling_is_sync_invariant(params):
    outs = []
    for sync in (1, 8):
        engine = _engine(params, num_slots=4, temperature=0.7, top_k=5,
                         seed=42, sync_every=sync)
        futs = [engine.submit(p) for p in _prompts([5, 8, 6], seed=14)]
        _run(engine, futs)
        outs.append([f.result() for f in futs])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("sync_every", [1, 8])
def test_paged_engine_matches_solo(params, sync_every):
    prompts = _prompts([5, 9, 12, 7], seed=21)
    engine = _engine(params, sync_every=sync_every, page_size=8,
                     num_pages=12)
    futs = [engine.submit(p) for p in prompts]
    _run(engine, futs)
    for p, f in zip(prompts, futs):
        np.testing.assert_array_equal(f.result(), _solo(params, p))


def test_prefix_cache_reuse_matches_cold_prefill(params):
    ps = 4
    rng = np.random.default_rng(22)
    shared = rng.integers(0, CFG.vocab_size, 12).astype(np.int32)
    tails = [rng.integers(0, CFG.vocab_size, n).astype(np.int32)
             for n in (3, 5, 2)]
    prompts = [np.concatenate([shared, t]) for t in tails]
    engine = _engine(params, page_size=ps, num_pages=16)
    f0 = engine.submit(prompts[0])    # cold: registers the shared pages
    _run(engine, [f0])
    futs = [engine.submit(p) for p in prompts[1:]]
    _run(engine, futs)
    for p, f in zip(prompts, [f0] + futs):
        np.testing.assert_array_equal(f.result(), _solo(params, p))
    s = engine.stats()
    assert s["prefix_cache"]["hits"] >= 2         # both warm prompts hit
    assert s["prefix_tokens_reused"] >= 2 * (12 // ps) * ps


def test_prefix_pages_released_on_retirement(params):
    engine = _engine(params, page_size=4, num_pages=16)
    futs = [engine.submit(p) for p in _prompts([10, 13], seed=23)]
    _run(engine, futs)
    s = engine.stats()
    assert s["free_slots"] == 2                   # all rows retired
    held = {pid for chain in engine._prefix._entries.values()
            for pid in chain}
    assert s["pages_in_use"] == len(held)         # cache is the only holder
    while engine._prefix.evict_one(engine._decref):
        pass
    s = engine.stats()
    assert s["pages_free"] == s["pages_total"]


def test_prefix_cache_evicts_under_pool_pressure(params):
    engine = _engine(params, page_size=4, num_pages=8)
    rng = np.random.default_rng(24)
    prompts = [rng.integers(0, CFG.vocab_size, 12).astype(np.int32)
               for _ in range(6)]
    futs = [engine.submit(p) for p in prompts]
    _run(engine, futs)
    for p, f in zip(prompts, futs):
        np.testing.assert_array_equal(f.result(), _solo(params, p))
    s = engine.stats()
    assert s["retired"] == 6
    assert s["prefix_cache"]["evictions"] >= 1


def test_request_exceeding_page_pool_fails_fast(params):
    engine = _engine(params, page_size=4, num_pages=2)
    fut = engine.submit(np.arange(12, dtype=np.int32))    # needs 4 pages
    with pytest.raises(ValueError, match="pages"):
        fut.result(timeout=5)
    ok = engine.submit(_prompts([3], seed=25)[0])         # 2 pages: fits
    _run(engine, [ok])
    assert ok.result().shape == (3 + MAX_NEW,)


def test_paged_chunked_prefill_matches_solo(params):
    engine = _engine(params, prefill_chunk=4, page_size=8, num_pages=9)
    prompts = _prompts([3, 9, 14, 6], seed=25)
    futs = [engine.submit(p) for p in prompts]
    _run(engine, futs)
    for p, f in zip(prompts, futs):
        np.testing.assert_array_equal(f.result(), _solo(params, p))
    s = engine.stats()
    assert s["free_slots"] == 2                   # no slot or page leaked
    assert s["pages_in_use"] == len(
        {pid for chain in engine._prefix._entries.values() for pid in chain})


def test_engine_default_device_is_cuda(params):
    """Entry points run on the card unless the caller asks for the CPU:
    without a CUDA device the default raises instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(CFG, params, num_slots=1, context_len=L)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.build_program(CFG)


# -- serve program --------------------------------------------------------------

def test_engine_server_generate_returns_numpy():
    server = tserve.EngineServer(CFG, max_new=3, num_slots=2, context_len=16,
                                 device="cpu")
    try:
        out = server.generate(np.arange(5, dtype=np.int32))
        assert isinstance(out, np.ndarray) and out.dtype == np.int32
        assert out.shape == (8,)
        assert server.health()["status"] == "ok"
    finally:
        server._engine.stop()


@pytest.mark.parametrize("page_size", [None, 4])
def test_build_program_serves_every_request(tmp_path, page_size):
    summary = tmp_path / "meter.json"
    program = tserve.build_program(CFG, num_clients=2, requests_per_client=3,
                                   prompt_len=6, max_new=4,
                                   page_size=page_size,
                                   meter_json=str(summary), device="cpu")
    lp.launch_and_wait(program, timeout_s=120)
    got = json.loads(summary.read_text())
    assert got["count"] == 6
    assert got["out_lens"] == [10] * 6


def test_fabric_options_raise_not_implemented():
    for kw in (dict(routers=1), dict(kill_after=1), dict(store_dir="x"),
               dict(telemetry_dir="x")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tserve.build_program(CFG, device="cpu", **kw)


def test_courier_sends_cpu_tensors_as_numpy_and_refuses_device_tensors():
    """The port's serialization: a CPU tensor travels out-of-band as its
    numpy view (framed and legacy formats); a tensor on any other device
    raises TypeError instead of pickling a device buffer."""
    from repro_torch.core.courier import serialization as ser
    t = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    for legacy in (False, True):
        method, args, kwargs = ser.decode_call(
            ser.encode_call("f", (t,), {"x": [t[0]]}, legacy=legacy))
        assert isinstance(args[0], np.ndarray)
        np.testing.assert_array_equal(args[0], t.numpy())
        np.testing.assert_array_equal(kwargs["x"][0], t[0].numpy())
    assert len(ser.encode_frames((t,))) == 2         # one out-of-band buffer
    with pytest.raises(TypeError, match="meta tensors"):
        ser.dumps(t.to("meta"))


# -- import hygiene ------------------------------------------------------------------

def _run_py(code: str) -> str:
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def test_port_imports_no_jax_and_no_repro():
    out = _run_py("""
        import sys, numpy as np, torch
        torch.set_num_threads(1)
        import repro_torch
        from repro_torch import configs
        from repro_torch.models import transformer
        from repro_torch.serve import decode
        cfg = configs.get_reduced("qwen2-1.5b")
        params = transformer.init_params(cfg, seed=0, device="cpu")
        out = decode.generate(cfg, params, torch.zeros((1, 4), dtype=torch.int32),
                              max_new=3, attn_impl="flash")
        assert out.shape == (1, 7)
        bad = [m for m in sys.modules
               if m == "jax" or m.startswith("jax.")
               or m == "repro" or m.startswith("repro.")]
        print("BAD", bad)
    """)
    assert "BAD []" in out


def test_core_and_thread_serve_run_without_grpc_and_cloudpickle():
    out = _run_py("""
        import importlib.abc, sys
        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("grpc", "cloudpickle"):
                    raise ImportError(f"{name} blocked")
                return None
        sys.meta_path.insert(0, Block())
        import torch
        torch.set_num_threads(1)
        import repro_torch.core as lp
        from repro_torch import configs
        from repro_torch.launch import serve
        cfg = configs.get_reduced("qwen2-1.5b")
        p = serve.build_program(cfg, num_clients=1, requests_per_client=2,
                                prompt_len=5, max_new=3, device="cpu")
        lp.launch_and_wait(p, timeout_s=120)
        print("MODS", [m for m in sys.modules
                       if m.split(".")[0] in ("grpc", "cloudpickle")])
    """)
    assert "served 2 requests" in out
    assert "MODS []" in out
