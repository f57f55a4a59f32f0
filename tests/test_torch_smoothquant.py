"""SmoothQuant W8A8 in the port (fastertransformer4codefuse_tpu_torch/ckpt/
smoothquant.py, ops/linear.w8a8_matmul and the ``RuntimeConfig.act_int8``
routes of models/gptneox.py) against the JAX package, on the cases of
tests/test_smoothquant.py (the ``gated`` fold included: tensor for tensor,
then fp-exact through the port's gated forward; and an ``act_int8`` gated
engine against the JAX one), and two of the port's own: the flag is per engine (no process-wide state leaks from
one engine to the next), and which calls take W8A8 (sequence-wide, at least
16 rows, int8 per-channel weights: prefill, chunk ticks, wide verifies; never
decode, int4 or group-wise weights).

Tolerance: the fold's tensors within 1e-6 relative of JAX's (fp32; powers
may differ in the last bit) and fp-exact (logits within 2e-4 of the unfolded
model's, as the JAX test asks); ``w8a8_matmul`` within 1e-6 relative of
JAX's on the same inputs (the same int32 sums, the same fp32 products) and
under 0.03 of the float product; an ``act_int8`` engine's logits within
1e-4 relative of the JAX ``act_int8`` engine's, its greedy tokens identical
and its cumulative log-probs within 0.05 of the weight-only engine's."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastertransformer4codefuse_tpu import GptNeoXConfig as JaxConfig
from fastertransformer4codefuse_tpu import GptNeoXEngine as JaxEngine
from fastertransformer4codefuse_tpu import RuntimeConfig as JaxRuntime
from fastertransformer4codefuse_tpu import init_params as jax_init_params
from fastertransformer4codefuse_tpu.ckpt import smoothquant as jsq
from fastertransformer4codefuse_tpu.ckpt.calibrate import collect_activation_stats as jstats_of
from fastertransformer4codefuse_tpu.ckpt.quantize import quantize_params as jax_quantize
from fastertransformer4codefuse_tpu.models import gptneox as jm
from fastertransformer4codefuse_tpu.ops import linear as jlin
from fastertransformer4codefuse_tpu_torch import (
    GptNeoXConfig,
    GptNeoXEngine,
    RuntimeConfig,
    from_jax_params,
)
from fastertransformer4codefuse_tpu_torch.ckpt import smoothquant as tsq
from fastertransformer4codefuse_tpu_torch.ckpt.calibrate import collect_activation_stats
from fastertransformer4codefuse_tpu_torch.ckpt.quantize import quantize_params
from fastertransformer4codefuse_tpu_torch.engine import kv_cache as kvc
from fastertransformer4codefuse_tpu_torch.models import gptneox as tm
from fastertransformer4codefuse_tpu_torch.ops import linear as tlin

torch.set_num_threads(2)


def calib_batches():
    rng = np.random.RandomState(0)
    return [[list(rng.randint(2, 60, size=12)) for _ in range(2)]]


def _cfg(jcfg):
    return GptNeoXConfig(**{f.name: getattr(jcfg, f.name)
                            for f in dataclasses.fields(GptNeoXConfig)})


@pytest.fixture(scope="module")
def smoothed():
    """A tiny model, its stats (port and JAX), both folds, int8 quantized."""
    jcfg = JaxConfig.tiny(vocab_size=64)
    jp = jax_init_params(jcfg, dtype="fp32")
    cfg, tp = _cfg(jcfg), from_jax_params(jp, device="cpu")
    stats = collect_activation_stats(cfg, tp, calib_batches(), torch.float32)
    jst = jstats_of(jcfg, jp, calib_batches(), jnp.float32)
    js = jsq.apply_smoothquant_scaling(jcfg, jp, jst)
    ts = tsq.apply_smoothquant_scaling(cfg, tp, stats)
    return jcfg, cfg, jp, tp, js, ts


def test_smoothquant_scales_balance_and_match_jax():
    rng = np.random.RandomState(1)
    w = rng.randn(16, 8).astype(np.float32)
    amax = np.abs(rng.randn(16)).astype(np.float32) * 10
    s = tsq.smoothquant_scales(amax, w, alpha=0.5).numpy()
    assert s.shape == (16,)
    np.testing.assert_allclose(amax / s, np.abs(w).max(axis=1) * s, rtol=1e-4)
    for alpha in (0.5, 0.8):
        np.testing.assert_allclose(tsq.smoothquant_scales(amax, torch.from_numpy(w), alpha),
                                   jsq.smoothquant_scales(amax, w, alpha), rtol=1e-6)


@pytest.mark.parametrize("gated", [False, True])
def test_smoothquant_fold_is_fp_exact_and_matches_jax(gated):
    jcfg = JaxConfig.tiny(
        vocab_size=64,
        **(dict(norm="rmsnorm", gated_ffn=True, use_bias=False,
                use_gptj_residual=False, activation="silu") if gated else {}),
    )
    jp = jax_init_params(jcfg, dtype="fp32")
    stats = jstats_of(jcfg, jp, calib_batches(), jnp.float32)
    want = jsq.apply_smoothquant_scaling(jcfg, jp, stats)
    got = tsq.apply_smoothquant_scaling(_cfg(jcfg), from_jax_params(jp, device="cpu"), stats)
    for k, v in want["layers"].items():
        np.testing.assert_allclose(got["layers"][k].numpy(), np.asarray(v), rtol=1e-6,
                                   atol=1e-9, err_msg=k)
    cfg = _cfg(jcfg)
    ids = torch.from_numpy(np.random.RandomState(2).randint(2, 60, size=(2, 9)).astype(np.int32))
    lens = torch.full((2,), 9, dtype=torch.int32)
    logits = []
    for p in (from_jax_params(jp, device="cpu"), got):
        h, _ = tm.prefill(cfg, p, ids, lens, kvc.init_cache(cfg, 2, 9, torch.float32, "cpu"))
        logits.append(tm.lm_logits(cfg, p, h).numpy())
    np.testing.assert_allclose(logits[1], logits[0], atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("M", [16, 17, 32, 3])
def test_w8a8_matmul_matches_jax(M):
    rng = np.random.RandomState(3)
    x = rng.randn(M, 64).astype(np.float32)
    x[1] = 0.0  # a zero row: s_x 1
    wf = rng.randn(64, 48).astype(np.float32)
    scale = (np.abs(wf).max(axis=0) / 127.0).astype(np.float32)
    q = np.rint(wf / scale).astype(np.int8)
    b = rng.randn(48).astype(np.float32) * 0.1
    want = np.asarray(jlin.w8a8_matmul(jnp.asarray(x), jnp.asarray(q), jnp.asarray(scale),
                                       bias=jnp.asarray(b), act="gelu-tanh"))
    got = tlin.w8a8_matmul(torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(scale),
                           bias=torch.from_numpy(b), act="gelu-tanh").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    plain = tlin.w8a8_matmul(torch.from_numpy(x), torch.from_numpy(q),
                             torch.from_numpy(scale)).numpy()
    assert np.abs(plain - x @ wf).max() / np.abs(x @ wf).max() < 0.03


def test_act_int8_engine_matches_jax_and_weight_only(smoothed):
    """int8 weights + act_int8: the prefill (24 rows) rides W8A8; logits and
    tokens are the JAX act_int8 engine's, and the greedy continuation the
    weight-only engine's, scores within 0.05."""
    jcfg, cfg, jp, tp, js, ts = smoothed
    jq, tq = jax_quantize(js), from_jax_params(jax_quantize(js), device="cpu")
    prompt = [list(range(3, 20))]
    ref = GptNeoXEngine(cfg, tq, RuntimeConfig(dtype="fp32", int8_mode=1, seq_bucket=8)
                        ).generate(prompt, output_len=6, top_k=1, return_cum_log_probs=True)
    eng = GptNeoXEngine(cfg, tq, RuntimeConfig(dtype="fp32", int8_mode=1, act_int8=True,
                                               seq_bucket=8))
    out = eng.generate(prompt, output_len=6, top_k=1, return_cum_log_probs=True)
    np.testing.assert_array_equal(ref.output_ids, out.output_ids)
    np.testing.assert_allclose(ref.cum_log_probs, out.cum_log_probs, atol=0.05)
    try:
        jout = JaxEngine(jcfg, jq, JaxRuntime(dtype="fp32", int8_mode=1, act_int8=True,
                                              seq_bucket=8)
                         ).generate(prompt, output_len=6, top_k=1, return_cum_log_probs=True)
        ids = jnp.asarray(np.array(prompt * 2, np.int32))
        lens = jnp.full((2,), 17, jnp.int32)
        h, _ = jm.prefill(jcfg, jq, ids, lens, jm.init_kv_cache(jcfg, 2, 17, jnp.float32))
        jl = np.asarray(jm.lm_logits(jcfg, jq, h))
    finally:
        jlin.set_act_int8(False)  # the JAX flag is process-wide
    np.testing.assert_array_equal(out.output_ids, np.asarray(jout.output_ids))
    np.testing.assert_allclose(out.cum_log_probs, np.asarray(jout.cum_log_probs), atol=1e-4)
    th, _ = tm.prefill(cfg, tq, torch.from_numpy(np.array(prompt * 2, np.int32)),
                       torch.full((2,), 17, dtype=torch.int32),
                       kvc.init_cache(cfg, 2, 17, torch.float32, "cpu"), a8=True)
    tl = tm.lm_logits(cfg, tq, th).numpy()
    assert np.abs(tl - jl).max() / np.abs(jl).max() < 1e-4


def test_act_int8_gated_engine_matches_jax(monkeypatch):
    """A gated (SwiGLU, RMSNorm) model folded and int8-quantized: under
    act_int8 its prefill runs five W8A8 GEMMs a layer (qkv, proj, gate, up,
    down), and its logits and tokens are the JAX act_int8 engine's."""
    jcfg = JaxConfig.tiny(vocab_size=64, norm="rmsnorm", gated_ffn=True, use_bias=False,
                          use_gptj_residual=False, activation="silu")
    jp = jax_init_params(jcfg, dtype="fp32")
    jq = jax_quantize(jsq.apply_smoothquant_scaling(
        jcfg, jp, jstats_of(jcfg, jp, calib_batches(), jnp.float32)))
    cfg, tq = _cfg(jcfg), from_jax_params(jq, device="cpu")
    prompt = [list(range(3, 20))]
    calls = _spy(monkeypatch)
    out = GptNeoXEngine(cfg, tq, RuntimeConfig(dtype="fp32", int8_mode=1, act_int8=True,
                                               seq_bucket=8)
                        ).generate(prompt, output_len=6, top_k=1, return_cum_log_probs=True)
    assert len(calls) == 5 * cfg.layer_num
    try:
        jout = JaxEngine(jcfg, jq, JaxRuntime(dtype="fp32", int8_mode=1, act_int8=True,
                                              seq_bucket=8)
                         ).generate(prompt, output_len=6, top_k=1, return_cum_log_probs=True)
        h, _ = jm.prefill(jcfg, jq, jnp.asarray(np.array(prompt, np.int32)),
                          jnp.full((1,), 17, jnp.int32), jm.init_kv_cache(jcfg, 1, 17, jnp.float32))
        jl = np.asarray(jm.lm_logits(jcfg, jq, h))
    finally:
        jlin.set_act_int8(False)  # the JAX flag is process-wide
    np.testing.assert_array_equal(out.output_ids, np.asarray(jout.output_ids))
    np.testing.assert_allclose(out.cum_log_probs, np.asarray(jout.cum_log_probs), atol=1e-4)
    th, _ = tm.prefill(cfg, tq, torch.from_numpy(np.array(prompt, np.int32)),
                       torch.full((1,), 17, dtype=torch.int32),
                       kvc.init_cache(cfg, 1, 17, torch.float32, "cpu"), a8=True)
    tl = tm.lm_logits(cfg, tq, th).numpy()
    assert np.abs(tl - jl).max() / np.abs(jl).max() < 1e-4


def _spy(monkeypatch):
    calls = []
    real = tlin.w8a8_matmul

    def spy(x2d, *a, **k):
        calls.append(x2d.shape[0])
        return real(x2d, *a, **k)

    monkeypatch.setattr(tlin, "w8a8_matmul", spy)
    return calls


def test_act_int8_decode_width_stays_weight_only(smoothed, monkeypatch):
    """Prefill calls take W8A8; decode steps (1 row a request) never do."""
    jcfg, cfg, jp, tp, js, ts = smoothed
    q = quantize_params(ts)
    calls = _spy(monkeypatch)
    eng = GptNeoXEngine(cfg, q, RuntimeConfig(dtype="fp32", int8_mode=1, act_int8=True,
                                              seq_bucket=8))
    out = eng.generate([list(range(3, 20))], output_len=4, top_k=1)
    assert calls and min(calls) >= tlin.A8_MIN_M
    assert len(calls) == 4 * cfg.layer_num  # qkv, proj, up, down of the one prefill
    assert eng.decode_forwards == 3 and int(out.sequence_lengths[0, 0]) == 21
    calls.clear()
    eng.generate([[3, 4, 5]], output_len=3, top_k=1)  # 8 rows: under A8_MIN_M
    assert not calls


@pytest.mark.parametrize("bits,G", [(4, 0), (4, 32), (8, 32)])
def test_int4_and_groupwise_stay_weight_only_under_act_int8(smoothed, monkeypatch, bits, G):
    jcfg, cfg, jp, tp, js, ts = smoothed
    q = quantize_params(ts, weight_bits=bits, group_size=G)
    calls = _spy(monkeypatch)
    eng = GptNeoXEngine(cfg, q, RuntimeConfig(dtype="fp32", int8_mode=1, act_int8=True,
                                              seq_bucket=8))
    if bits == 8:  # group-wise int8 is on no served path (item 11)
        with pytest.raises(NotImplementedError):
            eng.generate([list(range(3, 20))], output_len=3, top_k=1)
    else:
        eng.generate([list(range(3, 20))], output_len=3, top_k=1)
    assert not calls


def test_act_int8_is_per_engine(smoothed, monkeypatch):
    """Two engines over the same weights, one with act_int8: each keeps its
    own route in any order (the JAX flag is one process-wide global, which
    the JAX tests reset by hand)."""
    jcfg, cfg, jp, tp, js, ts = smoothed
    q = quantize_params(ts)
    calls = _spy(monkeypatch)
    a8 = GptNeoXEngine(cfg, q, RuntimeConfig(dtype="fp32", int8_mode=1, act_int8=True,
                                             seq_bucket=8))
    wo = GptNeoXEngine(cfg, q, RuntimeConfig(dtype="fp32", int8_mode=1, seq_bucket=8))
    prompt = [list(range(3, 20))]
    first = wo.generate(prompt, output_len=3, top_k=1, return_cum_log_probs=True)
    assert not calls
    a8.generate(prompt, output_len=3, top_k=1)
    n = len(calls)
    assert n == 4 * cfg.layer_num
    again = wo.generate(prompt, output_len=3, top_k=1, return_cum_log_probs=True)
    assert len(calls) == n  # nothing leaked into the weight-only engine
    np.testing.assert_array_equal(first.output_ids, again.output_ids)
    assert first.cum_log_probs.tolist() == again.cum_log_probs.tolist()


def test_act_int8_chunk_ticks_and_verifies(smoothed, monkeypatch):
    """A pool's chunk ticks (2 slots x 8 rows = 16) and a speculative verify of
    B = 2 rows x 9 take W8A8 under act_int8; the pool's decode ticks do not.
    The pool's greedy tokens equal the act_int8 static engine's where the
    prefill widths agree (both run the prompt's chunks of 8 rows)."""
    from fastertransformer4codefuse_tpu_torch.engine.batcher import ContinuousBatcher
    from fastertransformer4codefuse_tpu_torch.engine.speculative import (
        speculative_generate_batched,
    )

    jcfg, cfg, jp, tp, js, ts = smoothed
    q = quantize_params(ts)
    calls = _spy(monkeypatch)
    eng = GptNeoXEngine(cfg, q, RuntimeConfig(dtype="fp32", int8_mode=1, act_int8=True,
                                              seq_bucket=8))
    cb = ContinuousBatcher(eng, max_slots=2, max_seq_len=32, prompt_bucket=8)
    for p in ([3, 4, 5, 6, 7, 8, 9, 10, 11], [12, 13, 14, 15, 16, 17, 18, 19, 20]):
        cb.submit(p, 4, top_k=1)
    cb.run(max_ticks=50)
    assert calls and set(calls) == {16}  # the one chunk tick of both slots
    calls.clear()
    speculative_generate_batched(eng, [[3, 4, 5, 3, 4, 5, 3, 4], [6, 7, 6, 7, 6, 7, 6, 7]], 6,
                                 k=8)
    assert calls and min(calls) >= 16
