"""AWQ calibration in the port (fastertransformer4codefuse_tpu_torch/ckpt/
calibrate.py) against the JAX package's, on the cases of
tests/test_calibrate.py: the recorded per-layer amax of each linear, the
searched scales, the fp-exact fold, the quality win on outlier channels, and
calibrate -> fold -> int4 quantize -> generate. The same JAX-made fp32
weights go to both.

Tolerance: stats within 1e-5 relative of JAX's (the port records on its
unfused route, keyed by weight; fp32 summation order only); scales within
1e-5 relative (the same alpha picked); the folded model's greedy tokens
identical to the unfolded one's and its cumulative log-probs within 2e-3, as
the JAX test asks; the AWQ error under 0.6 of round-to-nearest's."""
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
from fastertransformer4codefuse_tpu.ckpt import calibrate as jcal
from fastertransformer4codefuse_tpu.ckpt.quantize import quantize_params as jax_quantize_params
from fastertransformer4codefuse_tpu_torch import (
    GptNeoXConfig,
    GptNeoXEngine,
    RuntimeConfig,
    from_jax_params,
)
from fastertransformer4codefuse_tpu_torch.ckpt import calibrate as tcal
from fastertransformer4codefuse_tpu_torch.ckpt.quantize import quantize_params

torch.set_num_threads(2)

BATCHES = [[[3, 4, 5, 9, 11], [7, 8, 20]], [[31, 9, 17, 2]]]


@pytest.fixture(scope="module")
def setup():
    jcfg = JaxConfig.tiny(vocab_size=96)
    cfg = GptNeoXConfig(**{f.name: getattr(jcfg, f.name)
                           for f in dataclasses.fields(GptNeoXConfig)})
    jp = jax_init_params(jcfg, dtype="fp32")
    tp = from_jax_params(jp, device="cpu")
    jstats = jcal.collect_activation_stats(jcfg, jp, BATCHES, jnp.float32)
    tstats = tcal.collect_activation_stats(cfg, tp, BATCHES, torch.float32)
    return jcfg, cfg, jp, tp, jstats, tstats


def test_collect_stats_match_jax(setup):
    jcfg, cfg, jp, tp, jstats, tstats = setup
    H, I = cfg.hidden_size, cfg.inter_size
    assert set(tstats) == set(jstats) == {"qkv", "proj", "up", "down"}
    for k, shape in (("qkv", H), ("proj", H), ("up", H), ("down", I)):
        assert tstats[k].shape == (cfg.layer_num, shape)
        np.testing.assert_allclose(tstats[k], jstats[k], rtol=1e-5, atol=1e-7)
        assert (tstats[k] > 0).any()


def test_collect_stats_match_manual_and_ignore_the_route(setup):
    """Layer 0's qkv amax is at least this batch's ln1(embeddings) amax, and
    the stats do not depend on the routes the engine would take."""
    jcfg, cfg, jp, tp, jstats, tstats = setup
    ids = np.asarray([BATCHES[0][0]])
    x = np.asarray(jp["embed"])[ids]
    lw, lb = np.asarray(jp["layers"]["ln1_w"][0]), np.asarray(jp["layers"]["ln1_b"][0])
    mu, var = x.mean(-1, keepdims=True), x.var(-1, keepdims=True)
    manual = np.abs((x - mu) / np.sqrt(var + cfg.layernorm_eps) * lw + lb).max(axis=(0, 1))
    assert (tstats["qkv"][0] >= manual - 1e-5).all()
    # int8 weights (the fused route where the engine serves them) record the
    # same calls, keyed by weight whatever the call order
    q = quantize_params(tp)
    qs = tcal.collect_activation_stats(cfg, q, BATCHES, torch.float32)
    jq = jcal.collect_activation_stats(jcfg, jax_quantize_params(jp), BATCHES, jnp.float32)
    for k in qs:
        np.testing.assert_allclose(qs[k], jq[k], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("bits,G", [(4, 0), (4, 32), (8, 0)])
def test_awq_scales_match_jax(setup, bits, G):
    jcfg, cfg, jp, tp, jstats, tstats = setup
    for key, st in (("qkv_w", "qkv"), ("up_w", "up")):
        for l in range(cfg.layer_num):
            w = np.array(jp["layers"][key][l])
            want = jcal.awq_search_scales(w, jstats[st][l], bits, G)
            got = tcal.awq_search_scales(torch.from_numpy(w), tstats[st][l], bits, G)
            np.testing.assert_allclose(got, want, rtol=1e-5)


def test_awq_fold_is_fp_exact_and_matches_jax(setup):
    jcfg, cfg, jp, tp, jstats, tstats = setup
    scaled = tcal.apply_awq_scaling(cfg, tp, tstats, weight_bits=4)
    jscaled = jcal.apply_awq_scaling(jcfg, jp, jstats, weight_bits=4)
    for k in ("qkv_w", "up_w", "ln1_w", "ln1_b", "ln2_w", "ln2_b"):
        np.testing.assert_allclose(scaled["layers"][k].numpy(), np.asarray(jscaled["layers"][k]),
                                   rtol=1e-5, atol=1e-7)
    rt = RuntimeConfig(dtype="fp32", seq_bucket=8)
    ra = GptNeoXEngine(cfg, tp, rt).generate([[3, 4, 5, 9]], output_len=6, top_k=1,
                                             return_cum_log_probs=True)
    rb = GptNeoXEngine(cfg, scaled, rt).generate([[3, 4, 5, 9]], output_len=6, top_k=1,
                                                 return_cum_log_probs=True)
    np.testing.assert_array_equal(ra.output_ids, rb.output_ids)
    np.testing.assert_allclose(ra.cum_log_probs, rb.cum_log_probs, atol=2e-3)


def test_awq_beats_rtn_on_outlier_channels():
    rng = np.random.default_rng(0)
    K, N = 256, 512
    w = rng.standard_normal((K, N)).astype(np.float32)
    amax = np.full((K,), 1.0, np.float32)
    outliers = rng.choice(K, size=8, replace=False)
    amax[outliers] = 50.0

    def weighted_err(s):
        ws = w * s[:, None]
        scale = np.abs(ws).max(axis=0, keepdims=True) / 7
        deq = np.rint(ws / scale).clip(-8, 7) * scale / s[:, None]
        return float(np.sum(((deq - w) * amax[:, None]) ** 2))

    s = tcal.awq_search_scales(w, amax, weight_bits=4, group_size=0)
    np.testing.assert_allclose(s, jcal.awq_search_scales(w, amax, 4, 0), rtol=1e-5)
    assert weighted_err(s) < 0.6 * weighted_err(np.ones(K, np.float32))
    assert (s[outliers] > 1.0).all()


@pytest.mark.parametrize("G", [0, 32])
def test_awq_then_quantize_generates_the_jax_tokens(setup, G):
    """calibrate -> fold -> int4 quantize -> generate: the JAX flow's tokens."""
    jcfg, cfg, jp, tp, jstats, tstats = setup
    jq = jax_quantize_params(jcal.apply_awq_scaling(jcfg, jp, jstats, 4, G), weight_bits=4,
                             group_size=G)
    rt = dict(dtype="fp32", int8_mode=1, seq_bucket=8)
    want = JaxEngine(jcfg, jq, JaxRuntime(**rt)).generate([[3, 4, 5]], output_len=4, top_k=1)
    q = quantize_params(tcal.apply_awq_scaling(cfg, tp, tstats, 4, G), weight_bits=4,
                        group_size=G)
    got = GptNeoXEngine(cfg, q, RuntimeConfig(**rt)).generate([[3, 4, 5]], output_len=4,
                                                               top_k=1)
    assert int(got.sequence_lengths[0, 0]) >= 4
    np.testing.assert_array_equal(got.output_ids, np.asarray(want.output_ids))


def _gated(**over):
    jcfg = JaxConfig.tiny(vocab_size=96, gated_ffn=True, activation="silu", **over)
    cfg = GptNeoXConfig(**{f.name: getattr(jcfg, f.name)
                           for f in dataclasses.fields(GptNeoXConfig)})
    jp = jax_init_params(jcfg, dtype="fp32")
    return jcfg, cfg, jp, from_jax_params(jp, device="cpu")


def _prefill_logits(cfg, p, ids):
    from fastertransformer4codefuse_tpu_torch.engine import kv_cache as kvc
    from fastertransformer4codefuse_tpu_torch.models import gptneox as tm

    B, S = ids.shape
    h, _ = tm.prefill(cfg, p, torch.from_numpy(ids), torch.full((B,), S, dtype=torch.int32),
                      kvc.init_cache(cfg, B, S, torch.float32, "cpu"))
    return tm.lm_logits(cfg, p, h).numpy()


@pytest.mark.parametrize("norm", ["layernorm", "rmsnorm"])
def test_gated_stats_match_jax(norm):
    """A gated block makes five linear calls (qkv, proj, gate, up, down, JAX
    ``_BLOCK_CALL_ORDER_GATED``): the port records the gate too, and gate
    and up read the same ln2 output."""
    over = {} if norm == "layernorm" else dict(norm="rmsnorm", use_bias=False,
                                               use_gptj_residual=False)
    jcfg, cfg, jp, tp = _gated(**over)
    js = jcal.collect_activation_stats(jcfg, jp, BATCHES, jnp.float32)
    ts = tcal.collect_activation_stats(cfg, tp, BATCHES, torch.float32)
    assert set(ts) == set(js) == {"qkv", "proj", "gate", "up", "down"}
    for k in js:
        np.testing.assert_allclose(ts[k], js[k], rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(ts["gate"], ts["up"])


def test_gated_awq_fold_is_fp_exact_where_the_jax_fold_is_not():
    """The JAX fold (``apply_awq_scaling``) scales up_w and ln2 but not
    gate_w, which reads the same ln2 output: a gated model's float forward
    moves. The port scales gate_w by up_w's scales: its qkv, up and norm
    tensors are the JAX fold's, its gate_w the JAX one times those scales,
    and its logits the unfolded model's within 2e-4 where the JAX fold's
    part by more than 1e-2 of max |logits|."""
    jcfg, cfg, jp, tp = _gated()
    st = jcal.collect_activation_stats(jcfg, jp, BATCHES, jnp.float32)
    got = tcal.apply_awq_scaling(cfg, tp, st, weight_bits=4)
    want = jcal.apply_awq_scaling(jcfg, jp, st, weight_bits=4)
    for k in ("qkv_w", "up_w", "ln1_w", "ln1_b", "ln2_w", "ln2_b"):
        np.testing.assert_allclose(got["layers"][k].numpy(), np.asarray(want["layers"][k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    s = np.asarray(jp["layers"]["ln2_w"]) / np.asarray(want["layers"]["ln2_w"])  # [L, H]
    np.testing.assert_allclose(got["layers"]["gate_w"].numpy(),
                               np.asarray(jp["layers"]["gate_w"]) * s[:, :, None], rtol=1e-5,
                               atol=1e-7)
    ids = np.random.RandomState(2).randint(2, 90, size=(2, 9)).astype(np.int32)
    ref = _prefill_logits(cfg, tp, ids)
    np.testing.assert_allclose(_prefill_logits(cfg, got, ids), ref, atol=2e-4, rtol=1e-4)
    jax_fold = _prefill_logits(cfg, from_jax_params(want, device="cpu"), ids)
    assert np.abs(jax_fold - ref).max() / np.abs(ref).max() > 1e-2


def test_gated_rmsnorm_awq_fold_is_fp_exact():
    """RMSNorm has no norm biases (the JAX fold reads ln1_b and fails): the
    port folds into the weights alone, fp-exact."""
    jcfg, cfg, jp, tp = _gated(norm="rmsnorm", use_bias=False, use_gptj_residual=False)
    st = tcal.collect_activation_stats(cfg, tp, BATCHES, torch.float32)
    with pytest.raises(KeyError):
        jcal.apply_awq_scaling(jcfg, jp, st, weight_bits=4)
    got = tcal.apply_awq_scaling(cfg, tp, st, weight_bits=4, group_size=16)
    assert "ln1_b" not in got["layers"]
    ids = np.random.RandomState(2).randint(2, 90, size=(2, 9)).astype(np.int32)
    np.testing.assert_allclose(_prefill_logits(cfg, got, ids), _prefill_logits(cfg, tp, ids),
                               atol=2e-4, rtol=1e-4)
