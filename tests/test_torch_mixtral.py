"""Mixtral in the port (``registry.get("mixtral")``, ckpt/convert_mixtral.py,
ops/moe.py) on the cases of tests/test_mixtral.py but its expert-parallel
one (ROADMAP item 19): logits and greedy tokens against HF, the capacity
drop, padding that holds no capacity, the ini round trip, the registry; and
against the JAX package: ``moe_ffn`` within 1e-5 of the JAX function on
hypothesis-drawn T, E, k, capacity factors and validity masks (drops
included), fp32 logits within atol=2e-4, rtol=1e-4, greedy tokens equal on
the static engine and a dense pool, ``from_jax_params`` carrying the
expert keys; and the MoE refusals of calibration and SmoothQuant."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from fastertransformer4codefuse_tpu.ops.moe import moe_ffn as jax_moe_ffn
from fastertransformer4codefuse_tpu_torch.ckpt import calibrate, smoothquant
from fastertransformer4codefuse_tpu_torch.ops.moe import moe_ffn

import torch_family_util as fu

torch.set_num_threads(2)


def make_hf_mixtral(seed=0):
    torch.manual_seed(seed)
    cfg = transformers.MixtralConfig(
        vocab_size=96, hidden_size=64, intermediate_size=112, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, num_local_experts=4,
        num_experts_per_tok=2, max_position_embeddings=128, rms_norm_eps=1e-6,
        bos_token_id=0, eos_token_id=95, attn_implementation="eager",
    )
    return transformers.MixtralForCausalLM(cfg).eval()


@pytest.fixture(scope="module")
def mix():
    return fu.convert("mixtral", make_hf_mixtral(seed=3))


def _experts(rng, H, I, E, gated=True):
    t = lambda *s: torch.from_numpy((rng.randn(*s) * 0.1).astype(np.float32))  # noqa: E731
    return (torch.from_numpy(rng.randn(H, E).astype(np.float32)),
            t(E, H, I) if gated else None, t(E, H, I), t(E, I, H))


def _jax(x, ws, *a, **kw):
    r, g, u, d = (None if w is None else jnp.asarray(w.numpy()) for w in ws)
    v = kw.pop("valid", None)
    return np.asarray(jax_moe_ffn(jnp.asarray(x.numpy()), r, g, u, d, *a,
                                  valid=None if v is None else jnp.asarray(v.numpy()), **kw))


def test_mixtral_logits_parity():
    f = fu.convert("mixtral", make_hf_mixtral())
    assert f.cfg.moe_experts == 4 and f.cfg.moe_top_k == 2
    assert f.params["layers"]["eup_w"].shape == (2, 4, 64, 112)
    fu.check_logits(f, hf_atol=1e-3)


def test_mixtral_greedy_parity():
    fu.check_greedy_vs_hf(fu.convert("mixtral", make_hf_mixtral(seed=1)))


def test_mixtral_matches_jax_static_and_dense_pool(mix):
    fu.check_tokens_vs_jax(mix, paged=False)


def test_mixtral_from_jax_params_carries_the_experts(mix):
    assert {"router_w", "egate_w", "eup_w", "edown_w"} <= set(mix.params["layers"])
    fu.check_from_jax_params(mix)


def test_mixtral_capacity_drop_renormalizes():
    """With capacity_factor << 1 the dispatcher drops gracefully (renormalized
    survivors, finite outputs), as the JAX function does."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(16, 8).astype(np.float32))
    ws = _experts(rng, 8, 12, 4)
    full, tight = moe_ffn(x, *ws, 2, 8.0), moe_ffn(x, *ws, 2, 0.25)
    assert torch.isfinite(tight).all() and not torch.allclose(full, tight)
    np.testing.assert_allclose(tight.numpy(), _jax(x, ws, 2, 0.25), atol=1e-5, rtol=1e-5)


def test_moe_padding_does_not_steal_capacity():
    """Padding rows (valid False) hold no expert capacity: the real tokens'
    outputs equal their outputs alone with ample capacity, padding gives 0."""
    rng = np.random.RandomState(5)
    xr = rng.randn(8, 8).astype(np.float32)
    ws = _experts(rng, 8, 12, 4)
    base = moe_ffn(torch.from_numpy(xr), *ws, 2, 8.0)
    x_all = torch.from_numpy(np.concatenate([np.tile(xr[:1], (24, 1)), xr]))
    valid = torch.tensor([False] * 24 + [True] * 8)
    out = moe_ffn(x_all, *ws, 2, 0.5, valid=valid)
    np.testing.assert_allclose(out[24:].numpy(), base.numpy(), atol=1e-5, rtol=1e-5)
    assert out[:24].abs().max().item() == 0.0


@settings(max_examples=25, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(T=st.integers(1, 24), E=st.integers(1, 8), k=st.integers(1, 3),
       factor=st.sampled_from([0.1, 0.25, 0.5, 1.0, 2.0, 8.0]), gated=st.booleans(),
       masked=st.booleans(), seed=st.integers(0, 2**16))
def test_moe_ffn_matches_jax(T, E, k, factor, gated, masked, seed):
    k = min(k, E)
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(T, 8).astype(np.float32))
    ws = _experts(rng, 8, 12, E, gated)
    valid = torch.from_numpy(rng.rand(T) < 0.7) if masked else None
    got = moe_ffn(x, *ws, k, factor, valid=valid).numpy()
    np.testing.assert_allclose(got, _jax(x, ws, k, factor, valid=valid), atol=1e-5, rtol=1e-5)


def test_moe_combine_is_deterministic():
    """Two calls give equal bytes (the combine sums each token's k slots in a
    fixed order; no atomics)."""
    rng = np.random.RandomState(6)
    x = torch.from_numpy(rng.randn(40, 8).astype(np.float32))
    ws = _experts(rng, 8, 12, 4)
    assert torch.equal(moe_ffn(x, *ws, 2, 0.5), moe_ffn(x, *ws, 2, 0.5))


def test_mixtral_calibration_and_smoothquant_refuse_moe(mix):
    with pytest.raises(ValueError, match="MoE"):
        calibrate.collect_activation_stats(mix.cfg, mix.params, [[[3, 4, 5]]], torch.float32)
    with pytest.raises(ValueError, match="MoE"):
        smoothquant.apply_smoothquant_scaling(mix.cfg, mix.params, {})


def test_mixtral_config_ini_roundtrip(tmp_path):
    back = fu.check_ini_roundtrip(fu.convert("mixtral", make_hf_mixtral()).cfg, tmp_path)
    assert back.moe_experts == 4 and back.moe_top_k == 2


def test_mixtral_registry():
    assert fu.check_registry("mixtral", make_hf_mixtral()).moe_experts == 4
