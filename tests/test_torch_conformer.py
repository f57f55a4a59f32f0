"""The port's Conformer (fastertransformer4codefuse_tpu_torch/models/conformer.py)
against the JAX package's models/conformer.py and HF Wav2Vec2ConformerModel
on tests/test_conformer.py's tiny configs (gelu, and swish with a longer
window), from the waveform, fp32 on the CPU: within the JAX test's rtol 3e-4
/ atol 3e-5 of HF and atol 2e-4 / rtol 1e-4 of the JAX package; the feature
extractor and the relative attention (its ESPnet shift an explicit gather
here) equal the JAX functions on drawn shapes."""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax.numpy as jnp

from fastertransformer4codefuse_tpu.models import conformer as jconf
from fastertransformer4codefuse_tpu_torch.models import conformer, registry
from test_conformer import make_hf

torch.set_num_threads(2)
JAX_TOL = dict(atol=2e-4, rtol=1e-4)


def _both(hf):
    cfg = conformer.config_from_hf_conformer(hf.config)
    params = conformer.params_from_hf_conformer_state_dict(cfg, hf.state_dict(), device="cpu")
    jcfg = jconf.config_from_hf_conformer(hf.config)
    return cfg, params, jcfg, jconf.params_from_hf_conformer_state_dict(jcfg, hf.state_dict())


@pytest.mark.parametrize("seed,kw,shape", [
    (0, {}, (2, 64)), (2, dict(hidden_act="swish", feat_extract_activation="gelu"), (1, 128))])
def test_matches_hf_and_jax(seed, kw, shape):
    hf = make_hf(seed=seed, **kw)
    cfg, params, jcfg, jparams = _both(hf)
    audio = np.random.RandomState(seed + 1).randn(*shape).astype(np.float32)
    with torch.no_grad():
        want = hf(input_values=torch.from_numpy(audio)).last_hidden_state.numpy()
    got, _ = conformer.encode(cfg, params, audio)
    ref, _ = jconf.encode(jcfg, jparams, jnp.asarray(audio))
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-4, atol=3e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **JAX_TOL)
    feats = conformer.feature_extract(cfg, params, torch.from_numpy(audio))
    np.testing.assert_allclose(feats.numpy(),
                               np.asarray(jconf.feature_extract(jcfg, jparams, jnp.asarray(audio))),
                               **JAX_TOL)


def test_layer_norm_feature_extractor_matches_hf_not_the_jax_packages_group_norm():
    """Fault pinned (ROADMAP queue 3): with feat_extract_norm="layer" (the
    large checkpoints: a LayerNorm over the channels after every conv layer,
    conv biases) the JAX package applies a per-channel GroupNorm over time
    in every layer. The port follows HF."""
    hf = make_hf(seed=4, feat_extract_norm="layer", conv_bias=True)
    cfg, params, jcfg, jparams = _both(hf)
    assert all("ln_w" in fl and "conv_b" in fl for fl in params["feat"])
    audio = np.random.RandomState(5).randn(2, 80).astype(np.float32)
    with torch.no_grad():
        want = hf(input_values=torch.from_numpy(audio)).last_hidden_state.numpy()
    got, _ = conformer.encode(cfg, params, audio)
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-4, atol=3e-5)
    ref, _ = jconf.encode(jcfg, jparams, jnp.asarray(audio))
    assert np.abs(np.asarray(ref) - want).max() > 10 * 3e-4  # ten times the HF tolerance


@settings(max_examples=4, deadline=None)
@given(B=st.integers(1, 2), S=st.integers(1, 10), nH=st.sampled_from([1, 2, 4]),
       dh=st.sampled_from([2, 4]))
def test_rel_attention_equals_jax_on_drawn_shapes(B, S, nH, dh):
    """Random projections and positional biases at drawn shapes: the port's
    relative attention (its ESPnet shift a gather) against the JAX
    function's pad-reshape-drop form."""
    H = nH * dh
    rng = np.random.default_rng(B * 1000 + S * 10 + nH)
    lp = {n: rng.standard_normal(s).astype(np.float32) * 0.5 for n, s in (
        ("q_w", (H, H)), ("q_b", (H,)), ("k_w", (H, H)), ("k_b", (H,)), ("v_w", (H, H)),
        ("v_b", (H,)), ("o_w", (H, H)), ("o_b", (H,)), ("pos_w", (H, H)),
        ("bias_u", (nH, dh)), ("bias_v", (nH, dh)))}
    x = rng.standard_normal((B, S, H)).astype(np.float32)
    cfg = conformer.ConformerConfig(head_num=nH, size_per_head=dh, layer_num=1, inter_size=H,
                                    conv_dim=(H,), conv_stride=(1,), conv_kernel=(1,))
    pe = conformer._rel_pos_emb(H, S)
    np.testing.assert_allclose(pe.numpy(), np.asarray(jconf._rel_pos_emb(H, S)), rtol=0, atol=0)
    got = conformer._rel_attention(cfg, {n: torch.from_numpy(v) for n, v in lp.items()},
                                   torch.from_numpy(x), pe)
    want = jconf._rel_attention(cfg, {n: jnp.asarray(v) for n, v in lp.items()}, jnp.asarray(x),
                                jnp.asarray(pe.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **JAX_TOL)


def test_registry_serves_conformer_and_refuses_other_positions():
    fam = registry.get("conformer")
    assert fam.encode is conformer.encode and fam.decode_step is None
    hf = make_hf(seed=0)
    cfg = fam.config_from_hf(hf.config)
    params = fam.params_from_hf(cfg, hf.state_dict(), device="cpu")
    h, _ = fam.encode(cfg, params, np.zeros((1, 64), np.float32))
    assert h.shape[0] == 1 and h.shape[2] == 32
    with pytest.raises(ValueError, match="relative"):
        conformer.config_from_hf_conformer(make_hf(seed=0, position_embeddings_type="rotary").config)
