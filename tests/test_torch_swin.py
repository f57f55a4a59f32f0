"""The port's Swin (fastertransformer4codefuse_tpu_torch/models/swin.py)
against the JAX package's models/swin.py and HF SwinModel on
tests/test_swin.py's tiny configs, fp32 on the CPU: hidden states and pooled
outputs within the JAX test's rtol 3e-4 / atol 3e-5 of HF and atol 2e-4 /
rtol 1e-4 of the JAX package; window partition and merge (and the shifted
window mask) equal the JAX functions' on drawn shapes, and merge undoes
partition."""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax.numpy as jnp

from fastertransformer4codefuse_tpu.models import swin as jswin
from fastertransformer4codefuse_tpu_torch.models import registry, swin
from fastertransformer4codefuse_tpu_torch.models.params import param_bytes, params_to
from test_swin import make_hf

torch.set_num_threads(2)
JAX_TOL = dict(atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("seed,kw,B", [(0, {}, 2), (2, dict(window_size=4), 1)])
def test_matches_hf_and_jax(seed, kw, B):
    """Window 2: the odd blocks run shifted windows with the region mask and
    patch merging halves the resolution; window 4: the last stage's window
    covers it, the shift off."""
    hf = make_hf(seed=seed, **kw)
    cfg = swin.config_from_hf_swin(hf.config)
    params = swin.params_from_hf_swin_state_dict(cfg, hf.state_dict(), device="cpu")
    jcfg = jswin.config_from_hf_swin(hf.config)
    jparams = jswin.params_from_hf_swin_state_dict(jcfg, hf.state_dict())
    px = np.random.RandomState(seed + 1).randn(B, 3, 16, 16).astype(np.float32)
    with torch.no_grad():
        out = hf(pixel_values=torch.from_numpy(px))
    got_h, got_p = swin.encode(cfg, params, px)
    want_h, want_p = jswin.encode(jcfg, jparams, jnp.asarray(px))
    np.testing.assert_allclose(got_h.numpy(), out.last_hidden_state.numpy(), rtol=3e-4, atol=3e-5)
    np.testing.assert_allclose(got_p.numpy(), out.pooler_output.numpy(), rtol=3e-4, atol=3e-5)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **JAX_TOL)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), **JAX_TOL)


@settings(max_examples=12, deadline=None)
@given(B=st.integers(1, 2), M=st.integers(1, 4), gh=st.integers(1, 3), gw=st.integers(1, 3),
       C=st.integers(1, 5))
def test_window_partition_and_merge_equal_jax_and_round_trip(B, M, gh, gw, C):
    H, W = gh * M, gw * M
    x = np.random.default_rng(B * 100 + M * 10 + C).standard_normal((B, H, W, C)).astype(
        np.float32)
    wins = swin._window_partition(torch.from_numpy(x), M)
    np.testing.assert_array_equal(wins.numpy(),
                                  np.asarray(jswin._window_partition(jnp.asarray(x), M)))
    back = swin._window_merge(wins, M, H, W)
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jswin._window_merge(jnp.asarray(wins.numpy()), M, H, W)))


@pytest.mark.parametrize("H,W,M,shift", [(8, 8, 2, 1), (8, 4, 4, 2), (14, 14, 7, 3)])
def test_shift_mask_equals_jax(H, W, M, shift):
    np.testing.assert_array_equal(swin._shift_mask(H, W, M, shift).numpy(),
                                  np.asarray(jswin._shift_mask(H, W, M, shift)))


def test_registry_serves_swin():
    fam = registry.get("swin")
    assert fam.encode is swin.encode and fam.decode_step is None
    hf = make_hf(seed=0)
    cfg = fam.config_from_hf(hf.config)
    params = fam.params_from_hf(cfg, hf.state_dict(), device="cpu")
    assert params["stages"][0]["blocks"][0]["bias_index"].dtype == torch.int64
    h, p = fam.encode(cfg, params, np.zeros((1, 3, 16, 16), np.float32))
    assert h.shape[0] == 1 and p.shape == (1, h.shape[-1])
    # params_to and param_bytes walk the stage and block lists
    half = params_to(params, "cpu", dtype="bf16")
    blk = half["stages"][1]["blocks"][1]
    assert blk["q_w"].dtype == torch.bfloat16 and blk["bias_index"].dtype == torch.int64
    assert param_bytes(half) < param_bytes(params)
