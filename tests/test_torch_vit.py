"""The port's ViT (fastertransformer4codefuse_tpu_torch/models/vit.py) against
the JAX package's models/vit.py and HF ViTModel on tests/test_vit.py's tiny
config, fp32 on the CPU. Tolerances: against HF the JAX test's own (rtol
2e-4 / atol 2e-5; the patch GEMM against HF's conv rtol 2e-5 / atol 2e-6);
against the JAX package atol 2e-4 / rtol 1e-4."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fastertransformer4codefuse_tpu.models import vit as jvit
from fastertransformer4codefuse_tpu_torch.models import registry, vit
from fastertransformer4codefuse_tpu_torch.ops.linear import linear
from test_vit import make_hf

torch.set_num_threads(2)
JAX_TOL = dict(atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("seed,B", [(0, 2), (4, 1)])
def test_matches_hf_and_jax(seed, B):
    hf = make_hf(seed=seed)
    cfg = vit.config_from_hf_vit(hf.config)
    params = vit.params_from_hf_vit_state_dict(cfg, hf.state_dict(), device="cpu")
    jcfg = jvit.config_from_hf_vit(hf.config)
    jparams = jvit.params_from_hf_vit_state_dict(jcfg, hf.state_dict())
    px = np.random.RandomState(seed + 1).randn(B, 3, 16, 16).astype(np.float32)
    with torch.no_grad():
        out = hf(pixel_values=torch.from_numpy(px))
    got_h, got_p = vit.encode(cfg, params, px)
    want_h, want_p = jvit.encode(jcfg, jparams, jnp.asarray(px))
    np.testing.assert_allclose(got_h.numpy(), out.last_hidden_state.numpy(), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got_p.numpy(), out.pooler_output.numpy(), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **JAX_TOL)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), **JAX_TOL)


def test_patchify_equals_jax_and_the_patch_gemm_hfs_conv():
    hf = make_hf(seed=2)
    cfg = vit.config_from_hf_vit(hf.config)
    params = vit.params_from_hf_vit_state_dict(cfg, hf.state_dict(), device="cpu")
    px = np.random.RandomState(3).randn(2, 3, 16, 16).astype(np.float32)
    patches = vit.patchify(cfg, torch.from_numpy(px))
    np.testing.assert_array_equal(patches.numpy(),
                                  np.asarray(jvit.patchify(cfg, jnp.asarray(px))))
    with torch.no_grad():
        want = hf.embeddings.patch_embeddings(torch.from_numpy(px)).numpy()
    got = linear(patches, params["patch_w"], params["patch_b"])
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-6)


def test_registry_serves_vit_and_params_default_to_the_card(monkeypatch):
    fam = registry.get("vit")
    assert fam.encode is vit.encode and fam.prefill is vit.encode and fam.decode_step is None
    hf = make_hf(seed=0)
    cfg = fam.config_from_hf(hf.config)
    params = fam.params_from_hf(cfg, hf.state_dict(), device="cpu")
    h, p = fam.encode(cfg, params, np.zeros((1, 3, 16, 16), np.float32))
    assert h.shape == (1, 17, 32) and p.shape == (1, 32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fam.params_from_hf(cfg, hf.state_dict())
