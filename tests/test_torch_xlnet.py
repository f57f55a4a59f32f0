"""The port's XLNet (fastertransformer4codefuse_tpu_torch/models/xlnet.py)
against the JAX package's models/xlnet.py and HF XLNetModel on
tests/test_xlnet.py's tiny config, fp32 on the CPU: the real rows within the
JAX test's rtol 3e-4 / atol 3e-5 of HF and atol 2e-4 / rtol 1e-4 of the JAX
package, with and without segments; the rel-shift, an explicit gather here,
equal to the JAX reshape form on drawn shapes."""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax.numpy as jnp

from fastertransformer4codefuse_tpu.models import xlnet as jxl
from fastertransformer4codefuse_tpu_torch.models import registry, xlnet
from test_xlnet import make_hf

torch.set_num_threads(2)
JAX_TOL = dict(atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("seed,lens,segments", [(0, [12, 8], False), (2, [10], True)])
def test_matches_hf_and_jax(seed, lens, segments):
    hf = make_hf(seed=seed)
    cfg = xlnet.config_from_hf_xlnet(hf.config)
    params = xlnet.params_from_hf_xlnet_state_dict(cfg, hf.state_dict(), device="cpu")
    jcfg = jxl.config_from_hf_xlnet(hf.config)
    jparams = jxl.params_from_hf_xlnet_state_dict(jcfg, hf.state_dict())
    B, S = len(lens), max(lens)
    ids = np.random.RandomState(seed + 1).randint(2, 96, size=(B, S)).astype(np.int64)
    ln = np.asarray(lens, np.int32)
    am = (np.arange(S)[None, :] < ln[:, None]).astype(np.float32)
    tt = (np.arange(S)[None, :] >= S // 2).astype(np.int64).repeat(B, 0) if segments else None
    kw = {} if tt is None else dict(token_type_ids=torch.from_numpy(tt))
    with torch.no_grad():
        want = hf(input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(am),
                  use_mems=False, **kw).last_hidden_state.numpy()
    got, _ = xlnet.encode(cfg, params, ids, ln, token_type_ids=tt)
    ref, _ = jxl.encode(jcfg, jparams, jnp.asarray(ids), jnp.asarray(ln),
                        token_type_ids=None if tt is None else jnp.asarray(tt))
    for b, n in enumerate(lens):
        np.testing.assert_allclose(got.numpy()[b, :n], want[b, :n], rtol=3e-4, atol=3e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **JAX_TOL)


@settings(max_examples=15, deadline=None)
@given(B=st.integers(1, 2), N=st.integers(1, 3), I=st.integers(1, 10), extra=st.integers(1, 12),
       data=st.data())
def test_rel_shift_gather_equals_jax(B, N, I, extra, data):
    J = I + extra
    klen = data.draw(st.integers(1, J - 1))
    x = np.random.default_rng(I * 13 + J).standard_normal((B, N, I, J)).astype(np.float32)
    got = xlnet._rel_shift(torch.from_numpy(x), klen)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jxl._rel_shift(jnp.asarray(x), klen)))


def test_pos_emb_equals_jax():
    cfg = xlnet.XLNetConfig(head_num=4, size_per_head=8, layer_num=1, vocab_size=8, inter_size=8)
    np.testing.assert_array_equal(xlnet._pos_emb(cfg, 9).numpy(), np.asarray(jxl._pos_emb(cfg, 9)))


def test_registry_serves_xlnet():
    fam = registry.get("xlnet")
    assert fam.encode is xlnet.encode and fam.decode_step is None
    hf = make_hf(seed=0)
    cfg = fam.config_from_hf(hf.config)
    params = fam.params_from_hf(cfg, hf.state_dict(), device="cpu")
    h, _ = fam.encode(cfg, params, np.arange(2, 10)[None], np.array([8]))
    assert h.shape == (1, 8, 32)
