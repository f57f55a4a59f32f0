"""The port's DeBERTa (fastertransformer4codefuse_tpu_torch/models/deberta.py)
against the JAX package's models/deberta.py and HF DebertaV2Model on
tests/test_deberta.py's tiny configs (log buckets with dedicated position
projections, v3's shared attention key without absolute positions, linear
relative positions, c2p only), fp32 on the CPU: the real rows within the JAX
test's rtol 2e-4 / atol 2e-5 of HF and atol 2e-4 / rtol 1e-4 of the JAX
package; the log-bucket tables exactly equal; the c2p/p2c gathers with
clamping equal the JAX package's take_along_axis on drawn shapes."""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax.numpy as jnp

from fastertransformer4codefuse_tpu.models import deberta as jdeb
from fastertransformer4codefuse_tpu_torch.models import deberta, registry
from test_deberta import make_hf

torch.set_num_threads(2)
JAX_TOL = dict(atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("seed,kw,S,lens", [
    (0, {}, 20, [20, 13]),
    (2, dict(share_att_key=True, position_biased_input=False), 16, [16, 9]),
    (4, dict(position_buckets=-1, max_relative_positions=16), 14, [14]),
    (6, dict(pos_att_type=["c2p"]), 12, [12]),
])
def test_matches_hf_and_jax(seed, kw, S, lens):
    hf = make_hf(seed=seed, **kw)
    cfg = deberta.config_from_hf_deberta(hf.config)
    params = deberta.params_from_hf_deberta_state_dict(cfg, hf.state_dict(), device="cpu")
    jcfg = jdeb.config_from_hf_deberta(hf.config)
    jparams = jdeb.params_from_hf_deberta_state_dict(jcfg, hf.state_dict())
    B = len(lens)
    ids = np.random.RandomState(seed + 1).randint(2, 96, size=(B, S)).astype(np.int64)
    ln = np.asarray(lens, np.int32)
    am = (np.arange(S)[None, :] < ln[:, None]).astype(np.int64)
    with torch.no_grad():
        want = hf(input_ids=torch.from_numpy(ids),
                  attention_mask=torch.from_numpy(am)).last_hidden_state.numpy()
    got, _ = deberta.encode(cfg, params, ids, ln)
    ref, _ = jdeb.encode(jcfg, jparams, jnp.asarray(ids), jnp.asarray(ln))
    for b, n in enumerate(lens):
        np.testing.assert_allclose(got.numpy()[b, :n], want[b, :n], rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(got.numpy()[b, :n], np.asarray(ref)[b, :n], **JAX_TOL)


@pytest.mark.parametrize("bucket_size,max_position", [(256, 512), (8, 64), (32, 128), (6, 24)])
def test_log_bucket_tables_equal_jax_exactly(bucket_size, max_position):
    """Every relative position in [-4 max_position, 4 max_position]: the
    float32 log rounded up lands in the JAX package's bucket."""
    rel = np.arange(-4 * max_position, 4 * max_position + 1)
    got = deberta._log_bucket(torch.from_numpy(rel), bucket_size, max_position)
    want = np.asarray(jdeb._log_bucket(jnp.asarray(rel), bucket_size, max_position))
    np.testing.assert_array_equal(got.numpy(), want)


@settings(max_examples=12, deadline=None)
@given(B=st.integers(1, 2), nH=st.integers(1, 3), S=st.integers(1, 12), span=st.integers(1, 8),
       sign=st.sampled_from([1, -1]))
def test_relative_gathers_equal_take_along_axis(B, nH, S, span, sign):
    """out[b, h, i, j] = att[b, h, i, clamp(sign * rel[i, j] + span)] on the
    [S, S] relative positions, as the JAX package gathers c2p (sign 1) and
    p2c (sign -1)."""
    rng = np.random.default_rng(S * 31 + span)
    att = rng.standard_normal((B, nH, S, 2 * span)).astype(np.float32)
    rel = (np.arange(S)[:, None] - np.arange(S)[None, :]) * sign
    idx = np.clip(rel + span, 0, 2 * span - 1)
    got = deberta._gather_rel(torch.from_numpy(att), torch.from_numpy(idx))
    want = jnp.take_along_axis(jnp.asarray(att),
                               jnp.broadcast_to(jnp.asarray(idx)[None, None], (B, nH, S, S)),
                               axis=-1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_registry_serves_deberta():
    fam = registry.get("deberta")
    assert fam.encode is deberta.encode and fam.decode_step is None
    hf = make_hf(seed=0)
    cfg = fam.config_from_hf(hf.config)
    params = fam.params_from_hf(cfg, hf.state_dict(), device="cpu")
    h, _ = fam.encode(cfg, params, np.arange(2, 12)[None], np.array([10]))
    assert h.shape == (1, 10, 32)
