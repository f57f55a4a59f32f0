"""The port's int8 KV cache writes (fastertransformer4codefuse_tpu_torch/engine/
kv_cache.py) against the JAX package's: the int8 codes and bf16 scales of
write_prefill / write_decode must be equal bit for bit."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fastertransformer4codefuse_tpu.core.config import GptNeoXConfig as JaxConfig
from fastertransformer4codefuse_tpu.engine import kv_cache as jax_kvc
from fastertransformer4codefuse_tpu_torch.core.config import GptNeoXConfig
from fastertransformer4codefuse_tpu_torch.engine import kv_cache as kvc

torch.set_num_threads(2)


def _bits(a):
    """Raw bits of a jax or torch array as a numpy integer array."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy()
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _assert_same_cache(jc, tc):
    assert set(jc) == set(tc)
    for n in jc:
        np.testing.assert_array_equal(_bits(jc[n]), _bits(tc[n]), err_msg=n)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_int8_writes_match_jax_bit_for_bit(dtype):
    rng = np.random.default_rng(3)
    kw = dict(head_num=4, size_per_head=16, layer_num=2, vocab_size=64,
              rotary_embedding_dim=4, start_id=0, end_id=1)
    jcfg, cfg = JaxConfig(**kw), GptNeoXConfig(**kw)
    B, S, Smax = 2, 8, 16
    jdt, tdt = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]

    def pair(shape, scale=1.0):
        a = (rng.standard_normal(shape) * scale).astype(np.float32)
        return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)

    jc = jax_kvc.init_cache(jcfg, B, Smax, jnp.int8)
    tc = kvc.init_cache(cfg, B, Smax, torch.int8, "cpu")
    (jk, tk), (jv, tv) = pair((B, S, 4, 16), 3.0), pair((B, S, 4, 16))
    # round-half-to-even ties: amax 127 makes the scale exactly 1
    tie = np.array([127.0, 63.5, -62.5, 0.5, -1.5, 2.5] + [0.0] * 10, np.float32)
    jk = jk.at[0, 0, 0].set(jnp.asarray(tie, jdt))
    tk[0, 0, 0] = torch.from_numpy(tie).to(tdt)
    for layer in (0, 1):
        jc = jax_kvc.write_prefill(jc, jnp.int32(layer), jk, jv)
        kvc.write_prefill(tc, layer, tk, tv)
    _assert_same_cache(jc, tc)
    assert tc["k"][0, 0, 0, 0, :6].tolist() == [127, 64, -62, 0, -2, 2]  # half to even

    positions = np.array([S, S + 5], np.int32)
    for step in range(3):
        (jk1, tk1), (jv1, tv1) = pair((B, 1, 4, 16), 2.0), pair((B, 1, 4, 16))
        jp = jnp.asarray(positions + step)
        tp = torch.from_numpy(positions + step)
        jc = jax_kvc.write_decode(jc, jnp.int32(1), jk1, jv1, jp)
        kvc.write_decode(tc, 1, tk1, tv1, tp)
    _assert_same_cache(jc, tc)


def test_bf16_cache_writes_match_jax():
    rng = np.random.default_rng(4)
    kw = dict(head_num=2, size_per_head=8, layer_num=1, vocab_size=32,
              rotary_embedding_dim=4, start_id=0, end_id=1)
    B, S = 2, 4
    jc = jax_kvc.init_cache(JaxConfig(**kw), B, 8, jnp.bfloat16)
    tc = kvc.init_cache(GptNeoXConfig(**kw), B, 8, torch.bfloat16, "cpu")
    k, v = (rng.standard_normal((B, S, 2, 8)).astype(np.float32) for _ in range(2))
    jc = jax_kvc.write_prefill(jc, jnp.int32(0), jnp.asarray(k), jnp.asarray(v))
    kvc.write_prefill(tc, 0, torch.from_numpy(k), torch.from_numpy(v))
    k1, v1 = (rng.standard_normal((B, 1, 2, 8)).astype(np.float32) for _ in range(2))
    pos = np.array([4, 6], np.int32)
    jc = jax_kvc.write_decode(jc, jnp.int32(0), jnp.asarray(k1), jnp.asarray(v1), jnp.asarray(pos))
    kvc.write_decode(tc, 0, torch.from_numpy(k1), torch.from_numpy(v1), torch.from_numpy(pos))
    _assert_same_cache(jc, tc)


@pytest.mark.parametrize("mode", ["preserve", "sacrifice_last"])
def test_write_decode_skip_modes_match_jax(mode):
    """Skipped rows keep their bytes (preserve) or write slot S-1
    (sacrifice_last, the pool's mode): codes and scales bit for bit."""
    rng = np.random.default_rng(4)
    kw = dict(head_num=4, size_per_head=16, layer_num=2, vocab_size=64,
              rotary_embedding_dim=4, start_id=0, end_id=1)
    B, S = 3, 8
    jc = jax_kvc.init_cache(JaxConfig(**kw), B, S, jnp.int8)
    tc = kvc.init_cache(GptNeoXConfig(**kw), B, S, torch.int8, "cpu")
    skip = np.array([False, True, False])
    for step in range(3):
        k, v = (rng.standard_normal((B, 1, 4, 16)).astype(np.float32) for _ in range(2))
        pos = np.array([step, step + 2, step + 4], np.int32)
        sk = skip if step == 2 else None  # written once, then skipped over
        jc = jax_kvc.write_decode(jc, 1, jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
                                  skip=None if sk is None else jnp.asarray(sk), skip_mode=mode)
        kvc.write_decode(tc, 1, torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(pos),
                         skip=None if sk is None else torch.from_numpy(sk), skip_mode=mode)
    _assert_same_cache(jc, tc)
