"""The port's quantizer (fastertransformer4codefuse_tpu_torch/ckpt/quantize.py)
and ``QuantizedTensor`` against the JAX package's, for int8 and int4 with
per-channel and group-wise scales. Tolerance: none; the packed bytes, the
scales (bf16 group scales compared as bits), the unpacked values and the
dequantized fp32 weights are all bit-identical. A non-symmetric weight pins
the nibble order (low nibble = even K row)."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fastertransformer4codefuse_tpu import GptNeoXConfig as JaxConfig
from fastertransformer4codefuse_tpu import init_params as jax_init_params
from fastertransformer4codefuse_tpu.ckpt import quantize as jq
from fastertransformer4codefuse_tpu_torch import GptNeoXConfig, from_jax_params, init_params
from fastertransformer4codefuse_tpu_torch.ckpt import quantize as tq
from fastertransformer4codefuse_tpu_torch.models.params import QuantizedTensor

torch.set_num_threads(2)


def _bits(a):
    """Exact bit pattern of a scale array (bf16 or fp32) as integers."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16 if a.element_size() == 2 else torch.int32).numpy()
    a = np.asarray(a)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


def _same(jqt, tqt):
    assert tqt.k_axis == jqt.k_axis and tqt.bits == jqt.bits
    assert tqt.group_size == jqt.group_size and tqt.shape == tuple(jqt.shape)
    np.testing.assert_array_equal(tqt.q.numpy(), np.asarray(jqt.q))
    assert str(tqt.scale.dtype).split(".")[-1] == np.asarray(jqt.scale).dtype.name
    np.testing.assert_array_equal(_bits(tqt.scale), _bits(jqt.scale))
    np.testing.assert_array_equal(tqt.unpack().numpy(), np.asarray(jqt.unpack()))
    np.testing.assert_array_equal(tqt.dequantize().numpy(), np.asarray(jqt.dequantize()))


# group-wise scales run along K = axis -2 only
CASES = [(shape, k, bits, G) for shape, k in [((3, 64, 48), -2), ((64, 48), -2), ((40, 64), -1)]
         for bits in (8, 4) for G in (0, 32) if not (G and k == -1)]


@pytest.mark.parametrize("shape,k_axis,bits,G", CASES)
def test_quantize_array_is_bit_identical_to_jax(shape, k_axis, bits, G):
    rng = np.random.default_rng(bits * 100 + G)
    w = (rng.standard_normal(shape) * 0.02).astype(np.float32)
    w[..., 1] = 0.0  # zero channel: scale 1
    _same(jq.quantize_array(jnp.asarray(w), k_axis, bits, G), tq.quantize_array(w, k_axis, bits, G))
    _same(jq.quantize_array(jnp.asarray(w), k_axis, bits, G),
          tq.quantize_array(torch.from_numpy(w), k_axis, bits, G))


def test_nibble_order_low_nibble_is_the_even_row():
    """A weight whose even and odd K rows differ: a swapped nibble order
    would unpack rows 2i and 2i+1 exchanged."""
    K, N = 8, 4
    w = np.zeros((K, N), np.float32)
    w[0::2] = 7.0  # even rows -> +7 (scale 1)
    w[1::2] = -3.0  # odd rows -> -3
    w[:, 3] = 2 * np.arange(K) - 7.0  # one column: -7, -5, ..., 7 in order (scale 1)
    t = tq.quantize_array(w, k_axis=-2, bits=4)
    assert t.q.shape == (K // 2, N)
    assert int(t.q[0, 0]) & 0xF == 7 and int(t.q[0, 0]) >> 4 == -3  # (hi << 4) | lo
    _same(jq.quantize_array(jnp.asarray(w), -2, 4), t)
    qv = t.unpack().numpy()
    np.testing.assert_array_equal(qv[0::2, :3], 7)
    np.testing.assert_array_equal(qv[1::2, :3], -3)
    np.testing.assert_array_equal(qv[:, 3], 2 * np.arange(K) - 7)


@pytest.mark.parametrize("bits,G", [(8, 0), (4, 0), (4, 16)])
def test_quantize_params_is_bit_identical_to_jax(bits, G):
    jcfg = JaxConfig.tiny(vocab_size=100)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(3), dtype="fp32")
    jqp = jq.quantize_params(jp, include_embeddings=True, weight_bits=bits, group_size=G)
    tqp = tq.quantize_params(from_jax_params(jp, device="cpu"), include_embeddings=True, weight_bits=bits,
                             group_size=G)
    for k in ("qkv_w", "proj_w", "up_w", "down_w"):
        _same(jqp["layers"][k], tqp["layers"][k])
    _same(jqp["embed"], tqp["embed"])
    _same(jqp["lm_head"], tqp["lm_head"])
    if bits == 4:  # the transposed head: [H/2, V_pad], V_pad a multiple of 2560
        assert tqp["lm_head"].q.shape == (jcfg.hidden_size // 2, 2560)
        assert tqp["lm_head"].k_axis == -2


def test_quantize_lm_head_int4_pads_codefuse_vocab():
    t = tq.quantize_lm_head_int4(torch.zeros(100831, 4))
    assert t.q.shape == (2, 102400) and t.scale.shape == (102400,)


def test_from_jax_params_keeps_int4_layouts():
    """JAX init_params(weight_bits=4) carried over: packed payloads, bf16
    group scales kept bf16, the transposed head; the port's own
    init_params gives the same shapes and dtypes."""
    jcfg = JaxConfig.tiny(vocab_size=100)
    cfg = GptNeoXConfig(**dataclasses.asdict(jcfg))
    for G in (0, 16):
        jp = jax_init_params(jcfg, jax.random.PRNGKey(0), dtype="fp32", int8_mode=1,
                             weight_bits=4, group_size=G, quantize_embeddings=True)
        tp = from_jax_params(jp, device="cpu")
        own = init_params(cfg, seed=0, dtype="fp32", int8_mode=1, weight_bits=4, group_size=G,
                          quantize_embeddings=True, device="cpu")
        for name in ("qkv_w", "proj_w", "up_w", "down_w"):
            j, t, o = jp["layers"][name], tp["layers"][name], own["layers"][name]
            _same(j, t)
            for a in (t, o):
                assert isinstance(a, QuantizedTensor) and (a.bits, a.group_size) == (4, G)
            assert o.q.shape == t.q.shape and o.scale.shape == t.scale.shape
            assert o.scale.dtype == t.scale.dtype == (torch.bfloat16 if G else torch.float32)
        for a in (tp["lm_head"], own["lm_head"]):
            assert a.q.shape == (jcfg.hidden_size // 2, 2560) and a.k_axis == -2
            assert a.bits == 4 and a.scale.dtype == torch.float32
        _same(jp["lm_head"], tp["lm_head"])


# FTCF_GSCALE_BF16=0: fp32 group scales for int4, the JAX package's switch
GSCALE_F32_CASES = [((3, 64, 48), 32), ((64, 48), 16), ((256, 32), 128)]


@pytest.mark.parametrize("shape,G", GSCALE_F32_CASES)
def test_fp32_group_scales_are_bit_identical_to_jax(shape, G, monkeypatch):
    """Under FTCF_GSCALE_BF16=0 both quantizers keep fp32 int4 group scales
    and quantize against them: payload, scales and dequantized weights bit
    for bit; without it both round the scales to bf16 first."""
    rng = np.random.default_rng(G)
    w = (rng.standard_normal(shape) * 0.02).astype(np.float32)
    w[..., 1] = 0.0
    monkeypatch.setenv("FTCF_GSCALE_BF16", "0")
    assert tq.group_scale_dtype(4, G) == torch.float32
    assert tq.group_scale_dtype(8, G) == torch.float32
    j, t = jq.quantize_array(jnp.asarray(w), -2, 4, G), tq.quantize_array(w, -2, 4, G)
    assert t.scale.dtype == torch.float32
    _same(j, t)
    monkeypatch.setenv("FTCF_GSCALE_BF16", "1")
    j16, t16 = jq.quantize_array(jnp.asarray(w), -2, 4, G), tq.quantize_array(w, -2, 4, G)
    assert t16.scale.dtype == torch.bfloat16
    _same(j16, t16)


@pytest.mark.parametrize("G", [16, 32])
def test_fp32_group_scales_through_params_and_engine(G, monkeypatch):
    """quantize_params, init_params and from_jax_params keep fp32 group scales
    under the switch, and the engine on them (the plain K7/K13/K3) gives the
    JAX engine's greedy tokens and logits."""
    from fastertransformer4codefuse_tpu import GptNeoXEngine as JaxEngine
    from fastertransformer4codefuse_tpu import RuntimeConfig as JaxRuntime
    from fastertransformer4codefuse_tpu_torch import GptNeoXEngine, RuntimeConfig

    monkeypatch.setenv("FTCF_GSCALE_BF16", "0")
    jcfg = JaxConfig.tiny(vocab_size=100)
    cfg = GptNeoXConfig(**dataclasses.asdict(jcfg))
    jp = jax_init_params(jcfg, jax.random.PRNGKey(3), dtype="fp32")
    jqp = jq.quantize_params(jp, weight_bits=4, group_size=G)
    tqp = tq.quantize_params(from_jax_params(jp, device="cpu"), weight_bits=4, group_size=G)
    for k in ("qkv_w", "proj_w", "up_w", "down_w"):
        _same(jqp["layers"][k], tqp["layers"][k])
        assert tqp["layers"][k].scale.dtype == torch.float32
    own = init_params(cfg, seed=0, dtype="fp32", int8_mode=1, weight_bits=4, group_size=G,
                      device="cpu")
    assert own["layers"]["up_w"].scale.dtype == torch.float32
    rt = dict(dtype="fp32", int8_mode=1, seq_bucket=8)
    want = JaxEngine(jcfg, jqp, JaxRuntime(**rt)).generate(
        [[3, 4, 5, 6, 7]], output_len=5, top_k=1, return_cum_log_probs=True)
    for fused in (True, False):
        got = GptNeoXEngine(cfg, from_jax_params(jqp, device="cpu"),
                            RuntimeConfig(fused_decode=fused, **rt)).generate(
            [[3, 4, 5, 6, 7]], output_len=5, top_k=1, return_cum_log_probs=True)
        np.testing.assert_array_equal(got.output_ids, np.asarray(want.output_ids))
        np.testing.assert_allclose(got.cum_log_probs, np.asarray(want.cum_log_probs), atol=1e-4)
