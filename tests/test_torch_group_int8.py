"""The group-wise weight forms that no JAX initializer or quantizer makes,
built by hand, against the JAX functions that compute them:

  - int8 weights with fp32 group scales [K/G, N] in K1 (``ops.linear`` ->
    ``quant_matmul(group_size=G)``) against the JAX ``linear`` (its XLA
    fallback, ``ops/linear.py:65``), and in K13's GEMM width against the
    JAX ``fused_qkv_up`` in interpret mode;
  - the group-wise transposed int4 head [H/2, V_pad] (K7 with fp32 out)
    against the JAX ``quantized_matmul_transposed_head`` and ``lm_logits``;
  - a group-wise int8 [V, H] head against the JAX ``QuantizedTensor``'s
    own dequantized product (the JAX ``lm_logits`` multiplies per-row scales
    only and cannot broadcast group scales: pinned here, not copied);
  - a whole engine on group-wise int8 layers (prefill: K13's GEMM form and
    K1; decode: K13's GEMV form and K3, or unfused K1) against the JAX
    engine's greedy tokens.

Tolerances: rtol 1e-5 in fp32 for the plain versions (the same sums in
another order); the bf16 K13 case at tests/test_torch_fused.py's 5e-3.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fastertransformer4codefuse_tpu import GptNeoXConfig as JaxConfig
from fastertransformer4codefuse_tpu import GptNeoXEngine as JaxEngine
from fastertransformer4codefuse_tpu import RuntimeConfig as JaxRuntime
from fastertransformer4codefuse_tpu import init_params as jax_init_params
from fastertransformer4codefuse_tpu.models import gptneox as jmodel
from fastertransformer4codefuse_tpu.models.params import QuantizedTensor as JaxQT
from fastertransformer4codefuse_tpu.ops import linear as jlinear
from fastertransformer4codefuse_tpu_torch import GptNeoXEngine, RuntimeConfig
from fastertransformer4codefuse_tpu_torch.models import gptneox
from fastertransformer4codefuse_tpu_torch.models.params import QuantizedTensor, from_jax_params
from fastertransformer4codefuse_tpu_torch.ops import linear
from fastertransformer4codefuse_tpu_torch.parallel import sharding
from fastertransformer4codefuse_tpu_torch.parallel.distributed import Mesh
from test_torch_fused import _k13_against_pallas_interpret
from test_torch_parallel import port_cfg
from torch_tp_util import np_tree

FP32 = dict(rtol=1e-5, atol=1e-6)


def quantize_groups(w: np.ndarray, G: int, bits: int = 8):
    """(q, fp32 scales) of ``w`` [..., K, N] quantized symmetrically per
    (K group, column): scales [..., K/G, N], q int8 in [-qmax, qmax]."""
    qmax = 127 if bits == 8 else 7
    *lead, K, N = w.shape
    g = w.reshape(*lead, K // G, G, N)
    s = np.maximum(np.abs(g).max(axis=-2), 1e-8) / qmax
    q = np.clip(np.round(g / s[..., None, :]), -qmax, qmax).astype(np.int8)
    return q.reshape(*lead, K, N), s.astype(np.float32)


def pack_int4(q: np.ndarray) -> np.ndarray:
    """[K, N] int4 values -> [K/2, N] bytes, row 2i in the low nibble."""
    lo, hi = q[0::2].astype(np.uint8) & 0xF, q[1::2].astype(np.uint8) & 0xF
    return (lo | (hi << 4)).view(np.int8)


@pytest.mark.parametrize("M", [1, 4, 40])
@pytest.mark.parametrize("G", [16, 128])
@pytest.mark.parametrize("act", [None, "gelu-tanh"])
def test_k1_group_int8_matches_jax_linear(M, G, act):
    rng = np.random.default_rng(M + G)
    K, N = 256, 96
    x = rng.standard_normal((M, K)).astype(np.float32)
    q, s = quantize_groups(rng.standard_normal((K, N)).astype(np.float32) * 0.05, G)
    b = rng.standard_normal(N).astype(np.float32) * 0.1
    jw = JaxQT(q=jnp.asarray(q), scale=jnp.asarray(s), k_axis=-2, bits=8, group_size=G)
    want = np.asarray(jlinear.linear(jnp.asarray(x), jw, jnp.asarray(b), act=act))
    tw = QuantizedTensor(q=torch.from_numpy(q), scale=torch.from_numpy(s), k_axis=-2, bits=8,
                         group_size=G)
    got = linear.linear(torch.from_numpy(x), tw, torch.from_numpy(b), act=act)
    np.testing.assert_allclose(got.numpy(), want, **FP32)


def test_k1_group_int8_on_a_layer_view_of_a_stacked_weight():
    """A layer's view of a stacked [L, K, N] weight with [L, K/G, N] scales,
    as the model hands it to K1, against the JAX ``linear`` on that layer."""
    rng = np.random.default_rng(3)
    L, K, N, G = 3, 128, 48, 32
    q, s = quantize_groups(rng.standard_normal((L, K, N)).astype(np.float32) * 0.05, G)
    x = rng.standard_normal((2, 5, K)).astype(np.float32)
    tw = QuantizedTensor(q=torch.from_numpy(q), scale=torch.from_numpy(s), k_axis=-2, bits=8,
                         group_size=G)[1]
    got = linear.linear(torch.from_numpy(x), tw)
    jw = JaxQT(q=jnp.asarray(q[1]), scale=jnp.asarray(s[1]), k_axis=-2, bits=8, group_size=G)
    np.testing.assert_allclose(got.numpy(), np.asarray(jlinear.linear(jnp.asarray(x), jw)),
                               **FP32)


@pytest.mark.parametrize("M", [33, 64])
def test_plain_k13_int8_groups_at_gemm_width_match_pallas_interpret(M):
    """K13 on int8 weights with group scales at prefill widths (above the
    GEMV's 32 rows, where the card now runs the GEMM's W_I8G instance):
    the plain version against the JAX ``fused_qkv_up`` in interpret mode."""
    _k13_against_pallas_interpret(M, 128)


@pytest.mark.parametrize("G", [16, 64])
@pytest.mark.parametrize("scale_dtype", [np.float32, "bf16"])
def test_group_transposed_head_matches_jax(G, scale_dtype):
    """The group-wise transposed int4 head [H/2, V_pad] (scales [H/G, V_pad])
    through ``quantized_matmul_transposed_head`` (K7, fp32 out) and through
    ``lm_logits`` against the JAX functions (their XLA fallback folds the
    group scales into the weight)."""
    rng = np.random.default_rng(G)
    H, V, Vp = 64, 90, 96
    w = rng.standard_normal((H, Vp)).astype(np.float32) * 0.05
    q, s = quantize_groups(w, G, bits=4)
    if scale_dtype == "bf16":
        s = np.asarray(jnp.asarray(s, jnp.bfloat16).astype(jnp.float32))  # bf16-exact values
    packed = pack_int4(q)
    jdt = jnp.bfloat16 if scale_dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if scale_dtype == "bf16" else torch.float32
    jw = JaxQT(q=jnp.asarray(packed), scale=jnp.asarray(s, jdt), k_axis=0, bits=4, group_size=G)
    tw = QuantizedTensor(q=torch.from_numpy(packed), scale=torch.from_numpy(s).to(tdt), k_axis=0,
                         bits=4, group_size=G)
    x = rng.standard_normal((5, H)).astype(np.float32)
    want = np.asarray(jlinear.quantized_matmul_transposed_head(jnp.asarray(x), jw))
    got = linear.quantized_matmul_transposed_head(torch.from_numpy(x), tw)
    assert got.dtype == torch.float32 and got.shape == (5, Vp)
    np.testing.assert_allclose(got.numpy(), want, **FP32)
    # the whole head: final norm, the K7 product, the vocab cut
    jcfg = JaxConfig.tiny(head_num=4, size_per_head=16, vocab_size=V)
    jp = {"final_ln_w": jnp.asarray(rng.random(H).astype(np.float32) + 0.5),
          "final_ln_b": jnp.asarray(rng.standard_normal(H).astype(np.float32) * 0.1),
          "lm_head": jw}
    hidden = rng.standard_normal((2, 3, H)).astype(np.float32)
    want = np.asarray(jmodel.lm_logits(jcfg, jp, jnp.asarray(hidden)))
    tp = {"final_ln_w": torch.from_numpy(np.array(jp["final_ln_w"])),
          "final_ln_b": torch.from_numpy(np.array(jp["final_ln_b"])), "lm_head": tw}
    got = gptneox.lm_logits(port_cfg(jcfg), tp, torch.from_numpy(hidden))
    assert got.shape == (2, 3, V)
    np.testing.assert_allclose(got.numpy(), want, **FP32)


@pytest.mark.parametrize("G", [16, 32])
def test_group_int8_vh_head_matches_the_jax_dequantized_product(G):
    """A group-wise int8 [V, H] head (k_axis 1, scales [V, H/G]) through
    ``lm_logits``: the JAX ``QuantizedTensor.dequantize`` product. The JAX
    ``lm_logits`` multiplies the logits by per-row scales and cannot
    broadcast [V, H/G] ones (a fault of the JAX package, not copied)."""
    rng = np.random.default_rng(G)
    H, V = 64, 61
    w = rng.standard_normal((V, H)).astype(np.float32) * 0.05
    qt, st = quantize_groups(np.ascontiguousarray(w.T), G)  # groups along H
    q, s = np.ascontiguousarray(qt.T), np.ascontiguousarray(st.T)  # [V, H], [V, H/G]
    jw = JaxQT(q=jnp.asarray(q), scale=jnp.asarray(s), k_axis=1, bits=8, group_size=G)
    ln_w = rng.random(H).astype(np.float32) + 0.5
    ln_b = rng.standard_normal(H).astype(np.float32) * 0.1
    jcfg = JaxConfig.tiny(head_num=4, size_per_head=16, vocab_size=V)
    jp = {"final_ln_w": jnp.asarray(ln_w), "final_ln_b": jnp.asarray(ln_b), "lm_head": jw}
    hidden = rng.standard_normal((4, H)).astype(np.float32)
    h = jmodel.final_norm(jcfg, jp, jnp.asarray(hidden))
    want = np.asarray(jnp.dot(h, jw.dequantize().T, precision="highest"))
    tw = QuantizedTensor(q=torch.from_numpy(q), scale=torch.from_numpy(s), k_axis=1, bits=8,
                         group_size=G)
    tp = {"final_ln_w": torch.from_numpy(ln_w), "final_ln_b": torch.from_numpy(ln_b),
          "lm_head": tw}
    got = gptneox.lm_logits(port_cfg(jcfg), tp, torch.from_numpy(hidden))
    np.testing.assert_allclose(got.numpy(), want, **FP32)
    with pytest.raises((TypeError, ValueError)):
        jmodel.lm_logits(jcfg, jp, jnp.asarray(hidden))
    # under tp the head's rows pad to a multiple of tp, the group scales with them
    cfg = port_cfg(jcfg)
    padded = sharding.pad_vocab_for_tp(cfg, tp, Mesh(tp=2))["lm_head"]
    assert padded.q.shape == (62, H) and padded.scale.shape == (62, H // G)
    assert not padded.scale[61].any() and torch.equal(padded.scale[:61], tw.scale)
    halves = [sharding.shard_params(cfg, {**tp, "layers": {}}, Mesh(tp=2, tp_rank=r))["lm_head"]
              for r in range(2)]
    assert all(x.scale.shape == (31, H // G) for x in halves)


def _group_int8_params(jcfg, G):
    """The JAX float params with the four big layer kernels quantized per
    (K group, column) to int8 by hand."""
    p = jax_init_params(jcfg, dtype="fp32")
    layers = dict(p["layers"])
    for name in ("qkv_w", "proj_w", "up_w", "down_w"):
        w = np.asarray(layers[name])
        q, s = quantize_groups(w.reshape(w.shape[0], w.shape[1], -1), G)
        layers[name] = JaxQT(q=jnp.asarray(q.reshape(w.shape)),
                             scale=jnp.asarray(s.reshape((w.shape[0], w.shape[1] // G)
                                                         + w.shape[2:])),
                             k_axis=-2, bits=8, group_size=G)
    return {**p, "layers": layers}


@pytest.mark.parametrize("fused", [True, False])
def test_engine_on_group_int8_layers_matches_jax(fused):
    """An engine whose four big kernels are int8 with group scales: fused,
    K13 (GEMM form in prefill, GEMV in decode) and K3; unfused, K1 for all
    four. Greedy tokens equal the JAX engine's, cum log-probs within 1e-4,
    the prefill's logits within 1e-4."""
    G = 16
    jcfg = JaxConfig.tiny(head_num=4, size_per_head=16, vocab_size=96, inter_size=128)
    jp = _group_int8_params(jcfg, G)
    prompts = [[3, 4, 5, 17, 9], [9, 8, 7]]
    jeng = JaxEngine(jcfg, jp, JaxRuntime(dtype="fp32", seq_bucket=4, int8_mode=1))
    want = jeng.generate(prompts, output_len=6, top_k=1, return_cum_log_probs=True)
    params = from_jax_params(np_tree(jp), device="cpu")
    assert params["layers"]["qkv_w"].group_size == G and params["layers"]["qkv_w"].bits == 8
    eng = GptNeoXEngine(port_cfg(jcfg), params,
                        RuntimeConfig(dtype="fp32", seq_bucket=4, int8_mode=1,
                                      fused_decode=fused))
    got = eng.generate(prompts, 6, top_k=1, return_cum_log_probs=True)
    np.testing.assert_array_equal(got.output_ids, np.asarray(want.output_ids))
    np.testing.assert_allclose(got.cum_log_probs, np.asarray(want.cum_log_probs), atol=1e-4)
    st, inputs = eng._prepare(prompts, 6, top_k=1)
    logits = eng._prefill_state(st, inputs).logits.numpy()
    ids = np.asarray(inputs["tokens"][:, : st.input_width])
    lens = jnp.asarray([len(p) for p in prompts], jnp.int32)
    cache = jmodel.init_kv_cache(jcfg, 2, st.total_len, jnp.float32)
    hidden, _ = jmodel.prefill(jcfg, jp, jnp.asarray(ids), lens, cache)
    ref = np.asarray(jmodel.lm_logits(jcfg, jp, jmodel.last_token_hidden(hidden, lens)))
    np.testing.assert_allclose(logits, ref, atol=1e-4, rtol=1e-4)
