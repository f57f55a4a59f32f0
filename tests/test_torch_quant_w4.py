"""K6, K7 and K8's plain versions (fastertransformer4codefuse_tpu_torch/ops/
quant_matmul_w4.py) and the port's int4 ``linear`` dispatch against the JAX
package's int4 XLA path: ``linear`` / ``quantized_matmul_xla`` (dequantize,
then dot, then bias and activation) and ``quantized_matmul_transposed_head``.
Inputs from one numpy generator go to both packages; fp32; max |diff| / max
|ref| below 1e-5 (the two differ only in fp32 summation order).

The JAX W4 Pallas kernels are not run here: their ``pltpu.bitcast(int4)``
nibble order in interpret mode is backend-defined (see
tests/test_fused_kernels.py), so the JAX package's own CPU tests hold its XLA
path, not the kernels, and so do these."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fastertransformer4codefuse_tpu.models.params import QuantizedTensor as JaxQT
from fastertransformer4codefuse_tpu.ops.linear import linear as jax_linear
from fastertransformer4codefuse_tpu.ops.linear import (
    quantized_matmul_transposed_head as jax_head,
)
from fastertransformer4codefuse_tpu_torch.models.params import QuantizedTensor
from fastertransformer4codefuse_tpu_torch.ops.linear import linear, quantized_matmul_transposed_head
from fastertransformer4codefuse_tpu_torch.ops.quant_matmul import split_ranges
from fastertransformer4codefuse_tpu_torch.ops.quant_matmul_w4 import (
    quant_matmul_w4,
    quant_matmul_w4_group,
    quant_matmul_w4_head,
)

torch.set_num_threads(2)

ACTS = [None, "gelu", "gelu-tanh", "relu", "silu"]


def _rel(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _operands(rng, M, K, N, G=0):
    x = rng.standard_normal((M, K)).astype(np.float32)
    packed = rng.integers(-128, 128, (K // 2, N)).astype(np.int8)
    # scales keep outputs O(1), as in a real layer
    if G:
        s = (rng.random((K // G, N)) * 0.06 + 0.01).astype(np.float32)
        s = jnp.asarray(s, jnp.bfloat16)  # stored bf16, as the quantizer makes them
        ts = torch.from_numpy(np.array(s).view(np.int16)).view(torch.bfloat16)
    else:
        s = (rng.random(N) * 0.06 + 0.01).astype(np.float32)
        ts = torch.from_numpy(s)
    b = (rng.standard_normal(N) * 0.1).astype(np.float32)
    return x, packed, s, ts, b


# M = 8 (the pools' and beam pools' width) and 32 (the GEMV ceiling) are the
# widths of the GEMV's tensor-core body on the card
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("M", [1, 3, 8, 32, 40])
def test_plain_k6_matches_jax_int4_linear(M, act):
    rng = np.random.default_rng(M)
    x, p, s, ts, b = _operands(rng, M, 256, 384)
    ref = jax_linear(jnp.asarray(x), JaxQT(q=jnp.asarray(p), scale=jnp.asarray(s), k_axis=-2,
                                            bits=4), jnp.asarray(b), act=act)
    T = torch.from_numpy
    assert _rel(quant_matmul_w4(T(x), T(p), ts, T(b), act), ref) < 1e-5
    qt = QuantizedTensor(q=T(p), scale=ts, k_axis=-2, bits=4)
    assert _rel(linear(T(x), qt, T(b), act=act), ref) < 1e-5


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("M,G", [(1, 32), (3, 128), (8, 128), (32, 32), (40, 32)])
def test_plain_k7_matches_jax_group_int4_linear(M, G, act):
    rng = np.random.default_rng(100 + M)
    x, p, s, ts, b = _operands(rng, M, 256, 384, G)
    jqt = JaxQT(q=jnp.asarray(p), scale=s, k_axis=-2, bits=4, group_size=G)
    ref = jax_linear(jnp.asarray(x), jqt, jnp.asarray(b), act=act)
    T = torch.from_numpy
    assert _rel(quant_matmul_w4_group(T(x), T(p), ts, G, T(b), act), ref) < 1e-5
    qt = QuantizedTensor(q=T(p), scale=ts, k_axis=-2, bits=4, group_size=G)
    assert _rel(linear(T(x), qt, T(b), act=act), ref) < 1e-5
    # the group scales sit inside the contraction: the plain weight is JAX's
    np.testing.assert_array_equal(qt.dequantize().numpy(), np.asarray(jqt.dequantize(jnp.float32)))


@pytest.mark.parametrize("M", [1, 4, 8, 9, 32])
def test_plain_k8_matches_jax_transposed_head(M):
    rng = np.random.default_rng(200 + M)
    x, p, s, ts, _ = _operands(rng, M, 128, 2560)
    ref = jax_head(jnp.asarray(x), JaxQT(q=jnp.asarray(p), scale=jnp.asarray(s), k_axis=-2,
                                          bits=4))
    T = torch.from_numpy
    got = quant_matmul_w4_head(T(x), T(p), ts)
    assert got.dtype == torch.float32 and got.shape == (M, 2560)
    assert _rel(got, ref) < 1e-5
    qt = QuantizedTensor(q=T(p), scale=ts, k_axis=-2, bits=4)
    assert _rel(quantized_matmul_transposed_head(T(x), qt), ref) < 1e-5


def test_plain_k6_identity_is_exact_dequant():
    """Identity activations: the output is the dequantized weight, exactly,
    and equals the JAX QuantizedTensor's dequantize."""
    rng = np.random.default_rng(0)
    K, N = 64, 48
    p = rng.integers(-128, 128, (K // 2, N)).astype(np.int8)
    s = (rng.random(N) * 0.05 + 0.001).astype(np.float32)
    got = quant_matmul_w4(torch.eye(K), torch.from_numpy(p), torch.from_numpy(s))
    ref = JaxQT(q=jnp.asarray(p), scale=jnp.asarray(s), k_axis=-2, bits=4).dequantize()
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_unserved_int4_forms_raise():
    """The group-wise transposed int4 head, refused until ROADMAP item 11
    was done, is served now: K7 with fp32 out (its plain version here;
    tests/test_torch_group_int8.py holds it to the JAX function). An int4
    [V, H] head (k_axis 1) is still no served form: the JAX package's
    quantizer makes the transposed head only."""
    from fastertransformer4codefuse_tpu_torch import GptNeoXConfig
    from fastertransformer4codefuse_tpu_torch.models.gptneox import lm_logits

    rng = np.random.default_rng(1)
    x, p, _, ts, _ = _operands(rng, 2, 64, 32, G=16)
    head = QuantizedTensor(q=torch.from_numpy(p), scale=ts, k_axis=-2, bits=4, group_size=16)
    got = quantized_matmul_transposed_head(torch.from_numpy(x), head)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, torch.from_numpy(x) @ head.dequantize(), rtol=1e-5,
                               atol=1e-5)
    cfg = GptNeoXConfig.tiny(head_num=4, size_per_head=16, vocab_size=32)
    vh = QuantizedTensor(q=torch.from_numpy(p.T.copy()), scale=torch.ones(32), k_axis=1, bits=4)
    params = {"final_ln_w": torch.ones(64), "final_ln_b": torch.zeros(64), "lm_head": vh}
    with pytest.raises(NotImplementedError, match="int8 only"):
        lm_logits(cfg, params, torch.zeros(1, 64))


def test_cpu_tensors_take_the_plain_versions_without_a_launch():
    rng = np.random.default_rng(1)
    T = torch.from_numpy
    x, p, _, ts, b = _operands(rng, 2, 64, 32)
    _, _, _, gs, _ = _operands(rng, 2, 64, 32, G=16)
    before = (quant_matmul_w4.launches, quant_matmul_w4_group.launches,
              quant_matmul_w4_head.launches)
    quant_matmul_w4(T(x), T(p), ts, T(b), "relu")
    quant_matmul_w4_group(T(x), T(p), gs, 16, T(b))
    quant_matmul_w4_head(T(x), T(p), ts)
    assert (quant_matmul_w4.launches, quant_matmul_w4_group.launches,
            quant_matmul_w4_head.launches) == before


# The weight-streaming GEMV's K ranges (ops/quant_matmul.py split_ranges,
# which the kernel takes as given): whole 8-row units and, with group
# scales, whole groups a range; no empty range; at most 3072 K rows a range
# (GEMV_MAX_CHUNK in csrc/ftcf_gemv.cuh, the bound of its x staging).
# CodeFuse-13B's N widths, the H100's 132 SMs and a smaller card's 114.
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("K", [256, 1152, 2048, 5120, 20480])
@pytest.mark.parametrize("G", [32, 64, 128])
def test_gemv_splits_hold_whole_groups(G, K, bits):
    for N, sms, share in ((15360, 132, 1.0), (20480, 132, 1.0), (5120, 132, 0.2),
                          (5120, 132, 0.8), (384, 114, 1.0)):
        splits, chunk = split_ranges(K, N, sms, share, bits, G)
        assert splits >= 1
        assert chunk % G == 0 and chunk % 8 == 0, (N, sms, share, splits, chunk)
        assert (splits - 1) * chunk < K <= splits * chunk, (N, sms, splits, chunk)
        assert 4 * chunk * 4 <= 48 * 1024, (N, sms, splits, chunk)
        assert splits <= split_ranges(K, N, sms, share, bits)[0]


def test_gemv_splits_per_channel_unchanged():
    """Without group scales a range is a ceil share of the byte rows rounded
    up to 8 K rows: CodeFuse-13B's QKV, up and down at 132 SMs need no
    rounding."""
    assert [split_ranges(K, N, 132, 1.0, b) for K, N in ((5120, 15360), (5120, 20480),
                                                         (20480, 5120)) for b in (8, 4)] \
        == [(5, 1024)] * 4 + [(20, 1024)] * 2
    # 1000 int4 byte rows in 3 ranges: 334 a range, rounded up to 336 (672 K rows)
    assert split_ranges(2000, 176 * 128, 132, 1.0, 4) == (3, 672)
    # BERT-base's FFN down: 88 ranges of 35 rows would not be 8-row units
    assert split_ranges(3072, 768, 132, 1.0, 8) == (77, 40)
