"""K2, K3 and K13 plain versions (fastertransformer4codefuse_tpu_torch/ops/
quant_matmul_fused.py) against the JAX Pallas kernels in interpret mode (int8,
per-channel and G = 128), at the shapes of tests/test_fused_kernels.py, and
int4 (per-channel and G = 128) against the JAX kernels' arithmetic. bf16 inputs (rounded identically
for both packages) and the tolerances those tests use: max |diff| / max |ref|
below 2e-2 for K2 (the bf16 hidden may round differently) and 5e-3 for K3."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fastertransformer4codefuse_tpu.ops.quant_matmul_fused import (
    fused_proj_down as jax_fused_proj_down,
    fused_qkv_up as jax_fused_qkv_up,
    fused_up_proj_down as jax_fused_up_proj_down,
)
from fastertransformer4codefuse_tpu_torch.ops.quant_matmul_fused import (
    fused_proj_down,
    fused_qkv_up,
    fused_up_proj_down,
)

torch.set_num_threads(2)


def _bf16_pair(a):
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)


def _rel_err(got, ref):
    ref = np.asarray(ref.astype(jnp.float32))
    got = got.float().numpy()
    return float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-6))


def test_plain_k2_matches_pallas_interpret():
    rng = np.random.default_rng(2)
    M, H, F, L = 3, 512, 1024, 2
    (jx_up, x_up), (jx_proj, x_proj), (jres, res) = (
        _bf16_pair(rng.standard_normal((M, H)).astype(np.float32)) for _ in range(3)
    )
    p_up = rng.integers(-128, 128, (L, H, F)).astype(np.int8)
    p_proj = rng.integers(-128, 128, (L, H, H)).astype(np.int8)
    p_down = rng.integers(-128, 128, (L, F, H)).astype(np.int8)
    s_up, s_proj, s_down = (
        (rng.random((L, n)) * 0.02).astype(np.float32) for n in (F, H, H)
    )
    b_up = rng.standard_normal((L, 1, F)).astype(np.float32)
    b_down = rng.standard_normal((L, 1, H)).astype(np.float32)
    ref = jax_fused_up_proj_down(
        jx_up, jx_proj, jres, *(jnp.asarray(a) for a in (p_up, p_proj, p_down, s_up, s_proj,
                                                          s_down, b_up, b_down)),
        jnp.int32(1), bits=8, G=0, act="gelu-tanh", bku=256, bkp=256, bkd=256, interpret=True,
    )
    t = torch.from_numpy
    got = fused_up_proj_down(
        x_up, x_proj, res, t(p_up[1]), t(p_proj[1]), t(p_down[1]), t(s_up[1]), t(s_proj[1]),
        t(s_down[1]), t(b_up[1, 0]), t(b_down[1, 0]), act="gelu-tanh",
    )
    assert got.dtype == torch.bfloat16 and got.shape == (M, H)
    assert _rel_err(got, ref) < 2e-2


def _k3_against_pallas_interpret(M):
    rng = np.random.default_rng(1)
    K1, K2, N, L = 1024, 2048, 768, 2
    (jx1, x1), (jx2, x2) = (
        _bf16_pair(rng.standard_normal((M, k)).astype(np.float32)) for k in (K1, K2)
    )
    p1 = rng.integers(-128, 128, (L, K1, N)).astype(np.int8)
    p2 = rng.integers(-128, 128, (L, K2, N)).astype(np.int8)
    s1, s2 = ((rng.random((L, N)) * 0.02).astype(np.float32) for _ in range(2))
    b = rng.standard_normal((L, 1, N)).astype(np.float32)
    jres, res = _bf16_pair(rng.standard_normal((M, N)).astype(np.float32))
    ref = jax_fused_proj_down(
        jx1, jx2, jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(s1), jnp.asarray(s2),
        jnp.asarray(b), jres, jnp.int32(0), bits=8, G=0, bn=256, bk=256, interpret=True,
    )
    t = torch.from_numpy
    got = fused_proj_down(x1, x2, t(p1[0]), t(p2[0]), t(s1[0]), t(s2[0]), t(b[0, 0]), res)
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    assert _rel_err(got, ref) < 5e-3


def test_plain_k3_matches_pallas_interpret():
    _k3_against_pallas_interpret(3)


def test_plain_k3_matches_pallas_interpret_at_pool_width():
    """M = 8, the pools' width (the GEMV's tensor-core body on the card)."""
    _k3_against_pallas_interpret(8)


def test_plain_k2_k3_int4_match_jax_xla_composition():
    """Per-channel int4 (bits=4, G=0) K2 and K3 against the JAX package's
    unfused XLA path for the same block (its int4 Pallas kernels do not run
    on the CPU: see tests/test_fused_kernels.py): up with bias and tanh-gelu,
    the hidden rounded to bf16, proj and down, bias and residual. Same bf16
    inputs and tolerances as above."""
    from fastertransformer4codefuse_tpu.models.params import QuantizedTensor as JaxQT
    from fastertransformer4codefuse_tpu.ops.linear import linear as jax_linear

    rng = np.random.default_rng(3)
    M, H, F = 3, 256, 512
    (jx_up, x_up), (jx_proj, x_proj), (jres, res) = (
        _bf16_pair(rng.standard_normal((M, H)).astype(np.float32)) for _ in range(3)
    )
    p_up, p_proj, p_down = (rng.integers(-128, 128, (k // 2, n)).astype(np.int8)
                            for k, n in ((H, F), (H, H), (F, H)))
    s_up, s_proj, s_down = ((rng.random(n) * 0.06 + 0.01).astype(np.float32) for n in (F, H, H))
    b_up, b_down = (rng.standard_normal(n).astype(np.float32) for n in (F, H))

    def jq(p, s):
        return JaxQT(q=jnp.asarray(p), scale=jnp.asarray(s), k_axis=-2, bits=4)

    f32 = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    h = jax_linear(f32(jx_up), jq(p_up, s_up), jnp.asarray(b_up), act="gelu-tanh")
    h = h.astype(jnp.bfloat16)
    pd = (jax_linear(f32(jx_proj), jq(p_proj, s_proj))
          + jax_linear(f32(h), jq(p_down, s_down)) + b_down + f32(jres))
    t = torch.from_numpy
    k3 = fused_proj_down(x_proj, torch.from_numpy(np.asarray(h, np.float32)).bfloat16(),
                         t(p_proj), t(p_down), t(s_proj), t(s_down), t(b_down), res, bits=4)
    assert k3.dtype == torch.bfloat16 and _rel_err(k3, pd) < 5e-3
    k2 = fused_up_proj_down(x_up, x_proj, res, t(p_up), t(p_proj), t(p_down), t(s_up),
                            t(s_proj), t(s_down), t(b_up), t(b_down), act="gelu-tanh", bits=4)
    assert k2.shape == (M, H) and _rel_err(k2, pd) < 2e-2


def _jax_group_dot(x, p, s, G):
    """The JAX kernels' group-wise contraction: one fp32 dot per K group,
    scaled by that group's row (tests/test_fused_kernels.py)."""
    xf, w = x.astype(jnp.float32), jnp.asarray(p, jnp.float32)
    K = w.shape[0]
    if not G:
        return (xf @ w) * s
    return sum((xf[:, g * G:(g + 1) * G] @ w[g * G:(g + 1) * G]) * s[g] for g in range(K // G))


def _k13_against_pallas_interpret(M, G):
    rng = np.random.default_rng(0)
    K, N1, N2, L = 512, 768, 1024, 2
    (jx1, x1), (jx2, x2) = (_bf16_pair(rng.standard_normal((M, K)).astype(np.float32))
                            for _ in range(2))
    p1 = rng.integers(-128, 128, (L, K, N1)).astype(np.int8)
    p2 = rng.integers(-128, 128, (L, K, N2)).astype(np.int8)
    s1 = (rng.random((L, N1) if not G else (L, K // G, N1)) * 0.02).astype(np.float32)
    s2 = (rng.random((L, N2) if not G else (L, K // G, N2)) * 0.02).astype(np.float32)
    b1 = rng.standard_normal((L, 1, N1)).astype(np.float32)
    b2 = rng.standard_normal((L, 1, N2)).astype(np.float32)
    ref = jax_fused_qkv_up(jx1, jx2, *(jnp.asarray(a) for a in (p1, p2, s1, s2, b1, b2)),
                           jnp.int32(1), bits=8, G=G, bn=256, bk=256, act2="gelu-tanh",
                           interpret=True)
    t = torch.from_numpy
    y1, y2 = fused_qkv_up(x1, x2, t(p1[1]), t(p2[1]), t(s1[1]), t(s2[1]), t(b1[1, 0]),
                          t(b2[1, 0]), act2="gelu-tanh", group_size=G)
    assert y1.shape == (M, N1) and y2.shape == (M, N2) and y1.dtype == torch.bfloat16
    assert _rel_err(torch.cat([y1, y2], 1), ref) < 5e-3


@pytest.mark.parametrize("G", [0, 128])
def test_plain_k13_matches_pallas_interpret(G):
    """K13 plain against the JAX ``fused_qkv_up`` in interpret mode, at the
    cases of tests/test_fused_kernels.py::test_fused_qkv_up_int8 (5e-3), with
    the up activation (tanh-gelu) in both; the port's two outputs compared
    as their concatenation."""
    _k13_against_pallas_interpret(3, G)


@pytest.mark.parametrize("G", [0, 128])
def test_plain_k13_matches_pallas_interpret_at_pool_width(G):
    _k13_against_pallas_interpret(8, G)


def _k13_int4_against_group_dots(M, G):
    from fastertransformer4codefuse_tpu.models.params import QuantizedTensor as JaxQT

    rng = np.random.default_rng(5)
    K, N1, N2 = 256, 384, 512
    (jx1, x1), (jx2, x2) = (_bf16_pair(rng.standard_normal((M, K)).astype(np.float32))
                            for _ in range(2))
    p1, p2 = (rng.integers(-128, 128, (K // 2, n)).astype(np.int8) for n in (N1, N2))
    sdt = jnp.bfloat16 if G else jnp.float32
    s1, s2 = (jnp.asarray(rng.random((K // G, n) if G else n) * 0.06 + 0.01, sdt)
              for n in (N1, N2))
    b1, b2 = (rng.standard_normal(n).astype(np.float32) for n in (N1, N2))
    unpack = lambda p: JaxQT(q=jnp.asarray(p), scale=None, k_axis=-2, bits=4).unpack()  # noqa: E731
    r1 = _jax_group_dot(jx1, unpack(p1), s1.astype(jnp.float32), G) + b1
    r2 = jax.nn.gelu(_jax_group_dot(jx2, unpack(p2), s2.astype(jnp.float32), G) + b2,
                     approximate=True)
    ref = jnp.concatenate([r1, r2], axis=1).astype(jnp.bfloat16)
    t = torch.from_numpy
    ts = lambda s: torch.from_numpy(np.asarray(s.astype(jnp.float32))).to(  # noqa: E731
        torch.bfloat16 if G else torch.float32)
    y1, y2 = fused_qkv_up(x1, x2, t(p1), t(p2), ts(s1), ts(s2), t(b1), t(b2),
                          act2="gelu-tanh", bits=4, group_size=G)
    assert _rel_err(torch.cat([y1, y2], 1), ref) < 5e-3


@pytest.mark.parametrize("G", [0, 128])
def test_plain_k13_int4_matches_jax_group_dots(G):
    """int4 K13 (the JAX int4 Pallas kernels do not run on the CPU) against
    the JAX kernels' own arithmetic: per-group dots of the unpacked nibbles,
    bias, the up activation, one bf16 rounding (5e-3)."""
    _k13_int4_against_group_dots(3, G)


@pytest.mark.parametrize("G", [0, 128])
def test_plain_k13_int4_matches_jax_group_dots_at_pool_width(G):
    _k13_int4_against_group_dots(8, G)


def test_plain_k2_k3_group_scales_match_pallas_interpret():
    """K2 and K3 with group scales (G = 128, int8: the JAX interpret-mode
    cases of tests/test_fused_kernels.py, 2e-2 and 5e-3)."""
    G = 128
    rng = np.random.default_rng(2)
    M, H, F, L = 3, 512, 1024, 2
    (jx_up, x_up), (jx_proj, x_proj), (jres, res) = (
        _bf16_pair(rng.standard_normal((M, H)).astype(np.float32)) for _ in range(3)
    )
    p_up = rng.integers(-128, 128, (L, H, F)).astype(np.int8)
    p_proj = rng.integers(-128, 128, (L, H, H)).astype(np.int8)
    p_down = rng.integers(-128, 128, (L, F, H)).astype(np.int8)
    s_up, s_proj, s_down = ((rng.random((L, k // G, n)) * 0.02).astype(np.float32)
                            for k, n in ((H, F), (H, H), (F, H)))
    b_up = rng.standard_normal((L, 1, F)).astype(np.float32)
    b_down = rng.standard_normal((L, 1, H)).astype(np.float32)
    ops = tuple(jnp.asarray(a) for a in (p_up, p_proj, p_down, s_up, s_proj, s_down, b_up,
                                         b_down))
    ref = jax_fused_up_proj_down(jx_up, jx_proj, jres, *ops, jnp.int32(1), bits=8, G=G,
                                 act="gelu-tanh", bku=256, bkp=256, bkd=256, interpret=True)
    t = torch.from_numpy
    got = fused_up_proj_down(
        x_up, x_proj, res, t(p_up[1]), t(p_proj[1]), t(p_down[1]), t(s_up[1]), t(s_proj[1]),
        t(s_down[1]), t(b_up[1, 0]), t(b_down[1, 0]), act="gelu-tanh", group_size=G,
    )
    assert got.dtype == torch.bfloat16 and got.shape == (M, H)
    assert _rel_err(got, ref) < 2e-2
    # K3 at the shapes of test_fused_proj_down_int8_with_residual (the JAX
    # kernel tiles K in multiples of 8 G unless K1 == K2)
    M, K1, K2, N = 3, 1024, 2048, 768
    (jx1, x1), (jx2, x2) = (
        _bf16_pair(rng.standard_normal((M, k)).astype(np.float32)) for k in (K1, K2)
    )
    p1 = rng.integers(-128, 128, (L, K1, N)).astype(np.int8)
    p2 = rng.integers(-128, 128, (L, K2, N)).astype(np.int8)
    s1, s2 = ((rng.random((L, k // G, N)) * 0.02).astype(np.float32) for k in (K1, K2))
    b = rng.standard_normal((L, 1, N)).astype(np.float32)
    jres, res = _bf16_pair(rng.standard_normal((M, N)).astype(np.float32))
    ref3 = jax_fused_proj_down(jx1, jx2, *(jnp.asarray(a) for a in (p1, p2, s1, s2, b)), jres,
                               jnp.int32(0), bits=8, G=G, bn=256, bk=256, interpret=True)
    got3 = fused_proj_down(x1, x2, t(p1[0]), t(p2[0]), t(s1[0]), t(s2[0]), t(b[0, 0]), res,
                           group_size=G)
    assert _rel_err(got3, ref3) < 5e-3


def test_plain_k2_k3_int4_group_scales_match_jax_group_dots():
    """int4 with bf16 group scales (G = 128): K2 and K3 against the JAX
    kernels' per-group arithmetic (the hidden rounded to bf16 before down)."""
    from fastertransformer4codefuse_tpu.models.params import QuantizedTensor as JaxQT

    G = 128
    rng = np.random.default_rng(6)
    M, H, F = 2, 256, 512
    (jx_up, x_up), (jx_proj, x_proj), (jres, res) = (
        _bf16_pair(rng.standard_normal((M, H)).astype(np.float32)) for _ in range(3)
    )
    ps = [rng.integers(-128, 128, (k // 2, n)).astype(np.int8)
          for k, n in ((H, F), (H, H), (F, H))]
    ss = [jnp.asarray(rng.random((k // G, n)) * 0.06 + 0.01, jnp.bfloat16)
          for k, n in ((H, F), (H, H), (F, H))]
    b_up, b_down = (rng.standard_normal(n).astype(np.float32) for n in (F, H))
    unpack = lambda p: JaxQT(q=jnp.asarray(p), scale=None, k_axis=-2, bits=4).unpack()  # noqa: E731
    s32 = [s.astype(jnp.float32) for s in ss]
    h = jax.nn.gelu(_jax_group_dot(jx_up, unpack(ps[0]), s32[0], G) + b_up, approximate=True)
    h = h.astype(jnp.bfloat16)
    ref = (_jax_group_dot(jx_proj, unpack(ps[1]), s32[1], G)
           + _jax_group_dot(h, unpack(ps[2]), s32[2], G) + b_down + jres.astype(jnp.float32))
    t = torch.from_numpy
    ts = [torch.from_numpy(np.asarray(s)).to(torch.bfloat16) for s in s32]
    got = fused_up_proj_down(x_up, x_proj, res, t(ps[0]), t(ps[1]), t(ps[2]), *ts, t(b_up),
                             t(b_down), act="gelu-tanh", bits=4, group_size=G)
    assert _rel_err(got, ref) < 2e-2
    th = torch.from_numpy(np.asarray(h.astype(jnp.float32))).to(torch.bfloat16)
    got3 = fused_proj_down(x_proj, th, t(ps[1]), t(ps[2]), ts[1], ts[2], t(b_down), res, bits=4,
                           group_size=G)
    ref3 = (_jax_group_dot(jx_proj, unpack(ps[1]), s32[1], G)
            + _jax_group_dot(h, unpack(ps[2]), s32[2], G) + b_down + jres.astype(jnp.float32))
    assert _rel_err(got3, ref3) < 5e-3
