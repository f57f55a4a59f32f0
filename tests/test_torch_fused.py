"""K2 and K3 plain versions (fastertransformer4codefuse_tpu_torch/ops/
quant_matmul_fused.py) against the JAX Pallas kernels in interpret mode, at
the shapes of tests/test_fused_kernels.py. bf16 inputs (rounded identically
for both packages) and the tolerances those tests use: max |diff| / max |ref|
below 2e-2 for K2 (the bf16 hidden may round differently) and 5e-3 for K3."""
import numpy as np
import torch

import jax.numpy as jnp

from fastertransformer4codefuse_tpu.ops.quant_matmul_fused import (
    fused_proj_down as jax_fused_proj_down,
    fused_up_proj_down as jax_fused_up_proj_down,
)
from fastertransformer4codefuse_tpu_torch.ops.quant_matmul_fused import (
    fused_proj_down,
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


def test_plain_k3_matches_pallas_interpret():
    rng = np.random.default_rng(1)
    M, K1, K2, N, L = 3, 1024, 2048, 768, 2
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
