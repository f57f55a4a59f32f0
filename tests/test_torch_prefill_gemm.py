"""The prefill-width GEMM and K10 on the CPU: the plain versions of K1, K6,
K7 and K13 at the GEMM's widths (M = 130 and 257: a partial 128-row block and
one row past two) against the JAX package, and the host-side plans the TMA +
wgmma kernels follow (``csrc/ftcf_gemm.cuh``, ``csrc/flash_chunk.cu``), as
properties over random shapes.

K1 and int8 K13 run against the JAX Pallas kernels in interpret mode; int4
K6/K7 against the JAX int4 XLA path and int4 K13 against the JAX kernels'
per-group dots, as tests/test_torch_quant_w4.py and tests/test_torch_fused.py
hold them (the JAX W4 Pallas kernels' int4 bitcast in interpret mode is
backend-defined). Tolerances as there: fp32 inputs 1e-5 (summation order
only); bf16 K13 5e-3 of max |ref|."""
import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

from fastertransformer4codefuse_tpu.models.params import QuantizedTensor as JaxQT
from fastertransformer4codefuse_tpu.ops.linear import linear as jax_linear
from fastertransformer4codefuse_tpu.ops.quant_matmul import quant_matmul_pallas
from fastertransformer4codefuse_tpu.ops.quant_matmul_fused import fused_qkv_up as jax_fused_qkv_up
from fastertransformer4codefuse_tpu_torch.ops.flash_decode import (
    CHUNK_MAX_RANKED,
    chunk_block_order,
    chunk_key_tile,
    chunk_page_box,
)
from fastertransformer4codefuse_tpu_torch.ops.quant_matmul import (
    GEMM_BK,
    GEMM_BM,
    GEMM_BN,
    gemm_group_rows,
    gemm_tiles,
    quant_matmul,
)
from fastertransformer4codefuse_tpu_torch.ops.quant_matmul_fused import fused_qkv_up
from fastertransformer4codefuse_tpu_torch.ops.quant_matmul_w4 import (
    quant_matmul_w4,
    quant_matmul_w4_group,
)

torch.set_num_threads(2)

GEMM_WIDTHS = [130, 257]


def _rel(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("M", GEMM_WIDTHS)
def test_plain_k1_matches_pallas_interpret_at_gemm_widths(M):
    rng = np.random.default_rng(M)
    x = rng.standard_normal((M, 256)).astype(np.float32)
    w = rng.integers(-127, 128, (256, 384)).astype(np.int8)
    s = (rng.random(384) * 0.004 + 0.0005).astype(np.float32)
    ref = quant_matmul_pallas(jnp.asarray(x), jnp.asarray(w), jnp.asarray(s),
                              out_dtype=jnp.float32, bm=128, bn=128, bk=128, interpret=True)
    got = quant_matmul(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(s))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("M", GEMM_WIDTHS)
@pytest.mark.parametrize("G", [0, 32, 128])
def test_plain_k6_k7_match_jax_int4_linear_at_gemm_widths(M, G):
    rng = np.random.default_rng(300 + M + G)
    K, N = 256, 144  # N ends inside a 128-column block
    x = rng.standard_normal((M, K)).astype(np.float32)
    p = rng.integers(-128, 128, (K // 2, N)).astype(np.int8)
    b = (rng.standard_normal(N) * 0.1).astype(np.float32)
    if G:
        s = jnp.asarray((rng.random((K // G, N)) * 0.06 + 0.01).astype(np.float32), jnp.bfloat16)
        ts = torch.from_numpy(np.array(s).view(np.int16)).view(torch.bfloat16)
    else:
        s = (rng.random(N) * 0.06 + 0.01).astype(np.float32)
        ts = torch.from_numpy(s)
    jqt = JaxQT(q=jnp.asarray(p), scale=jnp.asarray(s), k_axis=-2, bits=4, group_size=G)
    ref = jax_linear(jnp.asarray(x), jqt, jnp.asarray(b), act="gelu-tanh")
    T = torch.from_numpy
    if G:
        got = quant_matmul_w4_group(T(x), T(p), ts, G, T(b), "gelu-tanh")
    else:
        got = quant_matmul_w4(T(x), T(p), ts, T(b), "gelu-tanh")
    assert _rel(got, ref) < 1e-5


@pytest.mark.parametrize("M", GEMM_WIDTHS)
@pytest.mark.parametrize("G", [0, 128])
def test_plain_k13_matches_pallas_interpret_at_gemm_widths(M, G):
    rng = np.random.default_rng(400 + M + G)
    K, N1, N2, L = 512, 768, 1024, 2
    xs = [rng.standard_normal((M, K)).astype(np.float32) for _ in range(2)]
    jx = [jnp.asarray(a, jnp.bfloat16) for a in xs]
    tx = [torch.from_numpy(a).to(torch.bfloat16) for a in xs]
    p1 = rng.integers(-128, 128, (L, K, N1)).astype(np.int8)
    p2 = rng.integers(-128, 128, (L, K, N2)).astype(np.int8)
    s1 = (rng.random((L, N1) if not G else (L, K // G, N1)) * 0.02).astype(np.float32)
    s2 = (rng.random((L, N2) if not G else (L, K // G, N2)) * 0.02).astype(np.float32)
    b1 = rng.standard_normal((L, 1, N1)).astype(np.float32)
    b2 = rng.standard_normal((L, 1, N2)).astype(np.float32)
    ref = jax_fused_qkv_up(jx[0], jx[1], *(jnp.asarray(a) for a in (p1, p2, s1, s2, b1, b2)),
                           jnp.int32(1), bits=8, G=G, bn=256, bk=256, act2="gelu-tanh",
                           interpret=True)
    t = torch.from_numpy
    y1, y2 = fused_qkv_up(tx[0], tx[1], t(p1[1]), t(p2[1]), t(s1[1]), t(s2[1]), t(b1[1, 0]),
                          t(b2[1, 0]), act2="gelu-tanh", group_size=G)
    got = torch.cat([y1, y2], 1).float().numpy()
    ref = np.asarray(ref.astype(jnp.float32))
    assert float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-6)) < 5e-3


@pytest.mark.parametrize("M", GEMM_WIDTHS)
@pytest.mark.parametrize("G", [0, 128])
def test_plain_k13_int4_matches_jax_group_dots_at_gemm_widths(M, G):
    rng = np.random.default_rng(500 + M + G)
    K, N1, N2 = 256, 144, 512
    xs = [rng.standard_normal((M, K)).astype(np.float32) for _ in range(2)]
    jx = [jnp.asarray(a, jnp.bfloat16).astype(jnp.float32) for a in xs]
    tx = [torch.from_numpy(a).to(torch.bfloat16) for a in xs]
    p1, p2 = (rng.integers(-128, 128, (K // 2, n)).astype(np.int8) for n in (N1, N2))
    sdt = jnp.bfloat16 if G else jnp.float32
    s1, s2 = (jnp.asarray(rng.random((K // G, n) if G else n) * 0.06 + 0.01, sdt)
              for n in (N1, N2))
    b1, b2 = (rng.standard_normal(n).astype(np.float32) for n in (N1, N2))

    def contract(x, p, s):  # the JAX kernels' arithmetic: one fp32 dot per K group
        w = JaxQT(q=jnp.asarray(p), scale=None, k_axis=-2, bits=4).unpack().astype(jnp.float32)
        s = s.astype(jnp.float32)
        if not G:
            return (x @ w) * s
        return sum((x[:, g * G:(g + 1) * G] @ w[g * G:(g + 1) * G]) * s[g]
                   for g in range(K // G))

    r1 = contract(jx[0], p1, s1) + b1
    r2 = jax.nn.gelu(contract(jx[1], p2, s2) + b2, approximate=True)
    ref = np.asarray(jnp.concatenate([r1, r2], axis=1).astype(jnp.bfloat16).astype(jnp.float32))
    ts = lambda s: torch.from_numpy(np.asarray(s.astype(jnp.float32))).to(  # noqa: E731
        torch.bfloat16 if G else torch.float32)
    y1, y2 = fused_qkv_up(tx[0], tx[1], torch.from_numpy(p1), torch.from_numpy(p2), ts(s1),
                          ts(s2), torch.from_numpy(b1), torch.from_numpy(b2), act2="gelu-tanh",
                          bits=4, group_size=G)
    got = torch.cat([y1, y2], 1).float().numpy()
    assert float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-6)) < 5e-3


# --- the plans the kernels follow, as properties -----------------------------

@settings(max_examples=200, deadline=None, database=None)
@given(M=st.integers(33, 20000), N1=st.integers(1, 8000).map(lambda n: 16 * n),
       N2=st.one_of(st.just(0), st.integers(1, 4000).map(lambda n: 16 * n)))
def test_gemm_tiles_cover_the_output(M, N1, N2):
    """128 x 128 blocks cover every output element of both segments once,
    each segment's columns in its own blocks (so a segment's blocks are the
    GEMM's alone on it), and the column blocks do not depend on M."""
    blocks = gemm_tiles(M, N1, N2)
    rows = -(-M // GEMM_BM)
    assert blocks % rows == 0
    cols = blocks // rows
    assert cols == gemm_tiles(M + 1000, N1, N2) // -(-(M + 1000) // GEMM_BM)
    assert cols == gemm_tiles(M, N1) // rows + (gemm_tiles(M, N2) // rows if N2 else 0)
    for n in (N1, N2):
        if n:
            c = gemm_tiles(M, n) // rows
            assert (c - 1) * GEMM_BN < n <= c * GEMM_BN


@settings(max_examples=300, deadline=None, database=None)
@given(units=st.integers(1, 400), G=st.integers(1, 200).map(lambda g: 2 * g))
def test_gemm_group_rows_hold_every_k_tile(units, G):
    """The group-scale rows a stage brings cover the groups of every 64-deep
    k tile of K (K a multiple of the even group size G), never past K / G,
    and fit the stage (at most 33 rows: a 64-deep tile over groups of 2)."""
    K = G * units
    rows = gemm_group_rows(K, G)
    assert 1 <= rows <= min(K // G, 33)
    for k0 in range(0, K, GEMM_BK):
        first, last = k0 // G, (min(k0 + GEMM_BK, K) - 1) // G
        assert last - first + 1 <= rows
        # the two k rows of a packed int4 byte share a group
        assert all((k0 + 2 * i) // G == (k0 + 2 * i + 1) // G for i in range(32))
    assert rows == max(((min(k0 + GEMM_BK, K) - 1) // G - k0 // G + 1
                        for k0 in range(0, K, GEMM_BK)))


@settings(max_examples=300, deadline=None, database=None)
@given(ps=st.integers(1, 600), dh=st.sampled_from([128, 256]), packed=st.booleans())
def test_k10_page_boxes_stay_inside_a_page(ps, dh, packed):
    """A TMA box of K10 holds g keys: g divides the key tile and the page,
    so the boxes of a tile start at multiples of g and none crosses a page;
    packed pages (even sizes) take g / 2 whole pair rows."""
    if packed and ps % 2:
        ps += 1
    bn, g = chunk_key_tile(dh), chunk_page_box(ps, dh)
    assert bn % g == 0 and ps % g == 0 and g == math.gcd(ps, bn)
    if packed:
        assert g % 2 == 0
    for t in range(3):
        for i in range(bn // g):
            key = t * bn + i * g
            assert key // ps == (key + g - 1) // ps


@settings(max_examples=200, deadline=None, database=None)
@given(pos=st.lists(st.integers(0, 3000), min_size=1, max_size=12),
       C=st.integers(1, 600), gq=st.integers(1, 8), ps=st.sampled_from([16, 64, 128, 256]),
       dh=st.sampled_from([128, 256]))
def test_k10_block_order_starts_the_longest_first(pos, C, gq, ps, dh):
    """The blocks of one K10 launch take every (query tile, row) pair once;
    when the block ranks them, those with the most key tiles come first (ties
    in index order); past ``CHUNK_MAX_RANKED`` pairs, query tiles descend."""
    n_pg = -(-(max(pos) + C) // ps)
    order = chunk_block_order(pos, C, gq, n_pg, ps, dh)
    n_rt, B, bn = -(-C * gq // 128), len(pos), chunk_key_tile(dh)
    assert sorted(order) == [(t, b) for t in range(n_rt) for b in range(B)]

    def tiles(tb):
        t, b = tb
        return min(pos[b] + (min(C * gq, 128 * t + 128) - 1) // gq, n_pg * ps - 1) // bn + 1

    work = [tiles(tb) for tb in order]
    if n_rt * B <= CHUNK_MAX_RANKED:
        assert work == sorted(work, reverse=True)
        for a, b in zip(order, order[1:]):
            if tiles(a) == tiles(b):
                assert a[0] * B + a[1] < b[0] * B + b[1]
    else:
        assert [t for t, _ in order] == sorted((t for t, _ in order), reverse=True)
