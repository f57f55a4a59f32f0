"""The CUDA kernels K1-K13 against their plain versions on the card, at small
and ragged shapes (K1, K2/K3 and K13 also with group scales, int8 and int4;
K7 also as the group-wise transposed head, fp32 out; K3, K7
and K13 with groups of 32 and 64 whose splits do not divide K; K13's
segments also bit for bit against K1/K6/K7 run alone; the fp32
group-scale instances of K7, K2, K3 and K13 (int4, the JAX package's
``FTCF_GSCALE_BF16=0``) against their plain versions and, on scales that
bf16 holds exactly, bit for bit against the bf16 instances; K5 at key tiles and
one past them, lengths of 1, GQA up to 8 query heads a KV head, dh 64, 128
and 256, two calls equal byte for byte; its fp32 instance with the
log-sum-exp and its backward, the dK/dV and dQ kernels, within 1e-4 through
the kernels' wrappers and autograd, deterministic), K4/K9/K10/K11 also on packed int4 caches (chip_smoke.py
covers the CodeFuse-13B and Longformer-base shapes); K11 also bit for bit
against K4 over a physically gathered copy of its cache. The prefill-width
GEMM (K1/K6/K7/K13 at M > 32) at its tile edges, on a layer's view of a
stacked weight, with ragged K13 segments, its rows bit for bit the same at
every M and two calls equal; K10 on pages under a key tile, 8 query heads a
KV head, chunks across three pages, every format poisoned past the chunk,
two calls equal, and bf16 pages off the swizzle groups (sizes 12 and 5,
landed as raw rows). K4, K9 and K11 also at dh 64, with 12, 16, 48, 64, 65
and 80 query heads a KV head, rows ending across a split boundary (255,
256, 257) and at one position, each row the same bit for bit alone or in a
batch of 8 and two calls equal; the configurations of chip_smoke.py
ROUTE_CONFIGS served on the card give the CPU's greedy tokens. K12 at the
band's edges (w = 0, 130, S and wider than S; lengths off the 128-key tiles;
empty rows; both band modes) held per (query, head) row, and two calls
equal. Launch plans from the tile cache (``ops/tile_tuning.py``): every GEMM
block tile, group-M width and stage cap (ragged M and N, int8 / int4 / g128
/ fp32 and int8 group scales, K13's joined segments) within 1e-2 of the
plain version and bit for bit the default plan's output; GEMV split counts
of K1 / K6 / K7, K13 and K3; rows the same at every M under one split count;
another card's entry a miss, an entry the kernels have no instance for a
ValueError. Marked ``cuda``: skipped where there is no
GPU. On a GPU machine without jax:

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py

Tolerance: max |kernel - plain| / max |plain| below 1e-2 for the GEMMs (bf16
output rounding plus fp32 summation order) and 2e-2 where a bf16
intermediate (K2's hidden, K4/K5/K9-K12's probabilities) may round
differently."""
import json

import pytest
import torch

import chip_smoke
from fastertransformer4codefuse_tpu_torch.ops.attention import (
    prefill_attention_flash,
    prefill_attention_flash_plain,
    prefill_flash_bwd_dkv,
    prefill_flash_bwd_dq,
    prefill_flash_forward,
    prefill_flash_lse_plain,
)
from fastertransformer4codefuse_tpu_torch.ops.flash_decode import (
    flash_chunk_paged,
    flash_chunk_paged_plain,
    flash_decode_beam_plain,
    flash_decode_beam_stacked,
    flash_decode_paged,
    flash_decode_paged_plain,
    flash_decode_stacked,
    flash_decode_stacked_plain,
    gather_beam_rows,
    is_packed,
    pack_seq_pairs,
    unpack_seq_pairs,
)
from fastertransformer4codefuse_tpu_torch.ops.quant_matmul import quant_matmul, quant_matmul_plain
from fastertransformer4codefuse_tpu_torch.ops.quant_matmul_fused import (
    fused_proj_down,
    fused_proj_down_plain,
    fused_qkv_up,
    fused_qkv_up_plain,
    fused_up_proj_down,
    fused_up_proj_down_plain,
)
from fastertransformer4codefuse_tpu_torch.ops.quant_matmul_w4 import (
    quant_matmul_w4,
    quant_matmul_w4_group,
    quant_matmul_w4_group_plain,
    quant_matmul_w4_head,
    quant_matmul_w4_head_plain,
    quant_matmul_w4_plain,
)
from fastertransformer4codefuse_tpu_torch.ops.sliding_window import (
    sliding_window_attention,
    sliding_window_attention_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.Generator(device="cuda").manual_seed(0)


def _i8(gen, *shape):
    return torch.empty(shape, dtype=torch.int8, device="cuda").random_(-128, 128, generator=gen)


def _bf(gen, *shape, std=1.0):
    return (torch.randn(shape, device="cuda", generator=gen) * std).to(torch.bfloat16)


def _scale(gen, n):
    return torch.rand(n, device="cuda", generator=gen) * 0.004 + 0.0005


def _rel(got, ref):
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got.float()).all())
    return ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


@pytest.mark.parametrize("M", [1, 3, 5, 32, 33, 130])
@pytest.mark.parametrize("K,N", [(256, 384), (136, 144), (1024, 48)])
@pytest.mark.parametrize("act,bias_dtype", [(None, None), ("gelu", torch.float32),
                                            ("gelu-tanh", torch.bfloat16), ("relu", None),
                                            ("silu", torch.bfloat16)])
def test_k1_matches_plain(gen, M, K, N, act, bias_dtype):
    x, w, s = _bf(gen, M, K), _i8(gen, K, N), _scale(gen, N)
    b = None if bias_dtype is None else (torch.randn(N, device="cuda", generator=gen) * 0.1).to(bias_dtype)
    before = quant_matmul.launches
    got = quant_matmul(x, w, s, b, act)
    assert quant_matmul.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    assert _rel(got, quant_matmul_plain(x, w, s, b, act)) < 1e-2


@pytest.mark.parametrize("M", [1, 3, 5, 32, 33, 130])
@pytest.mark.parametrize("K,N,G", [(256, 384, 128), (256, 144, 32), (2048, 160, 128),
                                   (1152, 128, 64)])
@pytest.mark.parametrize("act", [None, "gelu-tanh"])
def test_k1_group_int8_matches_plain(gen, M, K, N, G, act):
    """K1's W_I8G instances (fp32 group scales [K/G, N]): the GEMV at
    M <= 32 (splits of whole groups; 1152 = 18 groups of 64 that the splits
    do not divide evenly), the TMA + wgmma GEMM above, each counted in
    ``launches_g8``."""
    x, w = _bf(gen, M, K), _i8(gen, K, N)
    s = torch.rand(K // G, N, device="cuda", generator=gen) * 0.004 + 0.0005
    b = (torch.randn(N, device="cuda", generator=gen) * 0.1).bfloat16()
    before, before_g = quant_matmul.launches, quant_matmul.launches_g8
    got = quant_matmul(x, w, s, b, act, group_size=G)
    assert (quant_matmul.launches, quant_matmul.launches_g8) == (before + 1, before_g + 1)
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    assert _rel(got, quant_matmul_plain(x, w, s, b, act, group_size=G)) < 1e-2


@pytest.mark.parametrize("M", [1, 4, 7, 40])
@pytest.mark.parametrize("G,scale_dtype", [(128, torch.bfloat16), (128, torch.float32),
                                           (32, torch.bfloat16)])
def test_k7_group_head_matches_plain(gen, M, G, scale_dtype):
    """K7 with fp32 out: the group-wise transposed int4 LM head [H/2, V_pad]
    with scales [H/G, V_pad], as ``quantized_matmul_transposed_head`` runs
    it."""
    H, Vp = 512, 2560
    x, packed = _bf(gen, M, H), _i8(gen, H // 2, Vp)
    s = ((torch.rand(H // G, Vp, device="cuda", generator=gen) * 0.06 + 0.01)).to(scale_dtype)
    before = quant_matmul_w4_group.launches_head
    got = quant_matmul_w4_group(x, packed, s, G, out_dtype=torch.float32)
    assert quant_matmul_w4_group.launches_head == before + 1
    assert got.dtype == torch.float32 and got.shape == (M, Vp)
    ref = quant_matmul_w4_group_plain(x.float(), packed, s, G)  # fp32 out
    assert _rel(got, ref) < 1e-2


def test_k1_layer_view_of_stacked_weight(gen):
    w_all, s_all = _i8(gen, 3, 256, 384), torch.rand(3, 384, device="cuda", generator=gen) * 1e-3
    x = _bf(gen, 4, 256)
    got = quant_matmul(x, w_all[2], s_all[2])
    assert _rel(got, quant_matmul_plain(x, w_all[2], s_all[2])) < 1e-2


def test_k1_raises_on_what_it_does_not_take(gen):
    x, w, s = _bf(gen, 2, 64), _i8(gen, 64, 32), _scale(gen, 32)
    with pytest.raises(ValueError):
        quant_matmul(x.float(), w, s)  # fp32 activations: no silent fallback
    with pytest.raises(ValueError):
        quant_matmul(x, _i8(gen, 64, 40), _scale(gen, 40))  # N % 16
    with pytest.raises(ValueError):
        quant_matmul(_bf(gen, 64, 2).t(), w, s)  # non-contiguous x


@pytest.mark.parametrize("M", [1, 4, 9])
def test_k2_k3_match_plain(gen, M):
    H, F = 256, 1024
    x_up, x_proj, res, h = _bf(gen, M, H), _bf(gen, M, H), _bf(gen, M, H), _bf(gen, M, F, std=0.5)
    w_up, w_proj, w_down = _i8(gen, H, F), _i8(gen, H, H), _i8(gen, F, H)
    s_up, s_proj, s_down = _scale(gen, F), _scale(gen, H), _scale(gen, H)
    b_up, b_down = _bf(gen, F, std=0.1), _bf(gen, H, std=0.1)
    k3 = fused_proj_down(x_proj, h, w_proj, w_down, s_proj, s_down, b_down, res)
    assert _rel(k3, fused_proj_down_plain(x_proj, h, w_proj, w_down, s_proj, s_down, b_down, res)) < 1e-2
    for act in ("gelu-tanh", "relu", "silu"):
        args = (x_up, x_proj, res, w_up, w_proj, w_down, s_up, s_proj, s_down, b_up, b_down, act)
        assert _rel(fused_up_proj_down(*args), fused_up_proj_down_plain(*args)) < 2e-2


@pytest.mark.parametrize(
    "B,nH,nKV,dh,S,quant",
    [(4, 8, 8, 128, 300, True), (2, 8, 4, 128, 200, True), (3, 16, 2, 128, 129, False),
     (2, 4, 4, 256, 70, True), (2, 4, 4, 256, 64, False), (4, 4, 4, 64, 300, True),
     (3, 8, 2, 64, 129, False), (2, 12, 1, 128, 300, True), (3, 16, 1, 128, 129, False),
     (4, 48, 1, 128, 300, True), (2, 48, 1, 64, 70, False), (2, 32, 2, 256, 64, True),
     (2, 64, 1, 128, 300, True), (2, 64, 1, 256, 70, False), (2, 65, 1, 128, 129, True),
     (4, 80, 1, 64, 300, True), (2, 160, 2, 128, 70, False), (2, 144, 1, 256, 64, True)],
)
def test_k4_matches_plain(gen, B, nH, nKV, dh, S, quant):
    L = 2
    q = _bf(gen, B, nH, dh)
    if quant:
        k, v = _i8(gen, L, B, nKV, S, dh), _i8(gen, L, B, nKV, S, dh)
        ks = (torch.rand(L, B, nKV, S, device="cuda", generator=gen) * 0.02).bfloat16()
        vs = (torch.rand(L, B, nKV, S, device="cuda", generator=gen) * 0.02).bfloat16()
    else:
        k, v, ks, vs = _bf(gen, L, B, nKV, S, dh), _bf(gen, L, B, nKV, S, dh), None, None
    pos = torch.tensor([0, S - 1, 63, 64][:B], dtype=torch.int32, device="cuda")
    sm = dh ** -0.5
    got = flash_decode_stacked(q, k, ks, v, vs, 1, pos, sm)
    assert _rel(got, flash_decode_stacked_plain(q, k, ks, v, vs, 1, pos, sm)) < 2e-2


@pytest.mark.parametrize("quant", [True, False])
def test_k4_k11_read_a_row_range_view_of_the_cache(gen, quant):
    """A pipeline decode microbatch hands K4 and K11 rows [r0, r0 + mb) of
    the stacked cache as a view (each layer's slab contiguous, the stack
    not): the same bytes as on a contiguous copy of those rows, and a
    cache whose layer slabs are not contiguous is still refused."""
    L, B, nH, nKV, dh, S, r0, mb = 2, 6, 8, 4, 128, 300, 2, 4
    if quant:
        k, v = _i8(gen, L, B, nKV, S, dh), _i8(gen, L, B, nKV, S, dh)
        ks = (torch.rand(L, B, nKV, S, device="cuda", generator=gen) * 0.02).bfloat16()
        vs = (torch.rand(L, B, nKV, S, device="cuda", generator=gen) * 0.02).bfloat16()
    else:
        k, v, ks, vs = _bf(gen, L, B, nKV, S, dh), _bf(gen, L, B, nKV, S, dh), None, None
    view = [None if t is None else t.narrow(1, r0, mb) for t in (k, ks, v, vs)]
    copy = [None if t is None else t.contiguous() for t in view]
    assert not view[0].is_contiguous()
    q = _bf(gen, mb, nH, dh)
    pos = torch.tensor([5, S - 1, 63, 200], dtype=torch.int32, device="cuda")
    got = flash_decode_stacked(q, view[0], view[1], view[2], view[3], 1, pos, 0.088)
    want = flash_decode_stacked(q, copy[0], copy[1], copy[2], copy[3], 1, pos, 0.088)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    indir = torch.randint(0, 2, (mb, S), dtype=torch.int32, device="cuda", generator=gen)
    got = flash_decode_beam_stacked(q, view[0], view[1], view[2], view[3], 1, pos, indir, 2,
                                    0.088)
    want = flash_decode_beam_stacked(q, copy[0], copy[1], copy[2], copy[3], 1, pos, indir, 2,
                                     0.088)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="contiguous"):
        flash_decode_stacked(q, k[:, r0:r0 + mb, :, ::2], None if ks is None else ks[:, r0:r0 + mb],
                             v[:, r0:r0 + mb, :, ::2], None if vs is None else vs[:, r0:r0 + mb],
                             1, pos, 0.088)


def test_k4_reads_stop_at_position(gen):
    B, nH, dh, S = 1, 4, 128, 256
    k, v, q = _bf(gen, 1, B, nH, S, dh), _bf(gen, 1, B, nH, S, dh), _bf(gen, B, nH, dh)
    pos = torch.tensor([100], dtype=torch.int32, device="cuda")
    clean = flash_decode_stacked(q, k, None, v, None, 0, pos, 0.088)
    k[..., 101:, :] = 1e4
    v[..., 101:, :] = float("nan")
    assert torch.equal(clean, flash_decode_stacked(q, k, None, v, None, 0, pos, 0.088))


def _gscale(gen, groups, n):
    return (torch.rand(groups, n, device="cuda", generator=gen) * 0.03 + 0.005).bfloat16()


W4_SHAPES = [(256, 384), (136, 144), (1024, 48), (2000, 160)]  # K % split, N % 128, odd


@pytest.mark.parametrize("M", [1, 3, 5, 32, 33, 130])
@pytest.mark.parametrize("K,N", W4_SHAPES)
@pytest.mark.parametrize("act,bias_dtype", [(None, None), ("gelu", torch.float32),
                                            ("gelu-tanh", torch.bfloat16), ("silu", None)])
def test_k6_matches_plain(gen, M, K, N, act, bias_dtype):
    x, p, s = _bf(gen, M, K), _i8(gen, K // 2, N), _scale(gen, N) * 16
    b = None if bias_dtype is None else (torch.randn(N, device="cuda", generator=gen) * 0.1).to(bias_dtype)
    before = quant_matmul_w4.launches
    got = quant_matmul_w4(x, p, s, b, act)
    assert quant_matmul_w4.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    assert _rel(got, quant_matmul_w4_plain(x, p, s, b, act)) < 1e-2


@pytest.mark.parametrize("M", [1, 3, 5, 32, 33, 130])
@pytest.mark.parametrize("K,N,G", [(256, 384, 128), (256, 144, 32), (2048, 160, 128),
                                   (1152, 48, 128), (1152, 160, 64), (2560, 48, 32)])
@pytest.mark.parametrize("act", [None, "gelu-tanh", "relu"])
def test_k7_matches_plain(gen, M, K, N, G, act):
    x, p, s = _bf(gen, M, K), _i8(gen, K // 2, N), _gscale(gen, K // G, N)
    b = _bf(gen, N, std=0.1)
    before = quant_matmul_w4_group.launches
    got = quant_matmul_w4_group(x, p, s, G, b, act)
    assert quant_matmul_w4_group.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    assert _rel(got, quant_matmul_w4_group_plain(x, p, s, G, b, act)) < 1e-2


@pytest.mark.parametrize("M", [1, 4, 7, 40])
def test_k8_matches_plain(gen, M):
    H, V = 512, 5120 + 16
    x, p, s = _bf(gen, M, H), _i8(gen, H // 2, V), _scale(gen, V) * 16
    before = quant_matmul_w4_head.launches
    got = quant_matmul_w4_head(x, p, s)
    assert quant_matmul_w4_head.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (M, V)
    # fp32 output: only the summation order differs
    assert _rel(got, quant_matmul_w4_head_plain(x, p, s)) < 1e-4


def test_k6_k8_nibble_order(gen):
    """Even K rows +1, odd K rows -1 in every column: x = e_0 reads +1, e_1
    reads -1; a swapped nibble order gives the opposite signs."""
    K, N = 64, 32
    p = torch.full((K // 2, N), (-1 << 4) | 1, dtype=torch.int8, device="cuda")
    s = torch.ones(N, device="cuda")
    x = torch.zeros(2, K, device="cuda", dtype=torch.bfloat16)
    x[0, 0] = 1
    x[1, 1] = 1
    for got in (quant_matmul_w4(x, p, s), quant_matmul_w4_head(x, p, s),
                quant_matmul_w4_group(x, p, s.bfloat16().expand(2, N).contiguous(), 32)):
        torch.cuda.synchronize()
        assert torch.equal(got.float().cpu(), torch.tensor([[1.0] * N, [-1.0] * N]))


@pytest.mark.parametrize("M", [1, 4, 9])
def test_k2_k3_int4_match_plain(gen, M):
    H, F = 256, 1024
    x_up, x_proj, res, h = _bf(gen, M, H), _bf(gen, M, H), _bf(gen, M, H), _bf(gen, M, F, std=0.5)
    w_up, w_proj, w_down = _i8(gen, H // 2, F), _i8(gen, H // 2, H), _i8(gen, F // 2, H)
    s_up, s_proj, s_down = (_scale(gen, n) * 16 for n in (F, H, H))
    b_up, b_down = _bf(gen, F, std=0.1), _bf(gen, H, std=0.1)
    args3 = (x_proj, h, w_proj, w_down, s_proj, s_down, b_down, res)
    assert _rel(fused_proj_down(*args3, bits=4), fused_proj_down_plain(*args3, bits=4)) < 1e-2
    for act in ("gelu-tanh", "relu", "silu"):
        args = (x_up, x_proj, res, w_up, w_proj, w_down, s_up, s_proj, s_down, b_up, b_down, act)
        assert _rel(fused_up_proj_down(*args, bits=4), fused_up_proj_down_plain(*args, bits=4)) < 2e-2


def test_w4_kernels_raise_on_what_they_do_not_take(gen):
    x, p, s = _bf(gen, 2, 64), _i8(gen, 32, 32), _scale(gen, 32)
    g = _gscale(gen, 2, 32)
    bad = [
        lambda: quant_matmul_w4(x.float(), p, s),  # fp32 activations
        lambda: quant_matmul_w4(x, _i8(gen, 64, 32), s),  # unpacked [K, N] weight
        lambda: quant_matmul_w4(x, _i8(gen, 32, 40), _scale(gen, 40)),  # N % 16
        lambda: quant_matmul_w4(x, p, g),  # group scales to the per-channel kernel
        lambda: quant_matmul_w4_group(x, p, s, 32),  # fp32 [N] scales to the group kernel
        lambda: quant_matmul_w4_group(x, p, g.double(), 32),  # fp64 group scales
        lambda: quant_matmul_w4_group(x, p, _gscale(gen, 3, 32), 24),  # G does not divide K
        lambda: quant_matmul_w4_group(x, p, _gscale(gen, 64, 32), 1),  # odd G
        lambda: quant_matmul_w4_head(x, p, s.bfloat16()),  # bf16 head scales
        lambda: fused_proj_down(x, x, p, p, s, s, s, _bf(gen, 2, 32), bits=8),  # bits mismatch
    ]
    for i, fn in enumerate(bad):
        with pytest.raises(ValueError):
            fn()
            pytest.fail(f"case {i} did not raise")


def _pages(gen, L, P, nKV, ps, dh, quant):
    """A random page pool: int8 pages with bf16 scales, or bf16 pages."""
    shape = (L, P, nKV, ps, dh)
    if quant:
        ks = (torch.rand(shape[:-1], device="cuda", generator=gen) * 0.02).bfloat16()
        vs = (torch.rand(shape[:-1], device="cuda", generator=gen) * 0.02).bfloat16()
        return _i8(gen, *shape), ks, _i8(gen, *shape), vs
    return _bf(gen, *shape), None, _bf(gen, *shape), None


def _table(gen, B, n_pg, P, garbage_rows=()):
    """Permuted page ids 1..P-1; the listed rows point at the garbage page 0."""
    ids = torch.randperm(P - 1, device="cuda", generator=gen)[: B * n_pg] + 1
    pt = ids.reshape(B, n_pg).to(torch.int32)
    for b in garbage_rows:
        pt[b] = 0
    return pt.contiguous()


@pytest.mark.parametrize(
    "B,nH,nKV,dh,ps,n_pg,quant",
    [(4, 8, 8, 128, 256, 3, True), (3, 8, 4, 128, 64, 8, True), (2, 16, 2, 128, 16, 20, False),
     (2, 4, 4, 256, 128, 2, True), (3, 4, 4, 256, 256, 2, False), (4, 4, 4, 64, 64, 5, True),
     (3, 4, 2, 64, 4, 70, False), (2, 12, 1, 128, 16, 20, True), (3, 16, 1, 128, 4, 70, False),
     (4, 48, 1, 128, 64, 5, True), (2, 64, 1, 128, 16, 20, False),
     (3, 80, 1, 64, 12, 25, True), (2, 96, 1, 128, 16, 20, False)],
)
def test_k9_matches_plain(gen, B, nH, nKV, dh, ps, n_pg, quant):
    L, S = 2, ps * n_pg
    P = B * n_pg + 3
    pk, pks, pv, pvs = _pages(gen, L, P, nKV, ps, dh, quant)
    pt = _table(gen, B, n_pg, P, garbage_rows=(B - 1,))
    q = _bf(gen, B, nH, dh)
    pos = torch.tensor([S - 1, ps + 1, 0, 100][:B], dtype=torch.int32, device="cuda")
    pos[B - 1] = min(ps + 5, S - 1)  # the garbage-page row reads page 0 throughout
    sm = dh ** -0.5
    before = flash_decode_paged.launches
    got = flash_decode_paged(q, pk, pks, pv, pvs, 1, pos, pt, sm)
    assert flash_decode_paged.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert _rel(got, flash_decode_paged_plain(q, pk, pks, pv, pvs, 1, pos, pt, sm)) < 2e-2


def test_k9_equals_k4_on_the_same_bytes(gen):
    """Pages laid out as the dense slab (identity table): K9 reads what K4 reads."""
    B, nKV, dh, ps, n_pg = 2, 4, 128, 64, 4
    S = ps * n_pg
    k, v = _i8(gen, 1, B, nKV, S, dh), _i8(gen, 1, B, nKV, S, dh)
    ks = (torch.rand(1, B, nKV, S, device="cuda", generator=gen) * 0.02).bfloat16()
    vs = (torch.rand(1, B, nKV, S, device="cuda", generator=gen) * 0.02).bfloat16()

    def to_pages(t):  # [1, B, nKV, S, ...] -> [1, B * n_pg, nKV, ps, ...]
        t = t.reshape((1, B, nKV, n_pg, ps) + tuple(t.shape[4:])).transpose(2, 3)
        return t.reshape((1, B * n_pg, nKV, ps) + tuple(t.shape[5:])).contiguous()

    pt = torch.arange(B * n_pg, device="cuda", dtype=torch.int32).reshape(B, n_pg)
    q = _bf(gen, B, nKV, dh)
    pos = torch.tensor([S - 1, 77], dtype=torch.int32, device="cuda")
    a = flash_decode_stacked(q, k, ks, v, vs, 0, pos, 0.09)
    b = flash_decode_paged(q, to_pages(k), to_pages(ks), to_pages(v), to_pages(vs), 0, pos, pt, 0.09)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("C", [8, 128])
@pytest.mark.parametrize(
    "B,nH,nKV,dh,ps,n_pg,quant",
    [(3, 8, 8, 128, 256, 3, True), (2, 8, 4, 128, 128, 4, False), (2, 4, 2, 128, 256, 2, True),
     (2, 4, 4, 256, 256, 2, True), (2, 2, 2, 256, 128, 3, False),
     (2, 8, 4, 128, 4, 40, False), (2, 4, 2, 256, 12, 20, False), (2, 4, 4, 128, 5, 50, False)],
)
def test_k10_matches_plain(gen, C, B, nH, nKV, dh, ps, n_pg, quant):
    L, S = 2, ps * n_pg
    P = B * n_pg + 2
    pk, pks, pv, pvs = _pages(gen, L, P, nKV, ps, dh, quant)
    pt = _table(gen, B, n_pg, P, garbage_rows=(B - 1,) if B > 2 else ())
    q = _bf(gen, B, C, nH, dh)
    starts = [0, S - C, ps - C // 2][:B]  # the third straddles a page boundary
    pos = torch.tensor(starts, dtype=torch.int32, device="cuda")
    sm = dh ** -0.5
    before = flash_chunk_paged.launches
    got = flash_chunk_paged(q, pk, pks, pv, pvs, 1, pos, pt, sm)
    assert flash_chunk_paged.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert _rel(got, flash_chunk_paged_plain(q, pk, pks, pv, pvs, 1, pos, pt, sm)) < 2e-2


def test_k10_reads_stop_at_the_chunk(gen):
    """Keys past the chunk's last query are never read: poisoning them
    changes nothing."""
    B, nKV, dh, ps, C = 2, 2, 128, 128, 8
    pk, _, pv, _ = _pages(gen, 1, 5, nKV, ps, dh, False)
    pt = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32, device="cuda")
    q = _bf(gen, B, C, nKV, dh)
    pos = torch.tensor([16, 100], dtype=torch.int32, device="cuda")
    clean = flash_chunk_paged(q, pk, None, pv, None, 0, pos, pt, 0.09)
    for b, s in enumerate(pos.tolist()):
        pk[0, pt[b, 0], :, s + C:] = 1e4
        pv[0, pt[b, 0], :, s + C:] = float("nan")
        pk[0, pt[b, 1]] = 1e4
        pv[0, pt[b, 1]] = float("nan")
    again = flash_chunk_paged(q, pk, None, pv, None, 0, pos, pt, 0.09)
    torch.cuda.synchronize()
    assert torch.equal(clean, again)


def test_paged_kernels_raise_on_what_they_do_not_take(gen):
    pk, pks, pv, pvs = _pages(gen, 1, 4, 2, 64, 128, True)
    pt = torch.ones(1, 2, dtype=torch.int32, device="cuda")
    pos = torch.zeros(1, dtype=torch.int32, device="cuda")
    q, qc = _bf(gen, 1, 2, 128), _bf(gen, 1, 8, 2, 128)
    bad = [
        lambda: flash_decode_paged(q.float(), pk, pks, pv, pvs, 0, pos, pt, 0.1),  # fp32 q
        lambda: flash_decode_paged(q, pk, pks, pv, None, 0, pos, pt, 0.1),  # one scale slab
        lambda: flash_decode_paged(q, pk, pks, pv, pvs, 0, pos, pt.long(), 0.1),  # int64 table
        lambda: flash_decode_paged(q, pk, pks, pv, pvs, 1, pos, pt, 0.1),  # layer out of range
        lambda: flash_decode_paged(_bf(gen, 1, 2, 96), pk[..., :96].contiguous(), pks,
                                   pv[..., :96].contiguous(), pvs, 0, pos, pt, 0.1),  # dh 96
        lambda: flash_chunk_paged(qc.transpose(1, 2), pk, pks, pv, pvs, 0, pos, pt, 0.1),
        lambda: flash_chunk_paged(qc, pk, pks, pv, pvs, 0, pos.long(), pt, 0.1),  # int64 pos
        lambda: flash_chunk_paged(qc, pk.float(), pks, pv.float(), pvs, 0, pos, pt, 0.1),
        lambda: flash_chunk_paged(qc, pk, pks, pv, pvs, 0, pos.cpu(), pt, 0.1),  # devices
    ]
    for i, fn in enumerate(bad):
        with pytest.raises(ValueError):
            fn()
            pytest.fail(f"case {i} did not raise")


@pytest.mark.parametrize(
    "B,S,nH,nKV,dh,lens",
    [(2, 300, 8, 8, 128, [300, 123]), (2, 200, 8, 2, 128, [200, 1]),
     (1, 130, 4, 4, 256, [130]), (3, 129, 8, 2, 256, [5, 129, 64]), (1, 64, 2, 2, 128, [64]),
     (1, 129, 4, 4, 128, [129]), (1, 65, 4, 4, 256, [65]), (2, 300, 16, 2, 128, [300, 1]),
     (2, 300, 8, 4, 256, [300, 171]), (2, 300, 16, 2, 256, [1, 300]),
     (2, 300, 8, 8, 64, [300, 123]), (1, 129, 4, 4, 64, [129]), (2, 200, 16, 2, 64, [200, 1]),
     (3, 256, 8, 1, 64, [5, 256, 128])],
)
def test_k5_matches_plain(gen, B, S, nH, nKV, dh, lens):
    """Ragged lengths, S not a multiple of the key tile (128 keys at dh 64
    and 128, 64 at dh 256) or one past it, lengths of 1, MHA and GQA up to 8 query
    heads a KV head: every row, padded ones included, equals the plain
    masked prefill."""
    q, k, v = _bf(gen, B, S, nH, dh), _bf(gen, B, S, nKV, dh), _bf(gen, B, S, nKV, dh)
    ln = torch.tensor(lens, dtype=torch.int32, device="cuda")
    sm = dh ** -0.5
    before = prefill_attention_flash.launches
    got = prefill_attention_flash(q, k, v, ln, sm)
    assert prefill_attention_flash.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert _rel(got, prefill_attention_flash_plain(q, k, v, ln, sm)) < 2e-2


@pytest.mark.parametrize("nH,nKV,dh,lens", [(4, 4, 128, [150, 70]), (8, 2, 128, [131, 200]),
                                           (4, 4, 256, [100, 199]), (8, 1, 256, [1, 75]),
                                           (4, 4, 64, [150, 70]), (8, 2, 64, [1, 199])])
def test_k5_reads_stop_at_the_length(gen, nH, nKV, dh, lens):
    """Keys at or past a row's length are never used: poisoning them (K with
    1e4, V with NaN) changes nothing, also where the length ends inside a
    key tile that TMA loads whole (the rows below S past the length are real
    memory there)."""
    B, S = 2, 200
    q, k, v = _bf(gen, B, S, nH, dh), _bf(gen, B, S, nKV, dh), _bf(gen, B, S, nKV, dh)
    ln = torch.tensor(lens, dtype=torch.int32, device="cuda")
    clean = prefill_attention_flash(q, k, v, ln, 0.09)
    for b, n in enumerate(ln.tolist()):
        k[b, n:] = 1e4
        v[b, n:] = float("nan")
    again = prefill_attention_flash(q, k, v, ln, 0.09)
    torch.cuda.synchronize()
    assert torch.equal(clean, again)


def test_k5_is_deterministic(gen):
    """No atomics, no split over keys: two calls give equal bytes (the greedy
    checks rely on it)."""
    B, S, nH, nKV, dh = 2, 1000, 16, 4, 128
    q, k, v = _bf(gen, B, S, nH, dh), _bf(gen, B, S, nKV, dh), _bf(gen, B, S, nKV, dh)
    ln = torch.tensor([1000, 613], dtype=torch.int32, device="cuda")
    a = prefill_attention_flash(q, k, v, ln, dh ** -0.5)
    b = prefill_attention_flash(q, k, v, ln, dh ** -0.5)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("B,S,nH,nKV,dh,lens", [
    (1, 200, 2, 2, 64, [200]), (2, 300, 4, 2, 128, [300, 77]), (2, 130, 2, 2, 256, [130, 1]),
    (3, 70, 6, 3, 64, [70, 5, 64]), (1, 129, 8, 1, 128, [129]), (2, 65, 4, 4, 256, [33, 65]),
    (2, 333, 16, 4, 64, [333, 150]), (2, 517, 8, 2, 128, [517, 260]),
    (2, 301, 16, 2, 256, [301, 17]), (3, 1000, 8, 1, 64, [1000, 999, 129])])
def test_k5_f32_and_its_backward_match_plain(gen, B, S, nH, nKV, dh, lens):
    """K5's fp32 forward (out and lse) and its dK/dV and dQ kernels (3xTF32)
    against the plain versions: the gradient of sum(out * ct) by autograd of
    the plain forward, at every dh, lengths of 1 and ragged length batches,
    S off every tile (the forward's 64 rows, 32 at dh 256; the backward's
    128 fixed and 32 streamed rows, 64 and 16 at dh 256) and 1, 2, 4 and 8
    query heads a KV head; the autograd route gives the kernels' bytes and
    counts one launch of each. Tolerance 1e-4 of max |plain| (fp32 sums in
    another order; 3xTF32 products)."""
    q, k, v = (torch.randn(B, S, n, dh, device="cuda", generator=gen) for n in (nH, nKV, nKV))
    ct = torch.randn(B, S, nH, dh, device="cuda", generator=gen)
    ln = torch.tensor(lens, dtype=torch.int32, device="cuda")
    sm = dh ** -0.5
    out, lse = prefill_flash_forward(q, k, v, ln, sm)
    assert _rel(out, prefill_attention_flash_plain(q, k, v, ln, sm)) < 1e-4
    assert _rel(lse, prefill_flash_lse_plain(q, k, ln, sm)) < 1e-4
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad((prefill_attention_flash_plain(*leaves, ln, sm) * ct).sum(), leaves)
    delta = (ct * out).sum(-1).transpose(1, 2).contiguous()
    dk, dv = prefill_flash_bwd_dkv(q, k, v, ct, lse, delta, ln, sm)
    dq = prefill_flash_bwd_dq(q, k, v, ct, lse, delta, ln, sm)
    for got, ref in zip((dq, dk, dv), want):
        assert _rel(got, ref) < 1e-4
    before = (prefill_attention_flash.launches_f32, prefill_flash_bwd_dkv.launches,
              prefill_flash_bwd_dq.launches)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    (prefill_attention_flash(*leaves, ln, sm) * ct).sum().backward()
    torch.cuda.synchronize()
    assert (prefill_attention_flash.launches_f32, prefill_flash_bwd_dkv.launches,
            prefill_flash_bwd_dq.launches) == tuple(n + 1 for n in before)
    for t, ref in zip(leaves, (dq, dk, dv)):
        assert torch.equal(t.grad, ref)


def test_k5_f32_backward_is_deterministic(gen):
    B, S, nH, nKV, dh = 2, 300, 8, 2, 128
    q, k, v = (torch.randn(B, S, n, dh, device="cuda", generator=gen) for n in (nH, nKV, nKV))
    ct = torch.randn(B, S, nH, dh, device="cuda", generator=gen)
    ln = torch.tensor([300, 151], dtype=torch.int32, device="cuda")
    runs = []
    for _ in range(2):
        out, lse = prefill_flash_forward(q, k, v, ln, 0.09)
        delta = (ct * out).sum(-1).transpose(1, 2).contiguous()
        runs.append((out, lse, *prefill_flash_bwd_dkv(q, k, v, ct, lse, delta, ln, 0.09),
                     prefill_flash_bwd_dq(q, k, v, ct, lse, delta, ln, 0.09)))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_k5_refuses_a_bf16_gradient_on_the_card(gen):
    q = torch.randn(1, 64, 2, 64, device="cuda", generator=gen).bfloat16().requires_grad_()
    ln = torch.tensor([64], dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="fp32 only"):
        prefill_attention_flash(q, q, q, ln, 0.1)


def _packed(gen, shape, kind):
    """Random K/V payloads of a packed cache ``kind`` over ``shape`` =
    (L, X, nKV, n, dh), with bf16 scales: (k, ks, v, vs)."""
    pshape = shape[:3] + (shape[3] // 2, shape[4])
    ks = (torch.rand(shape[:-1], device="cuda", generator=gen) * 0.2).bfloat16()
    vs = (torch.rand(shape[:-1], device="cuda", generator=gen) * 0.2).bfloat16()
    k = _i8(gen, *(pshape if kind == "int4" else shape))
    return k, ks, _i8(gen, *pshape), vs


@pytest.mark.parametrize("kind", ["int4", "int8k_int4v"])
@pytest.mark.parametrize("B,nH,nKV,dh,S", [(4, 8, 8, 128, 300), (2, 8, 4, 128, 200),
                                           (2, 4, 4, 256, 70), (4, 4, 4, 64, 300),
                                           (2, 16, 1, 128, 200), (4, 48, 1, 128, 300)])
def test_k4_packed_matches_plain(gen, kind, B, nH, nKV, dh, S):
    L = 2
    k, ks, v, vs = _packed(gen, (L, B, nKV, S, dh), kind)
    q = _bf(gen, B, nH, dh)
    pos = torch.tensor([0, S - 1, 63, 64][:B], dtype=torch.int32, device="cuda")
    sm = dh ** -0.5
    before, before_p = flash_decode_stacked.launches, flash_decode_stacked.launches_packed
    got = flash_decode_stacked(q, k, ks, v, vs, 1, pos, sm)
    assert flash_decode_stacked.launches == before + 1
    assert flash_decode_stacked.launches_packed == before_p + 1
    assert _rel(got, flash_decode_stacked_plain(q, k, ks, v, vs, 1, pos, sm)) < 2e-2


@pytest.mark.parametrize("kind", ["int4", "int8k_int4v"])
@pytest.mark.parametrize("B,nH,nKV,dh,ps,n_pg", [(4, 8, 8, 128, 256, 3), (3, 8, 4, 128, 16, 20),
                                                 (2, 4, 4, 256, 2, 40), (4, 4, 4, 64, 64, 5),
                                                 (3, 12, 1, 128, 4, 70)])
def test_k9_packed_matches_plain(gen, kind, B, nH, nKV, dh, ps, n_pg):
    """Packed pages of any even size, down to 2."""
    L, S = 2, ps * n_pg
    P = B * n_pg + 3
    pk, pks, pv, pvs = _packed(gen, (L, P, nKV, ps, dh), kind)
    pt = _table(gen, B, n_pg, P, garbage_rows=(B - 1,))
    q = _bf(gen, B, nH, dh)
    pos = torch.tensor([S - 1, ps + 1, 0, 100][:B], dtype=torch.int32, device="cuda")
    sm = dh ** -0.5
    before_p = flash_decode_paged.launches_packed
    got = flash_decode_paged(q, pk, pks, pv, pvs, 1, pos, pt, sm)
    assert flash_decode_paged.launches_packed == before_p + 1
    assert _rel(got, flash_decode_paged_plain(q, pk, pks, pv, pvs, 1, pos, pt, sm)) < 2e-2


@pytest.mark.parametrize("kind", ["int4", "int8k_int4v"])
@pytest.mark.parametrize("C", [8, 128])
@pytest.mark.parametrize("B,nH,nKV,dh,ps,n_pg", [(3, 8, 8, 128, 256, 3), (2, 4, 2, 128, 128, 4),
                                                 (2, 4, 4, 256, 256, 2)])
def test_k10_packed_matches_plain(gen, kind, C, B, nH, nKV, dh, ps, n_pg):
    L, S = 2, ps * n_pg
    P = B * n_pg + 2
    pk, pks, pv, pvs = _packed(gen, (L, P, nKV, ps, dh), kind)
    pt = _table(gen, B, n_pg, P)
    q = _bf(gen, B, C, nH, dh)
    starts = [0, S - C, ps - C // 2][:B]  # the third straddles a page boundary
    pos = torch.tensor(starts, dtype=torch.int32, device="cuda")
    sm = dh ** -0.5
    before_p = flash_chunk_paged.launches_packed
    got = flash_chunk_paged(q, pk, pks, pv, pvs, 1, pos, pt, sm)
    assert flash_chunk_paged.launches_packed == before_p + 1
    assert _rel(got, flash_chunk_paged_plain(q, pk, pks, pv, pvs, 1, pos, pt, sm)) < 2e-2


def test_packed_nibble_order(gen):
    """Every V byte holds +1 at the even position (low nibble) and -1 at the
    odd one; K is zero, so position 0 alone reads +1 and positions 0-1 read
    their mean, 0. A swapped order reads -1."""
    nKV, dh, ps = 2, 128, 8
    ones = torch.ones(1, 2, nKV, ps, dtype=torch.bfloat16, device="cuda")
    v4 = torch.full((1, 2, nKV, ps // 2, dh), (-1 << 4) | 1, dtype=torch.int8, device="cuda")
    k4 = torch.zeros_like(v4)
    pt = torch.ones(2, 1, dtype=torch.int32, device="cuda")
    pos = torch.tensor([0, 1], dtype=torch.int32, device="cuda")
    want = torch.tensor([1.0, 0.0]).reshape(2, 1, 1)
    q = _bf(gen, 2, nKV, dh)
    for got in (flash_decode_stacked(q, k4, ones, v4, ones, 0, pos, 0.1),
                flash_decode_paged(q, k4, ones, v4, ones, 0, pos, pt, 0.1)):
        torch.cuda.synchronize()
        assert torch.equal(got.float().cpu(), want.expand(2, nKV, dh))
    qc = _bf(gen, 2, 2, nKV, dh)
    got = flash_chunk_paged(qc, k4, ones, v4, ones, 0, torch.zeros(2, dtype=torch.int32,
                                                                   device="cuda"), pt, 0.1)
    torch.cuda.synchronize()
    assert torch.equal(got.float().cpu(), want.reshape(1, 2, 1, 1).expand(2, 2, nKV, dh))


def _beam_cache(gen, kind, shape):
    """(k, ks, v, vs) of a ``kind`` cache over ``shape`` = (L, BB, nKV, S, dh)."""
    if kind == "bf16":
        return _bf(gen, *shape), None, _bf(gen, *shape), None
    if kind == "int8":
        ks = (torch.rand(shape[:-1], device="cuda", generator=gen) * 0.02).bfloat16()
        vs = (torch.rand(shape[:-1], device="cuda", generator=gen) * 0.02).bfloat16()
        return _i8(gen, *shape), ks, _i8(gen, *shape), vs
    return _packed(gen, shape, kind)


def _gathered(slab, scales, layer, indir, bw):
    """Layer ``layer`` of a K/V slab (``scales`` given) or of a scale slab
    (None), resolved through the beam indirection into a dense [1, BB, ...]
    copy, packed again where it was packed."""
    t = slab[layer]
    packed = scales is not None and is_packed(slab, scales)
    g = gather_beam_rows(unpack_seq_pairs(t) if packed else t, indir, bw)
    return (pack_seq_pairs(g) if packed else g)[None].contiguous()


@pytest.mark.parametrize("kind", ["bf16", "int8", "int4", "int8k_int4v"])
@pytest.mark.parametrize("B,bw,nH,nKV,dh,S", [(2, 4, 8, 8, 128, 300), (1, 3, 8, 2, 128, 130),
                                              (2, 2, 4, 4, 256, 64), (2, 4, 4, 4, 64, 300),
                                              (1, 4, 16, 1, 128, 260), (2, 2, 48, 1, 128, 130),
                                              (1, 2, 64, 1, 64, 130), (1, 2, 80, 1, 64, 130)])
def test_k11_matches_plain_and_k4_over_a_gathered_copy(gen, kind, B, bw, nH, nKV, dh, S):
    """MHA and GQA, every cache format: K11 against its plain version, and
    bit for bit against K4 over the physically resolved cache (one body, the
    same values read in the same order)."""
    L, BB = 2, B * bw
    k, ks, v, vs = _beam_cache(gen, kind, (L, BB, nKV, S, dh))
    q = _bf(gen, BB, nH, dh)
    pos = torch.randint(0, S, (BB,), generator=gen, device="cuda", dtype=torch.int32)
    pos[0] = S - 1
    indir = torch.randint(0, bw, (BB, S), generator=gen, device="cuda", dtype=torch.int32)
    sm = dh ** -0.5
    before, before_p = flash_decode_beam_stacked.launches, flash_decode_beam_stacked.launches_packed
    got = flash_decode_beam_stacked(q, k, ks, v, vs, 1, pos, indir, bw, sm)
    assert flash_decode_beam_stacked.launches == before + 1
    assert flash_decode_beam_stacked.launches_packed == before_p + (kind in ("int4", "int8k_int4v"))
    assert _rel(got, flash_decode_beam_plain(q, k, ks, v, vs, 1, pos, indir, bw, sm)) < 2e-2
    gk, gv = _gathered(k, ks, 1, indir, bw), _gathered(v, vs, 1, indir, bw)
    gks = None if ks is None else _gathered(ks, None, 1, indir, bw)
    gvs = None if vs is None else _gathered(vs, None, 1, indir, bw)
    want = flash_decode_stacked(q, gk, gks, gv, gvs, 0, pos, sm)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_k11_reads_stop_at_position(gen):
    """Slots past a row's position may hold anything (NaN): K11 never reads
    them, whichever row the indirection names there."""
    bw, nH, dh, S = 2, 4, 128, 256
    k, v, q = _bf(gen, 1, bw, nH, S, dh), _bf(gen, 1, bw, nH, S, dh), _bf(gen, bw, nH, dh)
    pos = torch.tensor([100, 60], dtype=torch.int32, device="cuda")
    indir = torch.randint(0, bw, (bw, S), generator=gen, device="cuda", dtype=torch.int32)
    clean = flash_decode_beam_stacked(q, k, None, v, None, 0, pos, indir, bw, 0.088)
    k[..., 101:, :] = 1e4
    v[..., 101:, :] = float("nan")
    again = flash_decode_beam_stacked(q, k, None, v, None, 0, pos, indir, bw, 0.088)
    torch.cuda.synchronize()
    assert torch.equal(clean, again)


def test_k11_raises_on_what_it_does_not_take(gen):
    bw, nH, dh, S = 2, 4, 128, 64
    k, v, q = _bf(gen, 1, 4, nH, S, dh), _bf(gen, 1, 4, nH, S, dh), _bf(gen, 4, nH, dh)
    pos = torch.zeros(4, dtype=torch.int32, device="cuda")
    indir = torch.zeros(4, S, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):
        flash_decode_beam_stacked(q, k, None, v, None, 0, pos, indir.long(), bw, 0.1)
    with pytest.raises(ValueError):
        flash_decode_beam_stacked(q, k, None, v, None, 0, pos, indir, 3, 0.1)  # 4 rows, bw 3
    with pytest.raises(ValueError):
        flash_decode_beam_stacked(q, k, None, v, None, 0, pos, indir[:, :32], bw, 0.1)
    with pytest.raises(ValueError):
        flash_decode_beam_stacked(q.float(), k, None, v, None, 0, pos, indir, bw, 0.1)


SPLIT_KINDS = ["bf16", "int8", "int4", "int8k_int4v"]


@pytest.mark.parametrize("kind", SPLIT_KINDS)
@pytest.mark.parametrize("nH,nKV,dh", [(4, 4, 64), (12, 1, 128), (16, 2, 128), (48, 1, 128),
                                       (64, 1, 128), (80, 1, 64), (130, 2, 128),
                                       (8, 4, 256)])
def test_decode_kernels_across_split_boundaries(gen, kind, nH, nKV, dh):
    """Rows ending just before, on and after a split boundary (255, 256, 257:
    the splits are 128 or 256 positions, so 256 is a boundary of every split
    size) and a row of one position: K4, K9 (pages of 16)
    and K11 against their plain versions; K9 bit for bit K4 on the same
    bytes, K11 bit for bit K4 over the gathered copy."""
    B, S, ps, bw = 4, 320, 16, 2
    k, ks, v, vs = _beam_cache(gen, kind, (1, B, nKV, S, dh))
    q = _bf(gen, B, nH, dh)
    pos = torch.tensor([255, 256, 257, 0], dtype=torch.int32, device="cuda")
    sm = dh ** -0.5
    got = flash_decode_stacked(q, k, ks, v, vs, 0, pos, sm)
    assert _rel(got, flash_decode_stacked_plain(q, k, ks, v, vs, 0, pos, sm)) < 2e-2

    n_pg = S // ps  # the dense slab as pages, identity table
    def to_pages(t, packed=False):
        n = ps // 2 if packed else ps
        t = t.reshape((1, B, nKV, n_pg, n) + tuple(t.shape[4:])).transpose(2, 3)
        return t.reshape((1, B * n_pg, nKV, n) + tuple(t.shape[5:])).contiguous()

    pt = torch.arange(B * n_pg, device="cuda", dtype=torch.int32).reshape(B, n_pg)
    pk, pv = to_pages(k, is_packed(k, ks)), to_pages(v, is_packed(v, vs))
    pks, pvs = (None, None) if ks is None else (to_pages(ks), to_pages(vs))
    paged = flash_decode_paged(q, pk, pks, pv, pvs, 0, pos, pt, sm)
    torch.cuda.synchronize()
    assert torch.equal(paged, got)

    indir = torch.randint(0, bw, (B, S), generator=gen, device="cuda", dtype=torch.int32)
    beam = flash_decode_beam_stacked(q, k, ks, v, vs, 0, pos, indir, bw, sm)
    assert _rel(beam, flash_decode_beam_plain(q, k, ks, v, vs, 0, pos, indir, bw, sm)) < 2e-2
    gk, gv = _gathered(k, ks, 0, indir, bw), _gathered(v, vs, 0, indir, bw)
    gks = None if ks is None else _gathered(ks, None, 0, indir, bw)
    gvs = None if vs is None else _gathered(vs, None, 0, indir, bw)
    torch.cuda.synchronize()
    assert torch.equal(beam, flash_decode_stacked(q, gk, gks, gv, gvs, 0, pos, sm))


@pytest.mark.parametrize("kind", SPLIT_KINDS)
@pytest.mark.parametrize("nH,nKV,dh", [(8, 8, 128), (16, 1, 64), (48, 1, 128), (80, 1, 64)])
def test_decode_rows_are_batch_invariant_and_calls_repeat(gen, kind, nH, nKV, dh):
    """Split-S fixed in positions: a row's output at B = 1 is the same row
    of a B = 8 call, bit for bit (K4 and K9), and two calls give equal
    bytes (the combine adds the splits in a fixed order, no atomics)."""
    B, S, ps = 8, 1100, 4
    k, ks, v, vs = _beam_cache(gen, kind, (1, B, nKV, S, dh))
    q = _bf(gen, B, nH, dh)
    pos = torch.tensor([1099, 0, 300, 511, 512, 700, 129, 1000], dtype=torch.int32,
                       device="cuda")
    sm = dh ** -0.5
    full = flash_decode_stacked(q, k, ks, v, vs, 0, pos, sm)
    again = flash_decode_stacked(q, k, ks, v, vs, 0, pos, sm)
    torch.cuda.synchronize()
    assert torch.equal(full, again)
    for b in (0, 3, 6):
        one = flash_decode_stacked(q[b:b + 1].contiguous(), k[:, b:b + 1].contiguous(),
                                   None if ks is None else ks[:, b:b + 1].contiguous(),
                                   v[:, b:b + 1].contiguous(),
                                   None if vs is None else vs[:, b:b + 1].contiguous(), 0,
                                   pos[b:b + 1].contiguous(), sm)
        torch.cuda.synchronize()
        assert torch.equal(one[0], full[b]), b
    # K9: a slot's row alone with its own pages, and two calls
    P = B * (S // ps) + 1
    pk, pks, pv, pvs = _beam_cache(gen, kind, (1, P, nKV, ps, dh))
    pt = _table(gen, B, S // ps, P)
    full = flash_decode_paged(q, pk, pks, pv, pvs, 0, pos, pt, sm)
    again = flash_decode_paged(q, pk, pks, pv, pvs, 0, pos, pt, sm)
    torch.cuda.synchronize()
    assert torch.equal(full, again)
    for b in (0, 3, 6):
        one = flash_decode_paged(q[b:b + 1].contiguous(), pk, pks, pv, pvs, 0,
                                 pos[b:b + 1].contiguous(), pt[b:b + 1].contiguous(), sm)
        torch.cuda.synchronize()
        assert torch.equal(one[0], full[b]), b


@pytest.mark.parametrize("name", list(chip_smoke.ROUTE_CONFIGS))
def test_served_attention_shapes_match_the_cpu(gen, name):
    """dh 64 (K5 and K4 at dh 64), g = 16 (K5 and K4 at 16 query heads a KV
    head), bf16 pages of 4 (K10 on raw rows, K9) and dh 32 (no kernel takes
    it, nor does the JAX package's: the plain routes) served on the card
    give the CPU's greedy tokens (a parting only at a near-tie of the CPU's
    logits, both then teacher-forced on); each route is the one the config
    must take (chip_smoke.py phase 3 runs the same check;
    tests/test_torch_attention_routes.py holds the configs to the JAX
    engine)."""
    import fastertransformer4codefuse_tpu_torch as pkg

    err, _, _ = chip_smoke.serve_route_config(torch, pkg, name)
    assert err is None, err


def _masked(lens, S):
    return torch.arange(S, device="cuda")[None, :] >= torch.tensor(lens, device="cuda")[:, None]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize(
    "B,S,nH,dh,w,lens",
    [(2, 300, 4, 64, 50, [300, 123]), (2, 300, 4, 128, 50, [300, 123]),
     (3, 129, 2, 64, 0, [129, 1, 64]), (1, 1000, 2, 64, 256, [1000]),
     (2, 77, 3, 128, 200, [77, 40]), (2, 640, 2, 64, 100, [640, 130]),
     # the band's edges at the 128-key tiles: w = 0, w = 130 (a block's band
     # starts and ends inside a tile), w = S and wider, lengths off the tile
     # boundaries, an empty row
     (2, 300, 2, 64, 0, [300, 129]), (2, 300, 2, 128, 130, [300, 257]),
     (2, 300, 2, 64, 300, [300, 1]), (2, 300, 2, 128, 400, [257, 0]),
     (2, 1000, 2, 64, 130, [1000, 0]), (1, 4096, 12, 64, 256, [2900])],
)
def test_k12_matches_plain(gen, causal, B, S, nH, dh, w, lens):
    """Ragged lengths, S and w not multiples of the tiles, w = 0 and w wider
    than S, dh 64 and 128, empty rows, Longformer-base's heads: every row,
    padded ones (0) included, equals the plain banded attention."""
    q, k, v = _bf(gen, B, S, nH, dh, std=0.5), _bf(gen, B, S, nH, dh), _bf(gen, B, S, nH, dh)
    m = _masked(lens, S)
    before = (sliding_window_attention.launches, sliding_window_attention.launches_causal)
    got = sliding_window_attention(q, k, v, w, m, causal=causal)
    assert (sliding_window_attention.launches,
            sliding_window_attention.launches_causal) == (before[0] + 1, before[1] + int(causal))
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    ref = sliding_window_attention_plain(q, k, v, w, m, causal=causal)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got.float()).all())
    # each (query, head) row held to its own magnitude
    assert chip_smoke.row_rel_err(torch, got, ref)[1] < 2e-2
    for b, n in enumerate(lens):
        assert not got[b, n:].any()


def test_k12_reads_stay_in_the_band(gen):
    """Keys outside every row's band, and keys at or past the length, are
    never read: poisoning them changes nothing."""
    B, S, nH, dh, w = 1, 1024, 2, 64, 100
    q, k, v = _bf(gen, B, S, nH, dh), _bf(gen, B, S, nH, dh), _bf(gen, B, S, nH, dh)
    m = _masked([700], S)
    clean = sliding_window_attention(q, k, v, w, m)[:, :300].clone()
    k[:, 512:] = 1e4  # past the band of the query tiles below 384 (keys <= 483)
    v[:, 512:] = float("nan")
    again = sliding_window_attention(q, k, v, w, m)[:, :300]
    torch.cuda.synchronize()
    assert torch.equal(clean, again)
    k, v = _bf(gen, B, S, nH, dh), _bf(gen, B, S, nH, dh)  # fresh, then past the length
    clean = sliding_window_attention(q, k, v, w, m)
    k[:, 700:] = 1e4
    v[:, 700:] = float("nan")
    again = sliding_window_attention(q, k, v, w, m)
    torch.cuda.synchronize()
    assert torch.equal(clean, again)


def test_k12_is_deterministic(gen):
    """No atomics and no split over keys: two calls give equal bytes."""
    B, S, nH, dh, w = 2, 1000, 4, 64, 130
    q, k, v = _bf(gen, B, S, nH, dh, std=0.5), _bf(gen, B, S, nH, dh), _bf(gen, B, S, nH, dh)
    m = _masked([1000, 611], S)
    for causal in (False, True):
        a = sliding_window_attention(q, k, v, w, m, causal=causal)
        b = sliding_window_attention(q, k, v, w, m, causal=causal)
        torch.cuda.synchronize()
        assert torch.equal(a, b)


def test_k12_raises_on_what_it_does_not_take(gen):
    q = _bf(gen, 2, 64, 2, 64)
    m = _masked([64, 30], 64)
    bad = [
        lambda: sliding_window_attention(q.float(), q, q, 8, m),
        lambda: sliding_window_attention(_bf(gen, 2, 64, 2, 32), _bf(gen, 2, 64, 2, 32),
                                         _bf(gen, 2, 64, 2, 32), 8, m),
        lambda: sliding_window_attention(q, q[:, :32], q, 8, m),
        lambda: sliding_window_attention(q, q, q, -1, m),
        lambda: sliding_window_attention(q, q, q, 8, m.int()),
        lambda: sliding_window_attention(q, q, q, 8, m[:, :32]),
        lambda: sliding_window_attention(q, q, q, 8, m.cpu()),
    ]
    for i, fn in enumerate(bad):
        with pytest.raises(ValueError):
            fn()
            pytest.fail(f"case {i} did not raise")


def _fmt_weight(gen, K, N, bits, G):
    """(payload, scales) of a random [K, N] weight: int8 or packed int4, fp32
    per-channel or (G > 0) group scales, bf16 for int4 and fp32 for int8."""
    p = _i8(gen, K // 2 if bits == 4 else K, N)
    if not G:
        return p, _scale(gen, N) * (16 if bits == 4 else 1)
    s = torch.rand(K // G, N, device="cuda", generator=gen) * 0.004 + 0.0005
    return p, (s * 16).bfloat16() if bits == 4 else s


FUSED_FORMATS = [(8, 0), (4, 0), (4, 32), (8, 32)]


# every format at decode (M <= 32) and prefill widths: int8 with group scales
# has a GEMM instance (W_I8G) too
K13_CASES = [(M, bits, G) for M in (1, 3, 5, 32, 33, 130) for bits, G in FUSED_FORMATS]


@pytest.mark.parametrize("M,bits,G", K13_CASES)
@pytest.mark.parametrize("act2", ["gelu-tanh", "gelu"])
def test_k13_matches_plain(gen, M, bits, G, act2):
    K, N1, N2 = 256, 144, 512  # N1 ends inside a 128-column tile
    x1, x2 = _bf(gen, M, K), _bf(gen, M, K)
    w1, s1 = _fmt_weight(gen, K, N1, bits, G)
    w2, s2 = _fmt_weight(gen, K, N2, bits, G)
    b1, b2 = _bf(gen, N1, std=0.1), (torch.randn(N2, device="cuda", generator=gen) * 0.1)
    args = (x1, x2, w1, w2, s1, s2, b1, b2, None, act2, bits, G)
    before = fused_qkv_up.launches
    y1, y2 = fused_qkv_up(*args)
    assert fused_qkv_up.launches == before + 1
    r1, r2 = fused_qkv_up_plain(*args)
    assert y1.shape == (M, N1) and y2.shape == (M, N2) and y1.dtype == y2.dtype == torch.bfloat16
    assert _rel(torch.cat([y1, y2], 1), torch.cat([r1, r2], 1)) < 1e-2


@pytest.mark.parametrize("M", [1, 2, 4, 8, 32, 130])
@pytest.mark.parametrize("bits,G", FUSED_FORMATS)
def test_k13_segments_equal_the_gemm_alone(gen, M, bits, G):
    """Each K13 segment runs K1's (K6's, K7's) arithmetic on its own: the
    same splits and tiles, so the same bits."""
    K, N1, N2 = 512, 384, 1024
    x1, x2 = _bf(gen, M, K), _bf(gen, M, K)
    w1, s1 = _fmt_weight(gen, K, N1, bits, G)
    w2, s2 = _fmt_weight(gen, K, N2, bits, G)
    b1, b2 = _bf(gen, N1, std=0.1), _bf(gen, N2, std=0.1)
    y1, y2 = fused_qkv_up(x1, x2, w1, w2, s1, s2, b1, b2, None, "gelu-tanh", bits, G)
    if bits == 8:
        a1 = quant_matmul(x1, w1, s1, b1, group_size=G)
        a2 = quant_matmul(x2, w2, s2, b2, "gelu-tanh", group_size=G)
    elif G:
        a1 = quant_matmul_w4_group(x1, w1, s1, G, b1)
        a2 = quant_matmul_w4_group(x2, w2, s2, G, b2, "gelu-tanh")
    else:
        a1, a2 = quant_matmul_w4(x1, w1, s1, b1), quant_matmul_w4(x2, w2, s2, b2, "gelu-tanh")
    torch.cuda.synchronize()
    assert torch.equal(y1, a1) and torch.equal(y2, a2)


@pytest.mark.parametrize("M", [1, 4, 9])
@pytest.mark.parametrize("bits,G", [(8, 128), (4, 128), (4, 32)])
def test_k2_k3_group_scales_match_plain(gen, M, bits, G):
    H, F = 256, 1024
    x_up, x_proj, res, h = _bf(gen, M, H), _bf(gen, M, H), _bf(gen, M, H), _bf(gen, M, F, std=0.5)
    (w_up, s_up), (w_proj, s_proj), (w_down, s_down) = (
        _fmt_weight(gen, k, n, bits, G) for k, n in ((H, F), (H, H), (F, H)))
    b_up, b_down = _bf(gen, F, std=0.1), _bf(gen, H, std=0.1)
    args3 = (x_proj, h, w_proj, w_down, s_proj, s_down, b_down, res, bits, G)
    assert _rel(fused_proj_down(*args3), fused_proj_down_plain(*args3)) < 1e-2
    for act in ("gelu-tanh", "gelu"):
        args = (x_up, x_proj, res, w_up, w_proj, w_down, s_up, s_proj, s_down, b_up, b_down, act,
                bits, G)
        assert _rel(fused_up_proj_down(*args), fused_up_proj_down_plain(*args)) < 2e-2


def test_fused_kernels_raise_on_what_they_do_not_take(gen):
    x = _bf(gen, 2, 64)
    p8, s8 = _fmt_weight(gen, 64, 32, 8, 0)
    g8 = _fmt_weight(gen, 64, 32, 8, 32)[1]
    p4, g4 = _fmt_weight(gen, 64, 32, 4, 32)
    bad = [
        lambda: fused_qkv_up(x, _bf(gen, 3, 64), p8, p8, s8, s8),  # x1 and x2 differ
        lambda: fused_qkv_up(x.float(), x.float(), p8, p8, s8, s8),  # fp32 activations
        lambda: fused_qkv_up(x, x, p8, p8, s8, s8, act2="tanh"),  # unknown activation
        lambda: fused_qkv_up(_bf(gen, 40, 64), _bf(gen, 40, 64), p8, p8, g8.bfloat16(),
                             g8.bfloat16(), group_size=32),  # bf16 group scales with int8
        lambda: fused_qkv_up(x, x, p4, p4, g4, g4.float(), bits=4,
                             group_size=32),  # the two segments' scales differ in dtype
        lambda: fused_proj_down(x, x, p8, p8, g8.bfloat16(), g8.bfloat16(), s8,
                                _bf(gen, 2, 32), group_size=32),  # bf16 scales with int8
        lambda: fused_proj_down(x, x, p4, p4, g4, g4, s8, _bf(gen, 2, 32), bits=4,
                                group_size=24),  # G does not divide K
    ]
    for i, fn in enumerate(bad):
        with pytest.raises(ValueError):
            fn()
            pytest.fail(f"case {i} did not raise")


@pytest.mark.parametrize("M", [1, 4, 9])
@pytest.mark.parametrize("bits,G", [(4, 32), (4, 64), (8, 32), (8, 64)])
def test_group_gemv_ragged_splits(gen, M, bits, G):
    """K7, K3 and K13 with groups of 32 and 64 where the splits, whole groups
    each, do not divide K (1152 = 18 groups of 64, 36 of 32): each matches
    its plain version, and K13's segments equal K7 alone bit for bit."""
    K, K2, N = 1152, 2560, 384
    x1, x2, h, res = _bf(gen, M, K), _bf(gen, M, K), _bf(gen, M, K2, std=0.5), _bf(gen, M, N)
    (w1, s1), (w2, s2), (wd, sd) = (_fmt_weight(gen, k, n, bits, G)
                                   for k, n in ((K, N), (K, N), (K2, N)))
    b1, b2 = _bf(gen, N, std=0.1), _bf(gen, N, std=0.1)
    args3 = (x1, h, w1, wd, s1, sd, b1, res, bits, G)
    assert _rel(fused_proj_down(*args3), fused_proj_down_plain(*args3)) < 1e-2
    args13 = (x1, x2, w1, w2, s1, s2, b1, b2, None, "gelu-tanh", bits, G)
    y1, y2 = fused_qkv_up(*args13)
    r1, r2 = fused_qkv_up_plain(*args13)
    assert _rel(torch.cat([y1, y2], 1), torch.cat([r1, r2], 1)) < 1e-2
    if bits == 4:
        a1 = quant_matmul_w4_group(x1, w1, s1, G, b1)
        a2 = quant_matmul_w4_group(x2, w2, s2, G, b2, "gelu-tanh")
        assert _rel(a1, quant_matmul_w4_group_plain(x1, w1, s1, G, b1)) < 1e-2
        torch.cuda.synchronize()
        assert torch.equal(y1, a1) and torch.equal(y2, a2)


# The GEMV's tensor-core body (2 <= M <= 32): every weight format, both
# joins (K3 over K, K13 over N) and the single GEMMs, on ranges that end
# inside a k16 step (per-channel K = 1160 and 2568: 8 rows past a multiple
# of 16) or hold whole groups of 32 that do not divide K evenly among the
# splits, and columns that end inside a 128-column tile.
ALL_FORMATS = [(8, 0), (4, 0), (4, 32), (8, 32)]
TC_WIDTHS = [2, 3, 8, 9, 16, 31, 32]


def _gemv_calls(gen, M, bits, G, x1=None, x2=None, h=None):
    """(kernel, plain) pairs of K3, K13 and the single GEMM of one format on
    ragged shapes; x1, x2 [M, K] and h [M, K2] may be given."""
    K, K2 = (1152, 2560) if G else (1160, 2568)
    N1, N2, N = 144, 384, 272
    x1 = _bf(gen, M, K) if x1 is None else x1
    x2 = _bf(gen, M, K) if x2 is None else x2
    h = _bf(gen, M, K2, std=0.5) if h is None else h
    (w1, s1), (w2, s2), (wd, sd), (wp, sp) = (_fmt_weight(gen, k, n, bits, G) for k, n in
                                              ((K, N1), (K, N2), (K2, N), (K, N)))
    b1, b2, bd = _bf(gen, N1, std=0.1), _bf(gen, N2, std=0.1), _bf(gen, N, std=0.1)
    res = _bf(gen, 32, N)[:M]  # row r the same at every M
    args3 = (x1, h, wp, wd, sp, sd, bd, res, bits, G)
    args13 = (x1, x2, w1, w2, s1, s2, b1, b2, None, "gelu-tanh", bits, G)
    calls = {"K3": (lambda: fused_proj_down(*args3), lambda: fused_proj_down_plain(*args3)),
             "K13": (lambda: fused_qkv_up(*args13), lambda: fused_qkv_up_plain(*args13))}
    if bits == 8 and not G:
        calls["K1"] = (lambda: quant_matmul(x1, w1, s1, b1, "relu"),
                       lambda: quant_matmul_plain(x1, w1, s1, b1, "relu"))
    elif bits == 4:
        one, plain = ((quant_matmul_w4_group, quant_matmul_w4_group_plain) if G else
                      (quant_matmul_w4, quant_matmul_w4_plain))
        extra = (G,) if G else ()
        calls["K7" if G else "K6"] = (lambda: one(x1, w1, s1, *extra, b1, "silu"),
                                      lambda: plain(x1, w1, s1, *extra, b1, "silu"))
    return calls


def _cat(y):
    return torch.cat(y, 1) if isinstance(y, tuple) else y


@pytest.mark.parametrize("M", TC_WIDTHS)
@pytest.mark.parametrize("bits,G", ALL_FORMATS)
def test_gemv_tensor_core_body_matches_plain(gen, M, bits, G):
    for name, (kernel, plain) in _gemv_calls(gen, M, bits, G).items():
        assert _rel(_cat(kernel()), _cat(plain())) < 1e-2, name


@pytest.mark.parametrize("bits,G", ALL_FORMATS)
def test_gemv_rows_are_the_same_at_every_width(gen, bits, G):
    """Row r of every GEMV's output is bit for bit the same at M = 2 .. 32
    (the pools' "alone == inside the mix" rests on it)."""
    K, K2 = (1152, 2560) if G else (1160, 2568)
    x1, x2, h = _bf(gen, 32, K), _bf(gen, 32, K), _bf(gen, 32, K2, std=0.5)
    seed = int(torch.randint(0, 2**31, (1,), generator=gen, device="cuda"))

    def outs(M):
        g = torch.Generator(device="cuda").manual_seed(seed)  # the same weights each time
        calls = _gemv_calls(g, M, bits, G, x1[:M].contiguous(), x2[:M].contiguous(),
                            h[:M].contiguous())
        return {n: _cat(k()) for n, (k, _) in calls.items()}

    full = outs(32)
    for M in (2, 4, 8, 9, 16, 17, 31):
        for name, y in outs(M).items():
            torch.cuda.synchronize()
            assert torch.equal(y, full[name][:M]), (name, M)


@pytest.mark.parametrize("M", [2, 8, 31])
@pytest.mark.parametrize("bits,G", ALL_FORMATS)
def test_gemv_reads_no_row_past_m(gen, M, bits, G):
    """x's memory past row M (up to the 8-row tile and beyond) is NaN: the
    outputs stay finite and equal those of a clean copy."""
    K, K2 = (1152, 2560) if G else (1160, 2568)
    x1p, x2p, hp = (torch.full((M + 40, k), float("nan"), dtype=torch.bfloat16, device="cuda")
                    for k in (K, K, K2))
    x1p[:M], x2p[:M], hp[:M] = _bf(gen, M, K), _bf(gen, M, K), _bf(gen, M, K2, std=0.5)
    seed = int(torch.randint(0, 2**31, (1,), generator=gen, device="cuda"))
    poisoned = _gemv_calls(torch.Generator(device="cuda").manual_seed(seed), M, bits, G,
                           x1p[:M], x2p[:M], hp[:M])
    clean = _gemv_calls(torch.Generator(device="cuda").manual_seed(seed), M, bits, G,
                        x1p[:M].clone(), x2p[:M].clone(), hp[:M].clone())
    for name, (kernel, _) in poisoned.items():
        y = _cat(kernel())
        torch.cuda.synchronize()
        assert bool(torch.isfinite(y.float()).all()), name
        assert torch.equal(y, _cat(clean[name][0]())), name


# --- the prefill-width GEMM (TMA + wgmma, csrc/ftcf_gemm.cuh) at its tile
# edges: 128-row blocks (M = 33 .. 1000), 64-deep k tiles (K = 136 ends
# inside one; 20480 is the FFN's down), 128- and 256-column blocks (N = 48
# and 144 end inside one; 2304 is BERT-base's QKV), groups of 32 inside one
# k tile (of 34, across two, where 32 does not divide K). K1, K6 and K7 on
# each shape.
GEMM_EDGE_M = [33, 64, 127, 129, 130, 257, 1000]
GEMM_EDGE_KN = [(136, 48), (136, 144), (1024, 2304), (20480, 144)]


def _gemm_calls(gen, K, N, w_all=None):
    """(name, kernel(x), plain(x)) of K1, K6 and K7 on one random [K, N]
    weight (or a layer's view of ``w_all``'s stacked weights)."""
    G = 32 if K % 32 == 0 else 34
    w8 = _i8(gen, K, N) if w_all is None else w_all[0]
    p4 = _i8(gen, K // 2, N) if w_all is None else w_all[1]
    s8, s4, g4 = _scale(gen, N), _scale(gen, N) * 16, _gscale(gen, K // G, N)
    b = _bf(gen, N, std=0.1)
    return [
        ("K1", lambda x: quant_matmul(x, w8, s8, b, "gelu-tanh"),
         lambda x: quant_matmul_plain(x, w8, s8, b, "gelu-tanh")),
        ("K6", lambda x: quant_matmul_w4(x, p4, s4, b),
         lambda x: quant_matmul_w4_plain(x, p4, s4, b)),
        ("K7", lambda x: quant_matmul_w4_group(x, p4, g4, G, b, "relu"),
         lambda x: quant_matmul_w4_group_plain(x, p4, g4, G, b, "relu")),
    ]


@pytest.mark.parametrize("K,N", GEMM_EDGE_KN)
@pytest.mark.parametrize("M", GEMM_EDGE_M)
def test_gemm_tile_edges_match_plain(gen, M, K, N):
    x = _bf(gen, M, K)
    for name, kernel, plain in _gemm_calls(gen, K, N):
        got = kernel(x)
        assert got.shape == (M, N)
        assert _rel(got, plain(x)) < 1e-2, name


@pytest.mark.parametrize("M", [130, 257])
def test_gemm_layer_view_of_stacked_weights(gen, M):
    """A layer's view of a stacked weight (its offset 16-byte aligned) is a
    TMA tensor of its own."""
    K, N = 512, 384
    w_all = (_i8(gen, 3, K, N)[2], _i8(gen, 3, K // 2, N)[1])
    x = _bf(gen, M, K)
    for name, kernel, plain in _gemm_calls(gen, K, N, w_all=w_all):
        assert _rel(kernel(x), plain(x)) < 1e-2, name


@pytest.mark.parametrize("M", [33, 130, 257])
@pytest.mark.parametrize("bits,G", [(8, 0), (4, 0), (4, 32)])
def test_k13_gemm_ragged_segments_match_plain(gen, M, bits, G):
    """K13's GEMM form with segment widths that are not block multiples."""
    K, N1, N2 = 1088, 400, 272
    x1, x2 = _bf(gen, M, K), _bf(gen, M, K)
    w1, s1 = _fmt_weight(gen, K, N1, bits, G)
    w2, s2 = _fmt_weight(gen, K, N2, bits, G)
    args = (x1, x2, w1, w2, s1, s2, _bf(gen, N1, std=0.1), None, None, "gelu", bits, G)
    y1, y2 = fused_qkv_up(*args)
    r1, r2 = fused_qkv_up_plain(*args)
    assert _rel(torch.cat([y1, y2], 1), torch.cat([r1, r2], 1)) < 1e-2


@pytest.mark.parametrize("K,N", [(1024, 2304), (5120, 15360)])
def test_gemm_rows_are_the_same_at_every_m(gen, K, N):
    """Row r of the GEMM's output is bit for bit the same at every M > 32
    (no split over k, one k order a column whatever M), and two calls give
    equal bytes: K1, K6, K7 and K13."""
    x, x2 = _bf(gen, 1000, K), _bf(gen, 1000, K)
    calls = _gemm_calls(gen, K, N)
    w1, s1 = _fmt_weight(gen, K, N, 8, 0)
    w2, s2 = _fmt_weight(gen, K, 3 * 128, 8, 0)
    calls.append(("K13", lambda xx: torch.cat(fused_qkv_up(
        xx, x2[:xx.shape[0]], w1, w2, s1, s2, None, None, None, "gelu"), 1), None))
    for name, kernel, _ in calls:
        full = kernel(x)
        assert torch.equal(full, kernel(x)), name
        for M in (33, 64, 129, 130, 257, 999):
            assert torch.equal(kernel(x[:M]), full[:M]), (name, M)


# --- K10 on TMA + wgmma (csrc/flash_chunk.cu): page sizes under a key tile
# (16 and 32 keys), a page size that is not a power of two, 8 query heads a
# KV head, chunks of 33 and 100 queries, a chunk across three pages, every
# (K, V) format.
def _kv_pages(gen, kind, L, P, nKV, ps, dh):
    if kind == "bf16":
        return _pages(gen, L, P, nKV, ps, dh, False)
    if kind == "int8":
        return _pages(gen, L, P, nKV, ps, dh, True)
    return _packed(gen, (L, P, nKV, ps, dh), kind)


@pytest.mark.parametrize("kind", ["bf16", "int8", "int4", "int8k_int4v"])
@pytest.mark.parametrize("ps,n_pg,nH,nKV,dh,C", [(16, 24, 8, 1, 128, 100), (32, 12, 16, 2, 128, 33),
                                                 (48, 8, 4, 4, 256, 100), (256, 2, 8, 1, 256, 64),
                                                 (12, 30, 8, 2, 128, 100), (6, 50, 4, 4, 256, 64)])
def test_k10_page_sizes_and_groups_match_plain(gen, kind, ps, n_pg, nH, nKV, dh, C):
    L, B = 2, 3
    S = ps * n_pg
    P = B * n_pg + 1
    pk, pks, pv, pvs = _kv_pages(gen, kind, L, P, nKV, ps, dh)
    pt = _table(gen, B, n_pg, P)
    q = _bf(gen, B, C, nH, dh)
    # row 1's chunk spans three pages; row 2 ends at the table's last key
    pos = torch.tensor([0, ps - 3, S - C], dtype=torch.int32, device="cuda")
    sm = dh ** -0.5
    got = flash_chunk_paged(q, pk, pks, pv, pvs, 1, pos, pt, sm)
    assert _rel(got, flash_chunk_paged_plain(q, pk, pks, pv, pvs, 1, pos, pt, sm)) < 2e-2


@pytest.mark.parametrize("kind", ["bf16", "int8", "int4", "int8k_int4v"])
def test_k10_reads_stop_at_the_chunk_every_format(gen, kind):
    """Keys past the chunk's last query are never used, whatever the page
    format: poisoning them (bf16 K 1e4 and V NaN; the scales of quantized
    pages NaN and their payload bytes random) changes nothing, also inside
    the last key tile that TMA brings whole."""
    B, nKV, dh, ps, C = 2, 2, 128, 128, 8
    pk, pks, pv, pvs = _kv_pages(gen, kind, 1, 5, nKV, ps, dh)
    pt = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32, device="cuda")
    q = _bf(gen, B, C, nKV * 4, dh)
    pos = torch.tensor([16, 100], dtype=torch.int32, device="cuda")
    clean = flash_chunk_paged(q, pk, pks, pv, pvs, 0, pos, pt, 0.09)
    for b, s in enumerate(pos.tolist()):
        end = s + C  # the first key past the chunk (even: whole pair rows below)
        for slab, scales, poison in ((pk, pks, 1e4), (pv, pvs, float("nan"))):
            packed = scales is not None and is_packed(slab, scales)
            first = end // 2 if packed else end
            if scales is None:
                slab[0, pt[b, 0], :, first:] = poison
                slab[0, pt[b, 1]] = poison
            else:
                scales[0, pt[b, 0], :, end:] = float("nan")
                scales[0, pt[b, 1]] = float("nan")
                slab[0, pt[b, 0], :, first:] = _i8(gen, *slab[0, pt[b, 0], :, first:].shape)
    again = flash_chunk_paged(q, pk, pks, pv, pvs, 0, pos, pt, 0.09)
    torch.cuda.synchronize()
    assert torch.equal(clean, again)


@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
def test_k10_is_deterministic(gen, kind):
    """No atomics, no split over keys: two calls give equal bytes."""
    B, nKV, dh, ps, n_pg, C = 4, 4, 128, 64, 16, 128
    P = B * n_pg + 1
    pk, pks, pv, pvs = _kv_pages(gen, kind, 1, P, nKV, ps, dh)
    pt = _table(gen, B, n_pg, P)
    q = _bf(gen, B, C, nKV * 2, dh)
    pos = torch.tensor([0, 333, 500, 896], dtype=torch.int32, device="cuda")
    a = flash_chunk_paged(q, pk, pks, pv, pvs, 0, pos, pt, 0.09)
    b = flash_chunk_paged(q, pk, pks, pv, pvs, 0, pos, pt, 0.09)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_k10_refuses_bf16_pages_off_the_swizzle_groups(gen):
    """bf16 pages whose size is not a multiple of 8 (12 and 5: no TMA box
    holds whole 8-row swizzle groups) are no longer refused: they land as
    raw rows and the consumers copy them into the swizzled layout, as they
    convert quantized pages of any size. Each matches the plain version, and
    keys past the chunk poisoned (K 1e4, V NaN) change nothing."""
    for ps in (12, 5):
        P, n_pg, C = 9, 4, 8
        pk, _, pv, _ = _pages(gen, 1, P, 2, ps, 128, False)
        pt = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]], dtype=torch.int32, device="cuda")
        pos = torch.tensor([0, ps * n_pg - C], dtype=torch.int32, device="cuda")
        q = _bf(gen, 2, C, 4, 128)
        got = flash_chunk_paged(q, pk, None, pv, None, 0, pos, pt, 0.1)
        assert _rel(got, flash_chunk_paged_plain(q, pk, None, pv, None, 0, pos, pt, 0.1)) < 2e-2
        for page in range(n_pg):  # row 0: keys C and past are never used
            first = max(0, C - page * ps)
            pk[0, pt[0, page], :, first:] = 1e4
            pv[0, pt[0, page], :, first:] = float("nan")
        again = flash_chunk_paged(q, pk, None, pv, None, 0, pos, pt, 0.1)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
    k8, ks, v8, vs = _pages(gen, 1, 4, 2, 12, 128, True)
    pt = torch.ones(1, 2, dtype=torch.int32, device="cuda")
    pos = torch.zeros(1, dtype=torch.int32, device="cuda")
    q = _bf(gen, 1, 8, 2, 128)
    got = flash_chunk_paged(q, k8, ks, v8, vs, 0, pos, pt, 0.1)
    assert _rel(got, flash_chunk_paged_plain(q, k8, ks, v8, vs, 0, pos, pt, 0.1)) < 2e-2


# int4 with fp32 group scales (``FTCF_GSCALE_BF16=0``): K7, K13, K3 and K2
# at the GEMV's widths and the GEMM's, G = 32 and 128.
@pytest.mark.parametrize("M", [1, 4, 9, 32, 33, 130])
@pytest.mark.parametrize("G", [32, 128])
def test_int4_fp32_group_scales_match_plain(gen, M, G):
    K, F, N1 = 1024, 512, 144
    x1, x2 = _bf(gen, M, K), _bf(gen, M, K)
    (w1, s1), (w2, s2), (wd, sd) = (_fmt_weight(gen, k, n, 4, G) for k, n in
                                    ((K, N1), (K, F), (F, K)))
    s1, s2, sd = s1.float(), s2.float(), sd.float() * 1.0009765625  # off the bf16 grid too
    b1, b2, bd = _bf(gen, N1, std=0.1), _bf(gen, F, std=0.1), _bf(gen, K, std=0.1)
    before = quant_matmul_w4_group.launches
    got = quant_matmul_w4_group(x1, w1, s1, G, b1, "gelu-tanh")
    assert quant_matmul_w4_group.launches == before + 1
    assert _rel(got, quant_matmul_w4_group_plain(x1, w1, s1, G, b1, "gelu-tanh")) < 1e-2
    args13 = (x1, x2, w1, w2, s1, s2, b1, b2, None, "gelu-tanh", 4, G)
    assert _rel(_cat(fused_qkv_up(*args13)), _cat(fused_qkv_up_plain(*args13))) < 1e-2
    if M <= 32:  # K3 and K2 are decode-width kernels
        h, res = _bf(gen, M, F, std=0.5), _bf(gen, M, K)
        wp, sp = _fmt_weight(gen, K, K, 4, G)
        args3 = (x1, h, wp, wd, sp.float(), sd, bd, res, 4, G)
        assert _rel(fused_proj_down(*args3), fused_proj_down_plain(*args3)) < 1e-2
        args2 = (x2, x1, res, w2, wp, wd, s2, sp.float(), sd, b2, bd, "gelu-tanh", 4, G)
        assert _rel(fused_up_proj_down(*args2), fused_up_proj_down_plain(*args2)) < 2e-2


@pytest.mark.parametrize("M", [1, 4, 32, 130])
def test_int4_fp32_group_scales_equal_bf16_on_bf16_values(gen, M):
    """fp32 group scales that bf16 holds exactly give the bf16 instances'
    bytes: the GEMV multiplies each partial by the same float, the GEMM
    rounds each int4 x scale product once to bf16 either way."""
    K, N, G = 1024, 384, 128
    x, x2 = _bf(gen, M, K), _bf(gen, M, K)
    (w, s), (w2, s2) = _fmt_weight(gen, K, N, 4, G), _fmt_weight(gen, K, N, 4, G)
    b = _bf(gen, N, std=0.1)
    a16 = quant_matmul_w4_group(x, w, s, G, b)
    a32 = quant_matmul_w4_group(x, w, s.float(), G, b)
    y16 = fused_qkv_up(x, x2, w, w2, s, s2, b, b, None, "gelu-tanh", 4, G)
    y32 = fused_qkv_up(x, x2, w, w2, s.float(), s2.float(), b, b, None, "gelu-tanh", 4, G)
    torch.cuda.synchronize()
    assert torch.equal(a16, a32) and torch.equal(_cat(y16), _cat(y32))


# The decoder families' widths (chip_smoke.py phase_families serves them):
# GPT-2 XL's 1600 -> 4800 (QKV) and 6400 -> 1600 (down), off multiples of
# 128; Qwen2.5-Coder-7B's 28 query heads on 4 KV heads (g = 7); GPT-J's 16
# heads of 256 and its K13 with no QKV bias (4096 -> 12288 + 16384).
@pytest.mark.parametrize("M", [1, 4, 33, 130, 512])
@pytest.mark.parametrize("K,N", [(1600, 4800), (6400, 1600), (1600, 6400), (1600, 1600)])
def test_k1_at_gpt2_xl_widths(gen, M, K, N):
    x, w, s = _bf(gen, M, K), _i8(gen, K, N), _scale(gen, N)
    b = _bf(gen, N, std=0.1)
    got = quant_matmul(x, w, s, b, "gelu-tanh")
    assert got.shape == (M, N)
    assert _rel(got, quant_matmul_plain(x, w, s, b, "gelu-tanh")) < 1e-2


@pytest.mark.parametrize("B,S,nH,nKV,dh,lens", [
    (2, 300, 28, 4, 128, [300, 77]), (1, 257, 28, 4, 128, [257]),
    (2, 300, 16, 16, 256, [300, 129]), (1, 65, 16, 16, 256, [65]),
    (2, 200, 48, 1, 128, [200, 3]), (1, 300, 25, 25, 64, [300])])
def test_k5_at_family_shapes(gen, B, S, nH, nKV, dh, lens):
    q, k, v = _bf(gen, B, S, nH, dh), _bf(gen, B, S, nKV, dh), _bf(gen, B, S, nKV, dh)
    ln = torch.tensor(lens, dtype=torch.int32, device="cuda")
    got = prefill_attention_flash(q, k, v, ln, dh ** -0.5)
    assert _rel(got, prefill_attention_flash_plain(q, k, v, ln, dh ** -0.5)) < 2e-2


@pytest.mark.parametrize("quant", [True, False])
@pytest.mark.parametrize("B,nH,nKV,dh,S", [(4, 28, 4, 128, 300), (1, 28, 4, 128, 1100),
                                            (4, 16, 16, 256, 300), (2, 25, 25, 64, 600),
                                            (4, 32, 8, 128, 300)])
def test_k4_at_family_shapes(gen, quant, B, nH, nKV, dh, S):
    test_k4_matches_plain(gen, B, nH, nKV, dh, S, quant)


@pytest.mark.parametrize("C", [8, 128])
@pytest.mark.parametrize("B,nH,nKV,dh,ps,n_pg,quant", [
    (2, 48, 1, 128, 256, 3, True), (2, 28, 4, 128, 256, 3, True), (2, 16, 16, 256, 128, 3, True),
    (2, 48, 1, 128, 16, 40, False)])
def test_k10_at_family_shapes(gen, C, B, nH, nKV, dh, ps, n_pg, quant):
    """StarCoder's MQA (48 query heads on one KV head), Qwen2.5-Coder's g = 7
    and GPT-J's 16 x 256 in chunked prefill over pages."""
    test_k10_matches_plain(gen, C, B, nH, nKV, dh, ps, n_pg, quant)


@pytest.mark.parametrize("B,nH,nKV,dh,ps,n_pg,quant", [
    (3, 48, 1, 128, 256, 3, True), (3, 28, 4, 128, 16, 20, True), (2, 25, 25, 64, 8, 9, True),
    (2, 16, 16, 256, 256, 2, False)])
def test_k9_at_family_shapes(gen, B, nH, nKV, dh, ps, n_pg, quant):
    test_k9_matches_plain(gen, B, nH, nKV, dh, ps, n_pg, quant)


@pytest.mark.parametrize("M", [1, 4, 130])
def test_k13_without_a_qkv_bias_at_gptj_widths(gen, M):
    """GPT-J's K13 (QKV 4096 -> 12288 with no bias, up 4096 -> 16384 with
    its bias and tanh-gelu) and K3 (proj 4096 -> 4096, down 16384 -> 4096,
    fc_out's bias, the residual)."""
    H, F = 4096, 16384
    x1, x2 = _bf(gen, M, H), _bf(gen, M, H)
    w1, w2, s1, s2 = _i8(gen, H, 3 * H), _i8(gen, H, F), _scale(gen, 3 * H), _scale(gen, F)
    b2 = _bf(gen, F, std=0.1)
    args = (x1, x2, w1, w2, s1, s2, None, b2, None, "gelu-tanh", 8, 0)
    y1, y2 = fused_qkv_up(*args)
    r1, r2 = fused_qkv_up_plain(*args)
    assert _rel(torch.cat([y1, y2], 1), torch.cat([r1, r2], 1)) < 1e-2
    assert torch.equal(y1, quant_matmul(x1, w1, s1))  # K1's arithmetic, no bias
    if M <= 32:
        w_p, w_d, s_p, s_d = _i8(gen, H, H), _i8(gen, F, H), _scale(gen, H), _scale(gen, H)
        a, h, res, b_d = _bf(gen, M, H), (r2 * 0.5).contiguous(), _bf(gen, M, H), _bf(gen, H)
        k3 = fused_proj_down(a, h, w_p, w_d, s_p, s_d, b_d, res)
        assert _rel(k3, fused_proj_down_plain(a, h, w_p, w_d, s_p, s_d, b_d, res)) < 1e-2


# --- launch plans from the tile cache (ops/tile_tuning.py): every GEMM block
# tile, group-M width and stage cap, and GEMV split counts, served to the
# wrappers through a cache file of their own, against the plain versions;
# every GEMM plan gives the default's bytes (one k order whatever the tile).
@pytest.fixture
def tile_cache(tmp_path, monkeypatch):
    """serve(kernel, M, K, N, G, **fields): a cache entry for this card."""
    from fastertransformer4codefuse_tpu_torch.ops import tile_tuning

    path = tmp_path / "tile_cache.json"
    monkeypatch.setenv("FTCF_TILE_CACHE", str(path))
    monkeypatch.delenv("FTCF_TILE_TUNE", raising=False)
    tile_tuning.invalidate()
    sms = torch.cuda.get_device_properties(0).multi_processor_count if \
        torch.cuda.is_available() else 0

    def serve(kernel, M, K, N, G=0, **fields):
        entries = json.loads(path.read_text()) if path.exists() else {}
        entries[tile_tuning._key(kernel, tile_tuning.bucket(M), K, N, G)] = {
            "bn": 0, "bk": 0, "us": 1.0, "note": "test", "sms": sms, **fields}
        path.write_text(json.dumps(entries))
        tile_tuning.invalidate()

    yield serve
    tile_tuning.invalidate()


GEMM_PLANS = [(128, 128, 8, 8), (64, 128, 8, 8), (128, 256, 8, 8), (256, 128, 8, 8), (64, 128, 4, 4),
              (128, 256, 16, 4), (128, 128, 1, 2)]


def _gemm_fields(rows, cols, group_m, stages):
    return dict(bn=cols, bk=64, rows=rows, group_m=group_m, stages=stages)


@pytest.mark.parametrize("plan", GEMM_PLANS)
@pytest.mark.parametrize("M", [33, 130, 257])
@pytest.mark.parametrize("bits,G,sdt", [(8, 0, None), (4, 0, None), (4, 128, torch.bfloat16),
                                        (4, 32, torch.float32), (8, 64, torch.float32)])
def test_gemm_plans_match_plain_and_the_default(gen, tile_cache, plan, M, bits, G, sdt):
    """K1 / K6 / K7 (ragged N = 400; K off the 64-deep k tiles where the
    groups allow) and K13 (segments of 400 and 272) under each GEMM plan:
    within 1e-2 of the plain version, and bit for bit the default plan's
    output."""
    from fastertransformer4codefuse_tpu_torch.ops import tile_tuning

    K, N, N2 = {0: 1160, 32: 1120, 64: 1088, 128: 1152}[G], 400, 272
    x, x2 = _bf(gen, M, K), _bf(gen, M, K)
    w, s = _fmt_weight(gen, K, N, bits, G)
    w2, s2 = _fmt_weight(gen, K, N2, bits, G)
    if G:
        s, s2 = s.to(sdt), s2.to(sdt)
    b = _bf(gen, N, std=0.1)
    if bits == 8:
        one = lambda: quant_matmul(x, w, s, b, "gelu", group_size=G)  # noqa: E731
        one_p = lambda: quant_matmul_plain(x, w, s, b, "gelu", group_size=G)  # noqa: E731
    elif G:
        one = lambda: quant_matmul_w4_group(x, w, s, G, b, "gelu")  # noqa: E731
        one_p = lambda: quant_matmul_w4_group_plain(x, w, s, G, b, "gelu")  # noqa: E731
    else:
        one = lambda: quant_matmul_w4(x, w, s, b, "gelu")  # noqa: E731
        one_p = lambda: quant_matmul_w4_plain(x, w, s, b, "gelu")  # noqa: E731
    args13 = (x, x2, w, w2, s, s2, b, None, None, "gelu-tanh", bits, G)
    k13 = lambda: torch.cat(fused_qkv_up(*args13), 1)  # noqa: E731
    defaults = one(), k13()
    fmt = {(8, 0): "i8", (4, 0): "i4", (4, 128): "i4g", (4, 32): "i4gf", (8, 64): "i8g"}[bits, G]
    tile_cache(f"gemm_{fmt}", M, K, N, G, **_gemm_fields(*plan))
    tile_cache(f"ncat_gemm_{fmt}", M, K, N + N2, G, **_gemm_fields(*plan))
    hits = sum(tile_tuning.hits.values())
    got, got13 = one(), k13()
    assert sum(tile_tuning.hits.values()) == hits + 2
    assert _rel(got, one_p()) < 1e-2
    assert _rel(got13, torch.cat(fused_qkv_up_plain(*args13), 1)) < 1e-2
    assert torch.equal(got, defaults[0]) and torch.equal(got13, defaults[1])


@pytest.mark.parametrize("plan", GEMM_PLANS[1:3])
@pytest.mark.parametrize("M", [64, 1000])
def test_gemm_plans_at_codefuse_widths(gen, tile_cache, plan, M):
    """The 64 x 128 and 128 x 256 tiles at CodeFuse-13B's proj and K13 int8
    widths and K8's head (fp32 out): within 1e-2, the default's bytes."""
    H, F, V = 5120, 20480, 102400
    x, x2 = _bf(gen, M, H), _bf(gen, M, H)
    w, s, b = _i8(gen, H, H), _scale(gen, H), _bf(gen, H, std=0.1)
    wq, sq, wu, su = _i8(gen, H, 3 * H), _scale(gen, 3 * H), _i8(gen, H, F), _scale(gen, F)
    ph, sh = _i8(gen, H // 2, V), _scale(gen, V) * 16
    calls = [("gemm_i8", H, H, lambda: quant_matmul(x, w, s, b),
              lambda: quant_matmul_plain(x, w, s, b)),
             ("ncat_gemm_i8", H, 3 * H + F,
              lambda: torch.cat(fused_qkv_up(x, x2, wq, wu, sq, su, None, None, None, "gelu"), 1),
              lambda: torch.cat(fused_qkv_up_plain(x, x2, wq, wu, sq, su, None, None, None,
                                                   "gelu"), 1)),
             ("gemm_i4", H, V, lambda: quant_matmul_w4_head(x, ph, sh),
              lambda: quant_matmul_w4_head_plain(x, ph, sh))]
    for kernel, K, N, fn, plain in calls:
        default = fn()
        tile_cache(kernel, M, K, N, **_gemm_fields(*plan))
        got = fn()
        assert _rel(got, plain()) < 1e-2, kernel
        assert torch.equal(got, default), kernel


@pytest.mark.parametrize("splits", [1, 2, 3, 7, 16])
@pytest.mark.parametrize("M", [1, 4, 9, 32])
@pytest.mark.parametrize("bits,G", ALL_FORMATS)
def test_gemv_split_counts_match_plain(gen, tile_cache, splits, M, bits, G):
    """K1 / K6 / K7, K13 (two segments over N) and K3 (two over K) under
    split counts the cache names (each segment's count of ranges of whole
    units nearest to ``splits``): within 1e-2 of the plain versions."""
    from fastertransformer4codefuse_tpu_torch.ops.quant_matmul import split_chunk

    K, K2 = (1152, 2560) if G else (1160, 2568)
    N1, N2, N = 144, 384, 272
    n, n2 = split_chunk(K, splits, G)[0], split_chunk(K2, splits, G)[0]
    fmt = {(8, 0): "i8", (4, 0): "i4", (4, 32): "i4g", (8, 32): "i8g"}[bits, G]
    tile_cache(f"gemv_{fmt}", M, K, N1, G, splits=[n])
    tile_cache(f"ncat_gemv_{fmt}", M, K, N1 + N2, G, splits=[n, n])
    tile_cache(f"pd_gemv_{fmt}", M, K + K2, N, G, splits=[n, n2])
    for name, (kernel, plain) in _gemv_calls(gen, M, bits, G).items():
        assert _rel(_cat(kernel()), _cat(plain())) < 1e-2, (name, splits)


@pytest.mark.parametrize("splits", [2, 9])
def test_gemv_rows_are_the_same_under_a_split_count(gen, tile_cache, splits):
    """Under one split count served at every bucket 2-32, row r of K13 is
    bit for bit the same at M = 2 .. 32 (the tile cache records one count
    for those buckets)."""
    K, N1, N2 = 5120, 384, 640
    x1, x2 = _bf(gen, 32, K), _bf(gen, 32, K)
    w1, s1 = _fmt_weight(gen, K, N1, 8, 0)
    w2, s2 = _fmt_weight(gen, K, N2, 8, 0)
    for M in (2, 4, 8, 16, 32):
        tile_cache("ncat_gemv_i8", M, K, N1 + N2, splits=[splits, splits])
    fn = lambda M: torch.cat(fused_qkv_up(x1[:M], x2[:M], w1, w2, s1, s2), 1)  # noqa: E731
    full = fn(32)
    for M in (2, 3, 5, 8, 9, 16, 17, 31):
        assert torch.equal(fn(M), full[:M]), M


def test_tile_cache_misses_and_refusals_on_the_card(gen, tile_cache):
    """An entry of another card's SM count is a miss (the default launches,
    counted in ``misses``); an entry naming a tile or a split the kernels
    have no instance for raises, naming the entry."""
    from fastertransformer4codefuse_tpu_torch.ops import tile_tuning

    K, N = 1024, 256
    w, s = _i8(gen, K, N), _scale(gen, N)
    x, x1 = _bf(gen, 64, K), _bf(gen, 1, K)
    ref, ref1 = quant_matmul(x, w, s), quant_matmul(x1, w, s)
    tile_cache("gemm_i8", 64, K, N, sms=7, **_gemm_fields(64, 128, 4, 4))
    misses = tile_tuning.misses["gemm_i8"]
    assert torch.equal(quant_matmul(x, w, s), ref)
    assert tile_tuning.misses["gemm_i8"] == misses + 1
    for bad in (_gemm_fields(96, 128, 8, 8), _gemm_fields(128, 512, 8, 8),
                _gemm_fields(128, 128, 8, 9), {**_gemm_fields(128, 128, 8, 8), "bk": 128}):
        tile_cache("gemm_i8", 64, K, N, **bad)
        with pytest.raises(ValueError, match=r"gemm_i8\|bm64\|k1024\|n256\|g0"):
            quant_matmul(x, w, s)
    for bad in ([0], [1000], [3, 3], "4"):
        tile_cache("gemv_i8", 1, K, N, splits=bad)
        with pytest.raises(ValueError, match=r"gemv_i8\|bm1\|k1024\|n256\|g0"):
            quant_matmul(x1, w, s)
    tile_cache("gemv_i8", 1, K, N, splits=[4])
    assert _rel(quant_matmul(x1, w, s), ref1) < 1e-2
