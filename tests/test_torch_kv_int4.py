"""The port's packed int4 KV caches, dense and paged (engine/kv_cache.py,
engine/paged_kv.py, the plain versions of K4/K9/K10 in ops/flash_decode.py)
against the JAX package's ``"int4"`` and ``"int8k_int4v"`` caches, on the cases
of tests/test_engine_kv.py and tests/test_paged_kv.py.

The JAX package's XLA unpack path is the ground truth for the attention:
interpret mode does not reproduce the hardware int4 order for weights
(tests/test_fused_kernels.py), so the JAX Pallas kernels in interpret mode are
compared beside it, not instead of it.

Tolerances: packed bytes and bf16 scales equal bit for bit; attention over
fp32 queries within 1e-5 of the JAX XLA path (summation order only); against
the JAX kernels in interpret mode within 3e-2 (their tolerance to the XLA
path, tests/test_paged_kv.py)."""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fastertransformer4codefuse_tpu.core.config import GptNeoXConfig as JaxConfig
from fastertransformer4codefuse_tpu.engine import kv_cache as jkvc
from fastertransformer4codefuse_tpu.engine import paged_kv as jpaged
from fastertransformer4codefuse_tpu.ops.flash_decode import (
    flash_chunk_paged as jax_flash_chunk_paged,
    flash_decode_paged as jax_flash_decode_paged,
    flash_decode_stacked as jax_flash_decode_stacked,
)
from fastertransformer4codefuse_tpu_torch.core.config import GptNeoXConfig
from fastertransformer4codefuse_tpu_torch.engine import kv_cache as kvc
from fastertransformer4codefuse_tpu_torch.engine import paged_kv as paged
from fastertransformer4codefuse_tpu_torch.ops import flash_decode as fd

torch.set_num_threads(2)

KINDS = ["int4", "int8k_int4v"]
JCFG = JaxConfig.tiny(head_num=4, size_per_head=16, layer_num=2)
CFG = GptNeoXConfig(**dataclasses.asdict(JCFG))
PS, NPG, B = 8, 4, 3
S = PS * NPG


def _bits(a):
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy() if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _assert_same(jc, tc, names=None):
    assert set(jc) == set(tc)
    for n in names or jc:
        np.testing.assert_array_equal(_bits(jc[n]), _bits(tc[n]), err_msg=n)


def _kv(rng, *shape):
    a = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


@pytest.fixture
def xla_decode():
    """The JAX attention on its XLA path (restored after)."""
    old = jkvc._FLASH_DECODE
    jkvc.set_flash_decode(False)
    yield
    jkvc.set_flash_decode(old)


def test_pack_pairs_bit_identical_to_jax_and_round_trip():
    rng = np.random.default_rng(0)
    codes = rng.integers(-8, 8, (3, 10, 16)).astype(np.int8)
    want = np.asarray(jkvc._pack_seq_pairs(jnp.asarray(codes)))
    got = kvc._pack_seq_pairs(torch.from_numpy(codes))
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(kvc._unpack_seq_pairs(got), torch.from_numpy(codes))
    anybytes = rng.integers(-128, 128, (2, 5, 3, 8)).astype(np.int8)
    for dim in (1, -2):
        np.testing.assert_array_equal(
            kvc._unpack_seq_pairs(torch.from_numpy(anybytes), dim).numpy(),
            np.asarray(jkvc._unpack_seq_pairs(jnp.asarray(anybytes), dim)))
    # nibble order: even position in the low nibble
    pair = torch.tensor([[1], [-1]], dtype=torch.int8)  # positions 0, 1
    assert kvc._pack_seq_pairs(pair, 0).item() == (-1 << 4) | 1


@pytest.mark.parametrize("mode", ["preserve", "sacrifice_last"])
@pytest.mark.parametrize("kind", KINDS)
def test_dense_packed_writes_bit_identical(kind, mode):
    """Prefill, then decode writes at even and odd slots (a neighbour pair
    written in turn, skipped rows in either mode): bytes and scales equal."""
    rng = np.random.default_rng(1)
    Smax, P = 16, 6
    jc = jkvc.init_cache(JCFG, B, Smax, kind)
    tc = kvc.init_cache(CFG, B, Smax, kind, "cpu")
    _assert_same(jc, tc)
    nKV, dh = CFG.kv_heads, CFG.size_per_head
    for layer in range(CFG.layer_num):
        (jk, tk), (jv, tv) = _kv(rng, B, P, nKV, dh), _kv(rng, B, P, nKV, dh)
        jc = jkvc.write_prefill(jc, layer, jk * 3.0, jv)
        kvc.write_prefill(tc, layer, tk * 3.0, tv)
    _assert_same(jc, tc)
    for step in range(5):
        (jk, tk), (jv, tv) = _kv(rng, B, 1, nKV, dh), _kv(rng, B, 1, nKV, dh)
        pos = np.array([P + step, P + 2 * step, 9], np.int32)  # neighbours, then a fixed slot
        sk = np.array([False, step == 3, step % 2 == 1])
        jc = jkvc.write_decode(jc, 1, jk, jv, jnp.asarray(pos), skip=jnp.asarray(sk),
                               skip_mode=mode)
        kvc.write_decode(tc, 1, tk, tv, torch.from_numpy(pos), skip=torch.from_numpy(sk),
                         skip_mode=mode)
        _assert_same(jc, tc)
    assert kvc.seq_len_of(tc) == Smax and kvc.packed4(tc, "v")
    assert kvc.packed4(tc, "k") == (kind == "int4")


def test_dense_packed_decode_neighbours_round_trip():
    """Writing slot 4 then slot 5 keeps both (the odd write merges over the
    even slot's low nibble): each dequantizes within half a step."""
    tc = kvc.init_cache(CFG, 1, 8, "int4", "cpu")
    rng = np.random.default_rng(2)
    vecs = [torch.from_numpy(rng.standard_normal((1, 1, CFG.kv_heads, 16)).astype(np.float32))
            for _ in range(2)]
    for p, x in zip((4, 5), vecs):
        kvc.write_decode(tc, 0, x, x, torch.tensor([p], dtype=torch.int32))
    codes = kvc._unpack_seq_pairs(tc["k4"][0, 0]).float()  # [nKV, S, dh]
    for p, x in zip((4, 5), vecs):
        deq = codes[:, p] * tc["k_s"][0, 0, :, p].float()[:, None]
        step = x.abs().amax(-1)[0, 0] / 7.0
        assert bool(((deq - x[0, 0]).abs() <= step[:, None] * 0.5 + 1e-6).all()), p


def test_dense_packed_write_chunk_refused():
    tc = kvc.init_cache(CFG, B, 16, "int4", "cpu")
    k = torch.zeros(B, 4, CFG.kv_heads, 16)
    with pytest.raises(ValueError, match="pair bytes"):
        kvc.write_chunk(tc, 0, k, k, torch.zeros(B, dtype=torch.int32),
                        torch.ones(B, dtype=torch.bool))
    with pytest.raises(ValueError, match="even"):
        kvc.init_cache(CFG, B, 15, "int4", "cpu")


@pytest.mark.parametrize("gqa", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_dense_packed_attend_decode_matches_jax_xla(kind, gqa, xla_decode):
    kw = dict(head_num=4, size_per_head=16, layer_num=2)
    if gqa:
        kw.update(kv_head_num=2, qkv_layout="concat")
    jcfg = JaxConfig.tiny(**kw)
    cfg = GptNeoXConfig(**dataclasses.asdict(jcfg))
    rng = np.random.default_rng(3)
    Smax, P = 16, 8
    nKV, nH, dh = cfg.kv_heads, cfg.head_num, cfg.size_per_head
    jc = jkvc.init_cache(jcfg, B, Smax, kind)
    tc = kvc.init_cache(cfg, B, Smax, kind, "cpu")
    (jk, tk), (jv, tv) = _kv(rng, B, P, nKV, dh), _kv(rng, B, P, nKV, dh)
    jc = jkvc.write_prefill(jc, 1, jk, jv)
    kvc.write_prefill(tc, 1, tk, tv)
    posn = np.array([8, 11, 3], np.int32)
    for t in range(4):
        (jk, tk), (jv, tv) = _kv(rng, B, 1, nKV, dh), _kv(rng, B, 1, nKV, dh)
        pp = np.minimum(P + t, posn).astype(np.int32)
        jc = jkvc.write_decode(jc, 1, jk, jv, jnp.asarray(pp))
        kvc.write_decode(tc, 1, tk, tv, torch.from_numpy(pp))
    jq, tq = _kv(rng, B, nH, dh)
    valid = np.arange(Smax)[None, :] <= posn[:, None]
    want = jkvc.attend_decode(jc, 1, jq, jnp.asarray(valid), 0.25, positions=jnp.asarray(posn))
    got = kvc.attend_decode(tc, 1, tq, 0.25, torch.from_numpy(posn))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # the dense multi-query path (two queries a row) unpacks as well
    jq2, tq2 = _kv(rng, B, 2, nH, dh)
    posc = np.stack([posn - 1, posn], axis=1)
    valid2 = np.arange(Smax)[None, None, :] <= posc[:, :, None]
    want2 = jkvc.attend_chunk(jc, 1, jq2, jnp.asarray(valid2), 0.25)
    got2 = kvc.attend_chunk(tc, 1, tq2, torch.from_numpy(valid2), 0.25)
    np.testing.assert_allclose(got2.numpy(), np.asarray(want2), rtol=1e-5, atol=1e-5)


def test_plain_k4_packed_matches_jax_interpret():
    """Beside the XLA comparison: JAX's packed-slab kernel in interpret mode
    (tests/test_engine_kv.py's case) against the port's plain K4."""
    rng = np.random.default_rng(0)
    L, nH, Sx, dh = 2, 8, 640, 128
    arr = {
        "k4": rng.integers(-128, 128, (L, 1, nH, Sx // 2, dh)).astype(np.int8),
        "v4": rng.integers(-128, 128, (L, 1, nH, Sx // 2, dh)).astype(np.int8),
        "k_s": (rng.random((L, 1, nH, Sx)) * 0.02).astype(np.float32),
        "v_s": (rng.random((L, 1, nH, Sx)) * 0.02).astype(np.float32),
    }
    j = {n: jnp.asarray(a, jnp.bfloat16 if n.endswith("_s") else jnp.int8) for n, a in arr.items()}
    t = {n: torch.from_numpy(a).to(torch.bfloat16) if n.endswith("_s") else torch.from_numpy(a)
         for n, a in arr.items()}
    q = rng.standard_normal((1, nH, dh)).astype(np.float32)
    jq, tq = jnp.asarray(q, jnp.bfloat16), torch.from_numpy(q).to(torch.bfloat16)
    sm = 1.0 / float(np.sqrt(dh))
    for pos in (15, 500):
        want = jax_flash_decode_stacked(
            jq, j["k4"], j["k_s"], j["v4"], j["v_s"], jnp.int32(1), jnp.asarray([pos], jnp.int32),
            sm_scale=sm, bs=256, interpret=True)
        got = fd.flash_decode_stacked(tq, t["k4"], t["k_s"], t["v4"], t["v_s"], 1,
                                      torch.tensor([pos], dtype=torch.int32), sm)
        err = np.abs(got.float().numpy() - np.asarray(want.astype(jnp.float32))).max()
        assert err < 5e-2, (pos, err)


def _pair_pools(kind, rng, n_pages=B * NPG + 3):
    jc = jpaged.init_paged_cache(JCFG, B, S, n_pages=n_pages, page_size=PS, dtype=kind)
    tc = paged.init_paged_cache(CFG, B, S, n_pages, PS, kind, "cpu")
    pt = rng.permutation(np.arange(1, n_pages))[: B * NPG].reshape(B, NPG).astype(np.int32)
    jc["pt"], tc["pt"] = jnp.asarray(pt), torch.from_numpy(pt)
    return jc, tc


@pytest.mark.parametrize("kind", KINDS)
def test_paged_packed_writes_bit_identical(kind):
    """Chunk writes (even C, page-aligned and mid-page starts, an inactive
    row), then decode writes at random even and odd positions with a skipped
    row: page bytes, scales and the unpacked dense view equal JAX's."""
    rng = np.random.default_rng(4)
    jc, tc = _pair_pools(kind, rng)
    nKV, dh = CFG.kv_heads, CFG.size_per_head
    C = PS // 2
    for layer in range(CFG.layer_num):
        for start in range(0, S // 2, C):
            (jk, tk), (jv, tv) = _kv(rng, B, C, nKV, dh), _kv(rng, B, C, nKV, dh)
            pos = np.full((B,), start, np.int32)
            act = np.array([True, start < PS, True])
            jc = jkvc.write_chunk(jc, layer, jk, jv, jnp.asarray(pos), jnp.asarray(act))
            kvc.write_chunk(tc, layer, tk, tv, torch.from_numpy(pos), torch.from_numpy(act))
        # inactive rows' chunks land on the garbage page in either order
        for n in [n for n in jc if n != "pt"]:
            np.testing.assert_array_equal(_bits(jc[n])[layer, 1:], _bits(tc[n])[layer, 1:],
                                          err_msg=n)
        for step in range(6):
            (jk, tk), (jv, tv) = _kv(rng, B, 1, nKV, dh), _kv(rng, B, 1, nKV, dh)
            posn = rng.integers(0, S, B).astype(np.int32)
            sk = np.array([False, False, step == 2])
            jc = jkvc.write_decode(jc, layer, jk, jv, jnp.asarray(posn), skip=jnp.asarray(sk))
            kvc.write_decode(tc, layer, tk, tv, torch.from_numpy(posn), skip=torch.from_numpy(sk))
        for n in [n for n in jc if n != "pt"]:
            np.testing.assert_array_equal(_bits(jc[n])[layer, 1:], _bits(tc[n])[layer, 1:],
                                          err_msg=n)
        jg, tg = jpaged.gather_layer_dense(jc, layer), paged.gather_layer_dense(tc, layer)
        _assert_same(jg, tg)
        assert tg["v"].shape == (B, nKV, S, dh) and tg["v"].dtype == torch.int8
    assert paged.page_size(tc) == PS and paged.num_pages(tc) == B * NPG + 3


def test_paged_packed_chunk_equals_decode_writes():
    """A C-wide packed chunk write equals C per-position decode writes."""
    rng = np.random.default_rng(5)
    _, a = _pair_pools("int4", rng)
    bcache = {n: t.clone() for n, t in a.items()}
    C = PS // 2
    k = torch.from_numpy(rng.standard_normal((B, C, CFG.kv_heads, 16)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((B, C, CFG.kv_heads, 16)).astype(np.float32))
    start = torch.full((B,), PS + C, dtype=torch.int32)  # mid-page
    kvc.write_chunk(a, 0, k, v, start, torch.ones(B, dtype=torch.bool))
    for c in range(C):
        kvc.write_decode(bcache, 0, k[:, c:c + 1], v[:, c:c + 1], start + c)
    for n in a:
        assert torch.equal(a[n], bcache[n]), n
    with pytest.raises(ValueError, match="even prompt_bucket"):
        kvc.write_chunk(a, 0, k[:, :1], v[:, :1], start, torch.ones(B, dtype=torch.bool))


@pytest.mark.parametrize("kind", KINDS)
def test_paged_packed_attend_matches_jax_xla(kind, xla_decode):
    """Plain K9 (decode) and plain K10 (chunk, with positions) over packed
    pages against the JAX XLA page-gather path."""
    rng = np.random.default_rng(6)
    jc, tc = _pair_pools(kind, rng)
    nKV, nH, dh = CFG.kv_heads, CFG.head_num, CFG.size_per_head
    posn = np.array([5, 12, 30], np.int32)
    for p in range(int(posn.max()) + 1):
        (jk, tk), (jv, tv) = _kv(rng, B, 1, nKV, dh), _kv(rng, B, 1, nKV, dh)
        pp = np.minimum(posn, p).astype(np.int32)
        jc = jkvc.write_decode(jc, 1, jk, jv, jnp.asarray(pp))
        kvc.write_decode(tc, 1, tk, tv, torch.from_numpy(pp))
    jq, tq = _kv(rng, B, nH, dh)
    valid = np.arange(S)[None, :] <= posn[:, None]
    want = jkvc.attend_decode(jc, 1, jq, jnp.asarray(valid), 0.25, positions=jnp.asarray(posn))
    got = kvc.attend_decode(tc, 1, tq, 0.25, torch.from_numpy(posn))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    C = 2
    jq2, tq2 = _kv(rng, B, C, nH, dh)
    starts = (posn - 1) // 2 * 2  # even chunk starts, the chunk ends at or past posn - 1
    posc = starts[:, None] + np.arange(C)[None, :]
    valid2 = np.arange(S)[None, None, :] <= posc[:, :, None]
    want2 = jkvc.attend_chunk(jc, 1, jq2, jnp.asarray(valid2), 0.25)
    got2 = kvc.attend_chunk(tc, 1, tq2, torch.from_numpy(valid2), 0.25,
                            positions=torch.from_numpy(starts.astype(np.int32)))
    np.testing.assert_allclose(got2.numpy(), np.asarray(want2), rtol=1e-5, atol=1e-5)


def _packed_kernel_pages(kind, rng, ps=256, npg=3, nb=2, nKV=2, dh=128):
    """Random packed pages at the kernels' widths: numpy arrays."""
    P = nb * npg + 2
    pshape, sshape = (1, P, nKV, ps // 2, dh), (1, P, nKV, ps)
    pages = {
        "pv": rng.integers(-128, 128, pshape).astype(np.int8),
        "pks": (rng.random(sshape) * 0.2).astype(np.float32),
        "pvs": (rng.random(sshape) * 0.2).astype(np.float32),
    }
    pages["pk"] = (rng.integers(-128, 128, pshape) if kind == "int4"
                   else rng.integers(-127, 128, (1, P, nKV, ps, dh))).astype(np.int8)
    pt = rng.permutation(np.arange(1, P))[: nb * npg].reshape(nb, npg).astype(np.int32)
    j = {n: jnp.asarray(a, jnp.bfloat16 if n.endswith("s") else jnp.int8)
         for n, a in pages.items()}
    t = {n: torch.from_numpy(a).to(torch.bfloat16) if n.endswith("s") else torch.from_numpy(a)
         for n, a in pages.items()}
    return j, t, pt


@pytest.mark.parametrize("kind", KINDS)
def test_plain_k9_k10_packed_match_jax_interpret(kind):
    """Beside the XLA comparison: the JAX block-table kernels over packed
    pages in interpret mode (page size 256, the JAX kernels' floor)."""
    rng = np.random.default_rng(7)
    j, t, pt = _packed_kernel_pages(kind, rng)
    q = rng.standard_normal((2, 2, 128)).astype(np.float32)
    posn = np.array([300, 520], np.int32)
    want = jax_flash_decode_paged(jnp.asarray(q), j["pk"], j["pks"], j["pv"], j["pvs"],
                                  jnp.int32(0), jnp.asarray(posn), jnp.asarray(pt),
                                  sm_scale=0.1, interpret=True)
    got = fd.flash_decode_paged(torch.from_numpy(q), t["pk"], t["pks"], t["pv"], t["pvs"], 0,
                                torch.from_numpy(posn), torch.from_numpy(pt), 0.1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-2, atol=3e-2)
    C = 8
    qc = rng.standard_normal((2, C, 2, 128)).astype(np.float32)
    starts = np.array([248, 512], np.int32)  # one chunk straddles a page edge
    want = jax_flash_chunk_paged(jnp.asarray(qc), j["pk"], j["pks"], j["pv"], j["pvs"],
                                 jnp.int32(0), jnp.asarray(starts), jnp.asarray(pt),
                                 sm_scale=0.1, interpret=True)
    got = fd.flash_chunk_paged(torch.from_numpy(qc), t["pk"], t["pks"], t["pv"], t["pvs"], 0,
                               torch.from_numpy(starts), torch.from_numpy(pt), 0.1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-2, atol=3e-2)


def test_format_checks_on_packed_operands():
    """The operand checks take int8 and packed int4 payloads with bf16
    scales and raise on anything else."""
    L, X, nKV, n, dh = 1, 2, 2, 8, 128
    sc = torch.zeros(L, X, nKV, n, dtype=torch.bfloat16)
    i8 = torch.zeros(L, X, nKV, n, dh, dtype=torch.int8)
    i4 = torch.zeros(L, X, nKV, n // 2, dh, dtype=torch.int8)
    ok = {(i8, i8): (fd.KV_I8, fd.KV_I8), (i4, i4): (fd.KV_I4, fd.KV_I4),
          (i8, i4): (fd.KV_I8, fd.KV_I4)}
    for (k, v), want in ok.items():
        assert fd._kv_formats("t", k, sc, v, sc) == want
    odd = torch.zeros(L, X, nKV, 7, dtype=torch.bfloat16)
    bad = [
        (i4, sc, i8, sc),  # packed K with unpacked V
        (i4[..., :3, :].contiguous(), sc, i4, sc),  # neither n nor n / 2 rows
        (torch.zeros(L, X, nKV, 3, dh, dtype=torch.int8), odd,
         torch.zeros(L, X, nKV, 3, dh, dtype=torch.int8), odd),  # odd page size, packed
        (i4, sc.float(), i4, sc.float()),  # fp32 scales
        (i4.float(), sc, i4.float(), sc),  # not int8
    ]
    for args in bad:
        with pytest.raises(ValueError):
            fd._kv_formats("t", *args)
