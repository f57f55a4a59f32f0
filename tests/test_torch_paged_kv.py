"""The port's paged KV pool (fastertransformer4codefuse_tpu_torch/engine/paged_kv.py)
and the plain versions of K9 / K10 (ops/flash_decode.py) against the JAX
package, on the cases of tests/test_paged_kv.py.

Tolerances: page writes (int8 codes, bf16 scales, fp32 values) equal bit for
bit; plain K9 / K10 against the JAX Pallas kernels in interpret mode (fp32
compute there) within 1e-5 on fp32 pages and int8 pages read in fp32 (online
vs full softmax order only); the dense-view attention paths within 1e-5."""
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
)
from fastertransformer4codefuse_tpu_torch.core.config import GptNeoXConfig
from fastertransformer4codefuse_tpu_torch.engine import kv_cache as kvc
from fastertransformer4codefuse_tpu_torch.engine import paged_kv as paged
from fastertransformer4codefuse_tpu_torch.ops.flash_decode import (
    flash_chunk_paged,
    flash_decode_paged,
)

torch.set_num_threads(2)

JCFG = JaxConfig.tiny(head_num=4, size_per_head=16, layer_num=2)
CFG = GptNeoXConfig(**dataclasses.asdict(JCFG))
PS = 8  # page size (tiny for tests)
B, NPG = 3, 4  # slots, pages per slot
S = PS * NPG
DTYPES = {"fp32": (jnp.float32, torch.float32), "int8": (jnp.int8, torch.int8)}


def _bits(a):
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy() if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _assert_same(jc, tc, names=None):
    for n in names or [n for n in jc if n != "pt"]:
        np.testing.assert_array_equal(_bits(jc[n]), _bits(tc[n]), err_msg=n)


def _pair_caches(dtype, rng, n_pages=B * NPG + 3):
    """Empty JAX and port pools with the same scrambled block tables."""
    jdt, tdt = DTYPES[dtype]
    jc = jpaged.init_paged_cache(JCFG, B, S, n_pages=n_pages, page_size=PS, dtype=jdt)
    tc = paged.init_paged_cache(CFG, B, S, n_pages, PS, tdt, "cpu")
    pt = rng.permutation(np.arange(1, n_pages))[: B * NPG].reshape(B, NPG).astype(np.int32)
    jc["pt"] = jnp.asarray(pt)
    tc["pt"] = torch.from_numpy(pt)
    return jc, tc


def _kv(rng, *shape):
    a = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


@pytest.mark.parametrize("dtype", ["fp32", "int8"])
def test_paged_write_decode_bit_identical(dtype):
    rng = np.random.default_rng(0)
    jc, tc = _pair_caches(dtype, rng)
    nKV, dh = CFG.kv_heads, CFG.size_per_head
    for layer in range(CFG.layer_num):
        for _ in range(5):
            (jk, tk), (jv, tv) = _kv(rng, B, 1, nKV, dh), _kv(rng, B, 1, nKV, dh)
            posn = rng.integers(0, S, B).astype(np.int32)
            jc = jkvc.write_decode(jc, layer, jk, jv, jnp.asarray(posn))
            kvc.write_decode(tc, layer, tk, tv, torch.from_numpy(posn))
    _assert_same(jc, tc)
    for layer in range(CFG.layer_num):
        jg, tg = jpaged.gather_layer_dense(jc, layer), paged.gather_layer_dense(tc, layer)
        assert set(jg) == set(tg)
        _assert_same(jg, tg)


@pytest.mark.parametrize("dtype", ["fp32", "int8"])
def test_paged_write_decode_skip_lands_in_garbage_page(dtype):
    rng = np.random.default_rng(1)
    jc, tc = _pair_caches(dtype, rng)
    nKV, dh = CFG.kv_heads, CFG.size_per_head
    (jk, tk), (jv, tv) = _kv(rng, B, 1, nKV, dh), _kv(rng, B, 1, nKV, dh)
    posn = np.array([2, 11, 4], np.int32)
    skip = np.array([False, True, False])
    jc = jkvc.write_decode(jc, 0, jk, jv, jnp.asarray(posn), skip=jnp.asarray(skip))
    kvc.write_decode(tc, 0, tk, tv, torch.from_numpy(posn), skip=torch.from_numpy(skip))
    _assert_same(jc, tc)
    row1 = paged.gather_layer_dense(tc, 0)["k"][1]
    assert float(row1.abs().max()) == 0.0  # the skipped row's own pages are untouched
    assert float(tc["pk"][0, 0, :, 11 % PS].float().abs().max()) > 0  # page 0 took it


@pytest.mark.parametrize("dtype", ["fp32", "int8"])
def test_paged_write_chunk_bit_identical(dtype):
    rng = np.random.default_rng(2)
    jc, tc = _pair_caches(dtype, rng)
    nKV, dh = CFG.kv_heads, CFG.size_per_head
    C = PS // 2  # the prompt bucket divides the page size
    for layer in range(CFG.layer_num):
        for start in range(0, S, C):
            (jk, tk), (jv, tv) = _kv(rng, B, C, nKV, dh), _kv(rng, B, C, nKV, dh)
            pos = np.full((B,), start, np.int32)
            # one inactive row: its chunk goes to the garbage page
            active = np.array([True, start < S // 2, True])
            jc = jkvc.write_chunk(jc, layer, jk, jv, jnp.asarray(pos), jnp.asarray(active))
            kvc.write_chunk(tc, layer, tk, tv, torch.from_numpy(pos), torch.from_numpy(active))
        # the garbage page may differ in which inactive write landed last
        for n in [n for n in jc if n != "pt"]:
            np.testing.assert_array_equal(
                _bits(jc[n])[layer, 1:], _bits(tc[n])[layer, 1:], err_msg=n)


def test_paged_write_chunk_rejects_straddling_bucket():
    rng = np.random.default_rng(3)
    _, tc = _pair_caches("fp32", rng)
    k = torch.zeros(B, 3, CFG.kv_heads, CFG.size_per_head)
    with pytest.raises(ValueError, match="page_size"):
        kvc.write_chunk(tc, 0, k, k, torch.zeros(B, dtype=torch.int32), torch.ones(B, dtype=torch.bool))


@pytest.mark.parametrize("dtype", ["fp32", "int8"])
def test_paged_attend_matches_jax_dense_and_paged(dtype):
    """Decode and chunk attention over the pool (plain K9 / the dense view)
    against the JAX package's XLA paths over the same writes."""
    rng = np.random.default_rng(4)
    jc, tc = _pair_caches(dtype, rng)
    nKV, dh = CFG.kv_heads, CFG.size_per_head
    posn = np.array([5, 11, 30], np.int32)
    for layer in range(CFG.layer_num):
        for p in range(int(posn.max()) + 1):
            (jk, tk), (jv, tv) = _kv(rng, B, 1, nKV, dh), _kv(rng, B, 1, nKV, dh)
            pp = np.minimum(posn, p)
            jc = jkvc.write_decode(jc, layer, jk, jv, jnp.asarray(pp))
            kvc.write_decode(tc, layer, tk, tv, torch.from_numpy(pp))
    jq, tq = _kv(rng, B, CFG.head_num, dh)
    valid = np.arange(S)[None, :] <= posn[:, None]
    want = jkvc.attend_decode(jc, 1, jq, jnp.asarray(valid), 0.25, positions=jnp.asarray(posn))
    got = kvc.attend_decode(tc, 1, tq, 0.25, torch.from_numpy(posn))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # the dense-view chunk path (no positions) on two queries a row
    jq2, tq2 = _kv(rng, B, 2, CFG.head_num, dh)
    posc = np.stack([posn - 1, posn], axis=1)
    valid2 = np.arange(S)[None, None, :] <= posc[:, :, None]
    want2 = jkvc.attend_chunk(jc, 1, jq2, jnp.asarray(valid2), 0.25)
    got2 = kvc.attend_chunk(tc, 1, tq2, torch.from_numpy(valid2), 0.25)
    np.testing.assert_allclose(got2.numpy(), np.asarray(want2), rtol=1e-5, atol=1e-5)


def test_dense_attend_chunk_gqa_matches_jax():
    """Dense slabs under GQA (nKV < nH): the query groups fold into the
    query axis as the JAX code folds them."""
    kw = dict(head_num=4, size_per_head=16, layer_num=1, kv_head_num=2, qkv_layout="concat")
    jcfg, cfg = JaxConfig.tiny(**kw), GptNeoXConfig.tiny(**kw)
    rng = np.random.default_rng(5)
    jd = jkvc.init_cache(jcfg, B, S, jnp.float32)
    td = kvc.init_cache(cfg, B, S, torch.float32, "cpu")
    C = PS
    for start in range(0, S // 2, C):
        (jk, tk), (jv, tv) = _kv(rng, B, C, 2, 16), _kv(rng, B, C, 2, 16)
        pos = np.full((B,), start, np.int32)
        act = np.array([True, True, start == 0])
        jd = jkvc.write_chunk(jd, 0, jk, jv, jnp.asarray(pos), jnp.asarray(act))
        kvc.write_chunk(td, 0, tk, tv, torch.from_numpy(pos), torch.from_numpy(act))
    _assert_same(jd, td)
    jq, tq = _kv(rng, B, 2, 4, 16)
    posc = np.array([[3, 4], [9, 10], [14, 15]], np.int32)
    valid = np.arange(S)[None, None, :] <= posc[:, :, None]
    want = jkvc.attend_chunk(jd, 0, jq, jnp.asarray(valid), 0.25)
    got = kvc.attend_chunk(td, 0, tq, torch.from_numpy(valid), 0.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def _kernel_pages(rng, quant, g, ps=256, npg=3, nb=2, nKV=2, dh=128, L=2):
    """Random pages (int8 + scales, or fp32) and a permuted block table at
    the kernels' real widths, as numpy arrays."""
    P = nb * npg + 2
    shape = (L, P, nKV, ps, dh)
    if quant:
        pages = {
            "pk": rng.integers(-127, 128, shape).astype(np.int8),
            "pv": rng.integers(-127, 128, shape).astype(np.int8),
            "pk_s": (rng.random(shape[:-1]) * 0.02).astype(np.float32),
            "pv_s": (rng.random(shape[:-1]) * 0.02).astype(np.float32),
        }
    else:
        pages = {"pk": rng.standard_normal(shape).astype(np.float32),
                 "pv": rng.standard_normal(shape).astype(np.float32)}
    pt = rng.permutation(np.arange(1, P))[: nb * npg].reshape(nb, npg).astype(np.int32)
    return pages, pt, nKV * g


def _both(pages):
    """numpy pages -> (jax, torch) dicts; scales as bf16 on both sides."""
    j, t = {}, {}
    for n, a in pages.items():
        if n.endswith("_s"):
            j[n] = jnp.asarray(a, jnp.bfloat16)
            t[n] = torch.from_numpy(a).to(torch.bfloat16)
        else:
            j[n], t[n] = jnp.asarray(a), torch.from_numpy(a)
    return j, t


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("g", [1, 2])
def test_plain_k9_matches_jax_interpret(quant, g):
    rng = np.random.default_rng(6)
    pages, pt, nH = _kernel_pages(rng, quant, g)
    j, t = _both(pages)
    q = rng.standard_normal((2, nH, 128)).astype(np.float32)
    posn = np.array([300, 520], np.int32)  # ragged, one on a page's last third
    want = jax_flash_decode_paged(
        jnp.asarray(q), j["pk"], j.get("pk_s"), j["pv"], j.get("pv_s"), jnp.int32(1),
        jnp.asarray(posn), jnp.asarray(pt), sm_scale=0.1, interpret=True)
    got = flash_decode_paged(torch.from_numpy(q), t["pk"], t.get("pk_s"), t["pv"], t.get("pv_s"),
                             1, torch.from_numpy(posn), torch.from_numpy(pt), 0.1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("g", [1, 2])
def test_plain_k10_matches_jax_interpret(quant, g):
    rng = np.random.default_rng(7)
    pages, pt, nH = _kernel_pages(rng, quant, g)
    j, t = _both(pages)
    C = 8
    q = rng.standard_normal((2, C, nH, 128)).astype(np.float32)
    starts = np.array([248, 512], np.int32)  # one chunk straddles a page edge
    want = jax_flash_chunk_paged(
        jnp.asarray(q), j["pk"], j.get("pk_s"), j["pv"], j.get("pv_s"), jnp.int32(0),
        jnp.asarray(starts), jnp.asarray(pt), sm_scale=0.1, interpret=True)
    got = flash_chunk_paged(torch.from_numpy(q), t["pk"], t.get("pk_s"), t["pv"], t.get("pv_s"),
                            0, torch.from_numpy(starts), torch.from_numpy(pt), 0.1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_plain_k10_ignores_stale_pages_past_the_chunk():
    """Float pages past the chunk's last query may hold NaN: nothing reads them."""
    rng = np.random.default_rng(8)
    pages, pt, nH = _kernel_pages(rng, False, 1, npg=2)
    _, t = _both(pages)
    q = torch.randn(2, 8, nH, 128, generator=torch.Generator().manual_seed(0))
    starts = torch.tensor([16, 40], dtype=torch.int32)
    clean = flash_chunk_paged(q, t["pk"], None, t["pv"], None, 0, starts, torch.from_numpy(pt), 0.1)
    for b, s in enumerate(starts.tolist()):
        page = pt[b, 0]
        t["pv"][0, page, :, s + 8:] = float("nan")
        t["pk"][0, page, :, s + 8:] = 1e4
    again = flash_chunk_paged(q, t["pk"], None, t["pv"], None, 0, starts, torch.from_numpy(pt), 0.1)
    assert torch.equal(clean, again)


def test_page_allocator():
    al = paged.PageAllocator(10)  # pages 1..9 usable
    assert al.free_pages == 9
    assert al.pages_needed(257, 256) == 2
    a = al.alloc(4)
    assert len(set(a)) == 4 and 0 not in a
    assert not al.can(6)
    al.release(a)
    assert al.can(9) and not al.can(10)
    with pytest.raises(RuntimeError, match="exhausted"):
        al.alloc(10)


def test_paged_cache_layouts_and_unported_kinds():
    c = paged.init_paged_cache(CFG, B, S, 5, PS, torch.int8, "cpu")
    L, nKV, dh = CFG.layer_num, CFG.kv_heads, CFG.size_per_head
    assert c["pk"].shape == (L, 5, nKV, PS, dh) and c["pk"].dtype == torch.int8
    assert c["pk_s"].shape == (L, 5, nKV, PS) and c["pk_s"].dtype == torch.bfloat16
    assert c["pt"].shape == (B, NPG) and c["pt"].dtype == torch.int32
    assert paged.is_paged(c) and paged.quantized(c) and paged.page_size(c) == PS
    assert paged.num_pages(c) == 5 and kvc.seq_len_of(c) == S
    # the packed kinds: payloads of ps/2 pair rows, page size and page count
    # read from the scale slab and whichever K slab exists
    for kind, kname in (("int4", "pk4"), ("int8k_int4v", "pk")):
        c = paged.init_paged_cache(CFG, B, S, 5, PS, kind, "cpu")
        assert c["pv4"].shape == (L, 5, nKV, PS // 2, dh) and c["pv4"].dtype == torch.int8
        assert c[kname].shape[3] == (PS // 2 if kname == "pk4" else PS)
        assert paged.page_size(c) == PS and paged.num_pages(c) == 5 and kvc.seq_len_of(c) == S
        with pytest.raises(ValueError, match="even"):
            paged.init_paged_cache(CFG, B, 7 * 4, 5, 7, kind, "cpu")
    with pytest.raises(ValueError):
        paged.init_paged_cache(CFG, B, S, 5, PS, "int8", "cpu")
