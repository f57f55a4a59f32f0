"""Decode and chunk attention kernels over the KV cache (port of
ops/flash_decode.py).

- K4 ``flash_decode_stacked`` (CUDA in ``csrc/flash_decode.cuh``, entry in
  ``csrc/flash_decode.cu``; K9 and K11 have their own entry files): one query
  token per row attends the dense cache slots ``[0, positions[b]]`` of its
  row; GQA takes g = nH / nKV query heads per KV head (any g, a block
  for each 64 of them), dh 64, 128 or 256. The cache is the stacked ``[L, B, nKV, S, dh]`` slab (int8 with
  ``[L, B, nKV, S]`` bf16 scales, or bf16 without); ``k_all[layer]`` is a
  free view. The kernel splits each row's positions into runs of
  ``decode_split`` positions (split-S) and combines the runs' partials from
  an fp32 workspace (``decode_workspace``) in a fixed order.
- K9 ``flash_decode_paged`` (the same CUDA kernel body, positions addressed
  through a block table): the same math over the paged pool
  ``[L, P, nKV, ps, dh]``, logical position s of row b at
  ``page_table[b, s // ps]``, offset ``s % ps``.
- K10 ``flash_chunk_paged`` (``csrc/flash_chunk.cu``, wgmma + TMA): C
  consecutive queries per row starting at ``pos[b]`` over the paged pool;
  query c attends keys ``0 .. pos[b] + c``. Pages of any size the pool takes.
- K11 ``flash_decode_beam_stacked`` (K4's body, positions addressed through
  the beam indirection): beam-minor rows (row b * bw + j) over the dense
  slab, position s of row b read from row ``b - b % bw + indir[b, s]``.

All four read packed int4 slabs too (the ``"int4"`` and ``"int8k_int4v"``
caches): sequence positions 2i and 2i + 1 share pair row i, position 2i in
the low nibble, so a packed slab has half the positions of its scale slab,
which stays per unpacked position. Packing is told from the shapes, for K and
V apart, as the JAX package tells it; ``launches_packed`` counts the launches
that read a packed slab.

Each ``*_plain`` function is the plain version: the CPU path and the
kernel's oracle. A CPU tensor takes it; a CUDA tensor launches the kernel or
raises.
"""
from __future__ import annotations

import math

import torch

from . import _cuda
from .attention import MASK_VALUE, make_decode_valid

# KV payload formats; csrc/ftcf_common.cuh KVFmt holds the same table
KV_BF16, KV_I8, KV_I4 = 0, 1, 2
# (K, V) format pairs the kernels take: the bf16, int8, "int4" and
# "int8k_int4v" caches
KV_FORMATS = ((KV_BF16, KV_BF16), (KV_I8, KV_I8), (KV_I4, KV_I4), (KV_I8, KV_I4))


def pack_seq_pairs(q: torch.Tensor, dim: int = -2) -> torch.Tensor:
    """int4-valued int8 codes packed two a byte along ``dim`` (the sequence
    axis): byte i = (q[2i+1] << 4) | (q[2i] & 0xF)."""
    d, n = dim % q.ndim, q.shape[dim]
    if n % 2:
        raise ValueError(f"int4 KV packs position pairs: odd length {n}")
    pairs = q.to(torch.int32).unflatten(d, (n // 2, 2))
    return ((pairs.select(d + 1, 1) << 4) | (pairs.select(d + 1, 0) & 0xF)).to(torch.int8)


def unpack_seq_pairs(p: torch.Tensor, dim: int = -2) -> torch.Tensor:
    """Inverse of ``pack_seq_pairs``: [.., n/2, ..] int8 -> [.., n, ..] int8
    with sign-extended nibbles."""
    w = p.to(torch.int32)
    lo = ((w & 0xF) ^ 8) - 8
    hi = w >> 4  # arithmetic shift of the sign-extended byte
    d = dim % p.ndim
    return torch.stack([lo, hi], dim=d + 1).flatten(d, d + 1).to(torch.int8)


def quantize_vec(x: torch.Tensor, qmax: float = 127.0):
    """(codes, scales) of the KV the kernels read: per-vector symmetric int8
    over the last (dh) axis, int4-valued for ``qmax`` 7. The codes come from
    the fp32 scale, which is then stored as bf16; ``round`` is half to even.
    Bit for bit the JAX package's codes."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / qmax, torch.ones_like(amax))
    q = torch.round(xf / scale[..., None]).to(torch.int8)
    return q, scale.to(torch.bfloat16)


def write_pair_byte(packed, scales, idx, pos, t, keep=None) -> None:
    """Write one token per row (t [B, nKV, dh]) as int4 into the packed view
    ``packed`` [X, nKV, n/2, dh] and its ``scales`` [X, nKV, n]: row b goes
    to ``idx[b]`` (a cache row or a page) at position ``pos[b]``. A
    read-modify-write of the position-pair byte: an even position writes the
    whole byte (its odd neighbour is written later), an odd one its high
    nibble over the kept low one. ``keep`` rows write their old bytes back."""
    q, s = quantize_vec(t, 7.0)
    old = packed[idx, :, pos // 2]  # [B, nKV, dh]
    o, qi = old.to(torch.int32), q.to(torch.int32)
    odd = (pos % 2 == 1).reshape(-1, 1, 1)
    new = torch.where(odd, (o & 0x0F) | (qi << 4), qi & 0x0F).to(torch.int8)
    if keep is not None:
        new = torch.where(keep.reshape(-1, 1, 1), old, new)
        s = torch.where(keep.reshape(-1, 1), scales[idx, :, pos], s)
    packed[idx, :, pos // 2] = new
    scales[idx, :, pos] = s


def is_packed(slab: torch.Tensor, scales, axis: int = 3) -> bool:
    """A payload slab is packed int4 when it holds half the positions of its
    scale slab (``axis``: the position axis of both)."""
    return scales is not None and 2 * slab.shape[axis] == scales.shape[axis]


def _kv_formats(name, k, ks, v, vs):
    """(K format, V format) of a ``[L, X, nKV, n, dh]`` K/V slab pair, raising
    on anything the kernels do not take: bf16 without scales; int8 with bf16
    ``[L, X, nKV, n]`` scales, each payload unpacked (n positions) or packed
    int4 (n / 2 pair rows, n even). The kernels read one layer's slab from
    its own pointer, so each layer's slab must be contiguous and the stack
    need not be (a pipeline microbatch's rows, ``parallel.pipeline``)."""
    req = _cuda.require
    req(k.ndim == 5 and v.ndim == 5 and k.shape[:3] == v.shape[:3] and k.shape[4] == v.shape[4],
        f"{name}: k/v slabs [L, X, nKV, n(/2), dh]")
    req(k[0].is_contiguous() and v[0].is_contiguous(), f"{name}: cache must be contiguous")
    req((ks is None) == (vs is None), f"{name}: both or neither scale slab")
    if ks is None:
        req(k.dtype == torch.bfloat16 and v.dtype == torch.bfloat16 and k.shape == v.shape,
            f"{name}: a cache without scales must be bf16")
        return KV_BF16, KV_BF16
    n = ks.shape[-1] if ks.ndim == 4 else -1
    req(ks.dtype == torch.bfloat16 and vs.dtype == torch.bfloat16 and ks.shape == vs.shape
        and ks.shape == k.shape[:3] + (n,) and ks[0].is_contiguous() and vs[0].is_contiguous(),
        f"{name}: scales must be contiguous bf16 [L, X, nKV, n]")
    fmts = []
    for t in (k, v):
        req(t.dtype == torch.int8, f"{name}: a cache with scales must be int8 (or packed int4)")
        req(t.shape[3] == n or (n % 2 == 0 and 2 * t.shape[3] == n),
            f"{name}: payload of {t.shape[3]} rows for {n} positions (packed int4 needs an "
            f"even length and n / 2 pair rows)")
        fmts.append(KV_I4 if t.shape[3] != n else KV_I8)
    req(tuple(fmts) in KV_FORMATS, f"{name}: a packed K needs a packed V")
    return tuple(fmts)


DECODE_HEAD_DIMS = (64, 128, 256)  # the dh K4, K9 and K11 take
CHUNK_HEAD_DIMS = (128, 256)  # the dh K10 takes


def decode_split(dh: int, kfmt: int, vfmt: int) -> int:
    """Positions one split of K4/K9/K11 takes, passed to the kernel: 256,
    or 128 where 256 would hold more than 64 KB of K and V (bf16 at dh 128;
    bf16, int8 and int8k_int4v at dh 256). Short splits keep enough blocks
    in flight at small batches."""
    half_bytes = dh * sum({KV_BF16: 4, KV_I8: 2, KV_I4: 1}[f] for f in (kfmt, vfmt))
    s = 256
    while s > 128 and s * half_bytes > 2 * 65536:
        s //= 2
    return s


def decode_splits(S: int, dh: int, fmt) -> list:
    """The splits of a row of ``S`` positions (its positions up to
    positions[b]) as (start, stop) ranges: fixed runs of ``decode_split``
    positions, the last one cut at S. ``fmt`` is the (K format, V format)
    pair. The plan depends on neither the batch nor the other rows."""
    n = decode_split(dh, *fmt)
    return [(s0, min(s0 + n, S)) for s0 in range(0, S, n)]


def decode_workspace(B, nKV, g, seq_len, dh, kfmt, vfmt, device) -> torch.Tensor:
    """The fp32 workspace of one K4/K9/K11 launch: a record of dh + 4 floats
    (acc, m, l) per (row, KV head, split, query head)."""
    n_split = max(1, -(-seq_len // decode_split(dh, kfmt, vfmt)))
    return torch.empty(B * nKV * n_split * g * (dh + 4), dtype=torch.float32, device=device)


def decode_kernel_takes(dh: int) -> bool:
    """Whether K4/K9/K11 have an instance for this head dim (64, 128 or
    256; any g and KV format). The JAX package's decode kernels take dh 128
    and 256 and send other head dims to XLA."""
    return dh in DECODE_HEAD_DIMS


def chunk_kernel_takes(dh: int) -> bool:
    """Whether K10 has an instance for this head dim (128 or 256, as the
    JAX package's chunk kernel; any page size and format)."""
    return dh in CHUNK_HEAD_DIMS


def _count(fn, kfmt, vfmt) -> None:
    fn.launches += 1
    if KV_I4 in (kfmt, vfmt):
        fn.launches_packed += 1


def flash_decode_stacked_plain(q, k_all, ks_all, v_all, vs_all, layer, positions, sm_scale):
    """Full-softmax form of the kernel's math (the JAX attend_decode): fp32
    scores times the key scales, (probabilities times the value scales)
    rounded to q's dtype, fp32 PV."""
    B, nH, dh = q.shape
    k, v = k_all[layer], v_all[layer]  # [B, nKV, S(/2), dh]
    k = unpack_seq_pairs(k) if is_packed(k_all, ks_all) else k
    v = unpack_seq_pairs(v) if is_packed(v_all, vs_all) else v
    nKV, S = k.shape[1], k.shape[2]
    g = nH // nKV
    qg = q.reshape(B, nKV, g, dh).float()
    scores = torch.einsum("bhgd,bhsd->bhgs", qg, k.float())
    if ks_all is not None:
        scores = scores * ks_all[layer].float()[:, :, None, :]
    scores = scores * sm_scale
    valid = make_decode_valid(positions, S)  # [B, S]
    scores = scores.masked_fill(~valid[:, None, None, :], MASK_VALUE)
    probs = torch.softmax(scores, dim=-1)
    if vs_all is not None:
        probs = probs * vs_all[layer].float()[:, :, None, :]
    pv = probs.to(q.dtype).float()
    # like the kernel, nothing past positions[b] is read: stale slots may hold NaN
    vf = v.float().masked_fill(~valid[:, None, :, None], 0.0)
    out = torch.einsum("bhgs,bhsd->bhgd", pv, vf)
    return out.reshape(B, nH, dh).to(q.dtype)


def flash_decode_stacked(
    q: torch.Tensor,  # [B, nH, dh] bf16
    k_all: torch.Tensor,  # [L, B, nKV, S, dh] int8 or bf16, [L, B, nKV, S/2, dh] packed int4
    ks_all,  # [L, B, nKV, S] bf16 scales, or None for a bf16 cache
    v_all: torch.Tensor,
    vs_all,
    layer: int,
    positions: torch.Tensor,  # [B] int32, newest-token slot (inclusive bound)
    sm_scale: float,
) -> torch.Tensor:
    """K4. A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises."""
    if not q.is_cuda:
        return flash_decode_stacked_plain(
            q, k_all, ks_all, v_all, vs_all, layer, positions, sm_scale
        )
    req = _cuda.require
    B, nH, dh = q.shape
    quant = ks_all is not None
    req(q.dtype == torch.bfloat16 and q.is_contiguous(), "flash_decode: q must be contiguous bf16")
    kfmt, vfmt = _kv_formats("flash_decode", k_all, ks_all, v_all, vs_all)
    L, B2, nKV, _, dh2 = k_all.shape
    S = ks_all.shape[3] if quant else k_all.shape[3]
    req((B2, dh2) == (B, dh) and 0 <= int(layer) < L, "flash_decode: cache shape vs q / layer")
    req(dh in DECODE_HEAD_DIMS, f"flash_decode: dh must be 64, 128 or 256, got {dh}")
    req(nH % nKV == 0, "flash_decode: nH must be a multiple of nKV")
    req(q.data_ptr() % 16 == 0, "flash_decode: q must be 16-byte aligned")
    req(positions.dtype == torch.int32 and positions.shape == (B,)
        and positions.is_contiguous(), "flash_decode: positions must be int32 [B]")
    for t in (k_all, v_all, ks_all, vs_all, positions):
        req(t is None or t.device == q.device, "flash_decode: operands on different devices")
    layer = int(layer)
    g = nH // nKV
    out = torch.empty_like(q)
    ws = decode_workspace(B, nKV, g, S, dh, kfmt, vfmt, q.device)
    err = _cuda.lib().ftcf_flash_decode(
        q.data_ptr(), k_all[layer].data_ptr(),
        ks_all[layer].data_ptr() if quant else None,
        v_all[layer].data_ptr(), vs_all[layer].data_ptr() if quant else None,
        positions.data_ptr(), out.data_ptr(), ws.data_ptr(), ws.numel(),
        decode_split(dh, kfmt, vfmt), B, nKV, g, S, dh, kfmt, vfmt, float(sm_scale),
        _cuda.stream_of(q),
    )
    _cuda.check(err, "flash_decode")
    _count(flash_decode_stacked, kfmt, vfmt)
    return out


flash_decode_stacked.launches = 0
flash_decode_stacked.launches_packed = 0


def gather_beam_rows(slab_l: torch.Tensor, indir: torch.Tensor, bw: int) -> torch.Tensor:
    """A layer's unpacked slab ``[BB, nKV, S(, dh)]`` read through the beam
    indirection ``indir`` ``[BB, S]``: position s of row b comes from row
    ``b - b % bw + indir[b, s]`` (its beam group's physical row)."""
    BB, S = indir.shape
    base = torch.arange(BB, device=indir.device) // bw * bw
    src = base[:, None] + indir.long()  # [BB, S]
    by_pos = slab_l.transpose(1, 2)  # [BB, S, nKV(, dh)]
    return by_pos[src, torch.arange(S, device=indir.device)[None, :]].transpose(1, 2)


def flash_decode_beam_plain(q, k_all, ks_all, v_all, vs_all, layer, positions, indir, bw,
                            sm_scale):
    """K11's math as the physical gather: every slab of the layer (packed ones
    unpacked) resolved through ``indir`` into the dense view each row reads,
    then K4's plain version over it."""
    def resolved(slab, scales=None):
        if slab is None:
            return None
        t = slab[layer]
        if scales is not None and is_packed(slab, scales):
            t = unpack_seq_pairs(t)
        return gather_beam_rows(t, indir, bw)[None]

    return flash_decode_stacked_plain(
        q, resolved(k_all, ks_all), resolved(ks_all), resolved(v_all, vs_all), resolved(vs_all),
        0, positions, sm_scale,
    )


def flash_decode_beam_stacked(
    q: torch.Tensor,  # [BB, nH, dh] bf16, beam-minor rows (row b * bw + j)
    k_all: torch.Tensor,  # [L, BB, nKV, S, dh] int8 or bf16, [L, BB, nKV, S/2, dh] packed int4
    ks_all,  # [L, BB, nKV, S] bf16 scales, or None for a bf16 cache
    v_all: torch.Tensor,
    vs_all,
    layer: int,
    positions: torch.Tensor,  # [BB] int32, newest-token slot per row (inclusive bound)
    indir: torch.Tensor,  # [BB, S] int32 in [0, bw): the cache indirection
    bw: int,
    sm_scale: float,
) -> torch.Tensor:
    """K11: decode attention where position s of row b reads the cached
    vector of row ``b - b % bw + indir[b, s]`` (the reference's cache
    indirection). Every K4 format, dh and g. The indirection is
    trusted, as in the JAX package: its values are never checked on the card.
    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises."""
    if not q.is_cuda:
        return flash_decode_beam_plain(q, k_all, ks_all, v_all, vs_all, layer, positions, indir,
                                       bw, sm_scale)
    req = _cuda.require
    BB, nH, dh = q.shape
    quant = ks_all is not None
    req(q.dtype == torch.bfloat16 and q.is_contiguous(),
        "flash_decode_beam: q must be contiguous bf16")
    kfmt, vfmt = _kv_formats("flash_decode_beam", k_all, ks_all, v_all, vs_all)
    L, B2, nKV, _, dh2 = k_all.shape
    S = ks_all.shape[3] if quant else k_all.shape[3]
    req((B2, dh2) == (BB, dh) and 0 <= int(layer) < L,
        "flash_decode_beam: cache shape vs q / layer")
    req(dh in DECODE_HEAD_DIMS, f"flash_decode_beam: dh must be 64, 128 or 256, got {dh}")
    req(nH % nKV == 0, "flash_decode_beam: nH must be a multiple of nKV")
    req(q.data_ptr() % 16 == 0, "flash_decode_beam: q must be 16-byte aligned")
    req(int(bw) >= 1 and BB % int(bw) == 0, "flash_decode_beam: rows must be groups of bw beams")
    req(positions.dtype == torch.int32 and positions.shape == (BB,)
        and positions.is_contiguous(), "flash_decode_beam: positions must be int32 [BB]")
    req(indir.dtype == torch.int32 and indir.shape == (BB, S) and indir.is_contiguous(),
        "flash_decode_beam: indir must be contiguous int32 [BB, S]")
    for t in (k_all, v_all, ks_all, vs_all, positions, indir):
        req(t is None or t.device == q.device, "flash_decode_beam: operands on different devices")
    layer = int(layer)
    g = nH // nKV
    out = torch.empty_like(q)
    ws = decode_workspace(BB, nKV, g, S, dh, kfmt, vfmt, q.device)
    err = _cuda.lib().ftcf_flash_decode_beam(
        q.data_ptr(), k_all[layer].data_ptr(),
        ks_all[layer].data_ptr() if quant else None,
        v_all[layer].data_ptr(), vs_all[layer].data_ptr() if quant else None,
        positions.data_ptr(), indir.data_ptr(), out.data_ptr(), ws.data_ptr(), ws.numel(),
        decode_split(dh, kfmt, vfmt), BB, nKV, g, S, int(bw), dh, kfmt, vfmt, float(sm_scale),
        _cuda.stream_of(q),
    )
    _cuda.check(err, "flash_decode_beam")
    _count(flash_decode_beam_stacked, kfmt, vfmt)
    return out


flash_decode_beam_stacked.launches = 0
flash_decode_beam_stacked.launches_packed = 0


def gather_pages(slab_l: torch.Tensor, page_table: torch.Tensor, packed: bool = False
                 ) -> torch.Tensor:
    """A layer's page slab ``[P, nKV, ps(, dh)]`` read through ``page_table``
    ``[B, n_pg]`` as the dense ``[B, nKV, n_pg * ps(, dh)]`` view; ``packed``
    pages (``[P, nKV, ps/2, dh]`` pair rows, ps even) come out unpacked."""
    B, n_pg = page_table.shape
    g = slab_l[page_table.reshape(-1).long()]  # [B * n_pg, nKV, ps(, dh)]
    g = g.reshape((B, n_pg) + tuple(slab_l.shape[1:])).transpose(1, 2)
    g = g.reshape((B, slab_l.shape[1], n_pg * slab_l.shape[2]) + tuple(slab_l.shape[3:]))
    return unpack_seq_pairs(g, 2) if packed else g


def flash_decode_paged_plain(q, pk, pks, pv, pvs, layer, positions, page_table, sm_scale):
    """K4's plain math over the pages gathered into a dense view."""
    def dense(slab, scales=None):
        if slab is None:
            return None
        return gather_pages(slab[layer], page_table, is_packed(slab, scales))[None]

    return flash_decode_stacked_plain(
        q, dense(pk, pks), dense(pks), dense(pv, pvs), dense(pvs), 0, positions, sm_scale
    )


def _check_pages(name, q_dtype, pk, pks, pv, pvs, page_table, rows, dh, nH, head_dims):
    """Shape, type, contiguity and device checks shared by K9 and K10 (dh
    one of ``head_dims``); returns (L, nKV, page size, K format, V format).
    Any even page size is taken for packed pages, any page size otherwise."""
    req = _cuda.require
    req(q_dtype == torch.bfloat16, f"{name}: q must be bf16")
    kfmt, vfmt = _kv_formats(name, pk, pks, pv, pvs)
    L, P, nKV, _, dh2 = pk.shape
    ps = pks.shape[3] if pks is not None else pk.shape[3]
    req(dh2 == dh and dh in head_dims, f"{name}: dh must be one of {head_dims} and match q")
    req(nH % nKV == 0, f"{name}: nH must be a multiple of nKV")
    req(page_table.dtype == torch.int32 and page_table.ndim == 2
        and page_table.shape[0] == rows and page_table.is_contiguous(),
        f"{name}: page table must be contiguous int32 [B, n_pg]")
    return L, nKV, ps, kfmt, vfmt


def flash_decode_paged(
    q: torch.Tensor,  # [B, nH, dh] bf16
    pk: torch.Tensor,  # [L, P, nKV, ps, dh] int8 or bf16, [L, P, nKV, ps/2, dh] packed int4
    pks,  # [L, P, nKV, ps] bf16 scales, or None for bf16 pages
    pv: torch.Tensor,
    pvs,
    layer: int,
    positions: torch.Tensor,  # [B] int32 newest-token logical slot (inclusive bound)
    page_table: torch.Tensor,  # [B, n_pg] int32 physical page per logical page
    sm_scale: float,
) -> torch.Tensor:
    """K9. A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises."""
    if not q.is_cuda:
        return flash_decode_paged_plain(q, pk, pks, pv, pvs, layer, positions, page_table,
                                        sm_scale)
    req = _cuda.require
    B, nH, dh = q.shape
    req(q.is_contiguous(), "flash_decode_paged: q must be contiguous")
    L, nKV, ps, kfmt, vfmt = _check_pages("flash_decode_paged", q.dtype, pk, pks, pv, pvs,
                                           page_table, B, dh, nH, DECODE_HEAD_DIMS)
    quant = pks is not None
    req(q.data_ptr() % 16 == 0, "flash_decode_paged: q must be 16-byte aligned")
    req(0 <= int(layer) < L, "flash_decode_paged: layer out of range")
    req(positions.dtype == torch.int32 and positions.shape == (B,)
        and positions.is_contiguous(), "flash_decode_paged: positions must be int32 [B]")
    for t in (pk, pv, pks, pvs, positions, page_table):
        req(t is None or t.device == q.device, "flash_decode_paged: operands on different devices")
    layer = int(layer)
    g, n_pg = nH // nKV, page_table.shape[1]
    out = torch.empty_like(q)
    ws = decode_workspace(B, nKV, g, n_pg * ps, dh, kfmt, vfmt, q.device)
    err = _cuda.lib().ftcf_flash_decode_paged(
        q.data_ptr(), pk[layer].data_ptr(), pks[layer].data_ptr() if quant else None,
        pv[layer].data_ptr(), pvs[layer].data_ptr() if quant else None,
        positions.data_ptr(), page_table.data_ptr(), out.data_ptr(), ws.data_ptr(), ws.numel(),
        decode_split(dh, kfmt, vfmt), B, nKV, g, n_pg, ps, dh, kfmt, vfmt, float(sm_scale),
        _cuda.stream_of(q),
    )
    _cuda.check(err, "flash_decode_paged")
    _count(flash_decode_paged, kfmt, vfmt)
    return out


flash_decode_paged.launches = 0
flash_decode_paged.launches_packed = 0


def chunk_key_tile(dh: int) -> int:
    """Keys a tile of K10 (``csrc/flash_chunk.cu``) holds: 16 KB of bf16 K."""
    return 64 if dh == 128 else 32


def chunk_page_box(ps: int, dh: int) -> int:
    """Keys one TMA box of K10 brings: g = gcd(page size, key tile), so that
    no box crosses a page and a key tile is a whole number of boxes (g / 2
    pair rows of packed int4 pages, whose page size is even)."""
    return math.gcd(ps, chunk_key_tile(dh))


CHUNK_MAX_RANKED = 256  # csrc/flash_chunk.cu FC_MAX_RANKED


def chunk_block_order(pos, C: int, gq: int, n_pg: int, ps: int, dh: int) -> list:
    """The (query tile, row) pairs of one K10 launch in the order its blocks
    take them (each block ranks the pairs in-kernel, from pos on the
    device): the most key tiles first, ties by tile then row; past
    ``CHUNK_MAX_RANKED`` pairs, query tiles descending, rows ascending."""
    R, B, bn = C * gq, len(pos), chunk_key_tile(dh)
    n_rt = -(-R // 128)
    cands = [(t, b) for t in range(n_rt) for b in range(B)]
    if len(cands) > CHUNK_MAX_RANKED:
        return [(n_rt - 1 - i // B, i % B) for i in range(len(cands))]

    def work(tb):  # the pair's key tiles, less one
        t, b = tb
        return min(int(pos[b]) + (min(R, 128 * t + 128) - 1) // gq, n_pg * ps - 1) // bn

    return sorted(cands, key=lambda tb: -work(tb))  # stable: ties keep index order


def flash_chunk_paged_plain(q, pk, pks, pv, pvs, layer, pos, page_table, sm_scale):
    """Full-softmax form of K10's math (the JAX _kernel in chunk mode): fp32
    scores times the key scales and sm_scale, query c of row b bounded at
    ``pos[b] + c``, (probabilities times the value scales) rounded to q's
    dtype, fp32 PV; the C queries and the gq heads of a KV head share its
    keys."""
    B, C, nH, dh = q.shape
    k = gather_pages(pk[layer], page_table, is_packed(pk, pks))  # [B, nKV, S, dh]
    v = gather_pages(pv[layer], page_table, is_packed(pv, pvs))
    nKV, S = k.shape[1], k.shape[2]
    gq = nH // nKV
    qg = q.reshape(B, C, nKV, gq, dh).float()
    scores = torch.einsum("bchgd,bhsd->bhcgs", qg, k.float())
    if pks is not None:
        scores = scores * gather_pages(pks[layer], page_table).float()[:, :, None, None, :]
    scores = scores * sm_scale
    posc = pos.long()[:, None] + torch.arange(C, device=q.device)[None, :]  # [B, C]
    valid = torch.arange(S, device=q.device)[None, None, :] <= posc[:, :, None]  # [B, C, S]
    scores = scores.masked_fill(~valid[:, None, :, None, :], MASK_VALUE)
    probs = torch.softmax(scores, dim=-1)
    if pvs is not None:
        probs = probs * gather_pages(pvs[layer], page_table).float()[:, :, None, None, :]
    pw = probs.to(q.dtype).float()
    # nothing past the chunk's last query is read: stale slots may hold NaN
    keep = torch.arange(S, device=q.device)[None, :] <= posc[:, -1:]  # [B, S]
    vf = v.float().masked_fill(~keep[:, None, :, None], 0.0)
    out = torch.einsum("bhcgs,bhsd->bchgd", pw, vf)
    return out.reshape(B, C, nH, dh).to(q.dtype)


def flash_chunk_paged(
    q: torch.Tensor,  # [B, C, nH, dh] bf16, C consecutive query positions per row
    pk: torch.Tensor,  # [L, P, nKV, ps(/2), dh] int8, packed int4 or bf16
    pks,
    pv: torch.Tensor,
    pvs,
    layer: int,
    pos: torch.Tensor,  # [B] int32 chunk start positions
    page_table: torch.Tensor,  # [B, n_pg] int32
    sm_scale: float,
) -> torch.Tensor:
    """K10. A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises."""
    if not q.is_cuda:
        return flash_chunk_paged_plain(q, pk, pks, pv, pvs, layer, pos, page_table, sm_scale)
    req = _cuda.require
    req(q.ndim == 4 and q.is_contiguous(), "flash_chunk_paged: q must be contiguous [B, C, nH, dh]")
    B, C, nH, dh = q.shape
    L, nKV, ps, kfmt, vfmt = _check_pages("flash_chunk_paged", q.dtype, pk, pks, pv, pvs,
                                           page_table, B, dh, nH, CHUNK_HEAD_DIMS)
    quant = pks is not None
    req(0 <= int(layer) < L, "flash_chunk_paged: layer out of range")
    req(pos.dtype == torch.int32 and pos.shape == (B,) and pos.is_contiguous(),
        "flash_chunk_paged: pos must be int32 [B]")
    for t in (pk, pv, pks, pvs, pos, page_table):
        req(t is None or t.device == q.device, "flash_chunk_paged: operands on different devices")
    layer = int(layer)
    out = torch.empty_like(q)
    err = _cuda.lib().ftcf_flash_chunk_paged(
        q.data_ptr(), pk[layer].data_ptr(), pks[layer].data_ptr() if quant else None,
        pv[layer].data_ptr(), pvs[layer].data_ptr() if quant else None,
        pos.data_ptr(), page_table.data_ptr(), out.data_ptr(), B, C, nKV, nH // nKV,
        page_table.shape[1], ps, dh, kfmt, vfmt, float(sm_scale), _cuda.stream_of(q),
    )
    _cuda.check(err, "flash_chunk_paged")
    _count(flash_chunk_paged, kfmt, vfmt)
    return out


flash_chunk_paged.launches = 0
flash_chunk_paged.launches_packed = 0
