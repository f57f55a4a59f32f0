"""Decode and chunk attention kernels over the KV cache (port of
ops/flash_decode.py).

- K4 ``flash_decode_stacked`` (CUDA in ``csrc/flash_decode.cu``): one query
  token per row attends the dense cache slots ``[0, positions[b]]`` of its
  row; GQA takes g = nH / nKV query heads per KV head. The cache is the
  stacked ``[L, B, nKV, S, dh]`` slab (int8 with ``[L, B, nKV, S]`` bf16
  scales, or bf16 without); ``k_all[layer]`` is a free view.
- K9 ``flash_decode_paged`` (the same CUDA kernel body, positions addressed
  through a block table): the same math over the paged pool
  ``[L, P, nKV, ps, dh]``, logical position s of row b at
  ``page_table[b, s // ps]``, offset ``s % ps``.
- K10 ``flash_chunk_paged`` (``csrc/flash_chunk.cu``): C consecutive
  queries per row starting at ``pos[b]`` over the paged pool; query c
  attends keys ``0 .. pos[b] + c``.

Each ``*_plain`` function is the plain version: the CPU path and the
kernel's oracle. A CPU tensor takes it; a CUDA tensor launches the kernel or
raises.
"""
from __future__ import annotations

import torch

from . import _cuda
from .attention import MASK_VALUE, make_decode_valid


def flash_decode_stacked_plain(q, k_all, ks_all, v_all, vs_all, layer, positions, sm_scale):
    """Full-softmax form of the kernel's math (the JAX attend_decode): fp32
    scores times the key scales, (probabilities times the value scales)
    rounded to q's dtype, fp32 PV."""
    B, nH, dh = q.shape
    k, v = k_all[layer], v_all[layer]  # [B, nKV, S, dh]
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
    k_all: torch.Tensor,  # [L, B, nKV, S, dh] int8 or bf16
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
    req(k_all.ndim == 5 and k_all.shape == v_all.shape, "flash_decode: k/v slabs [L, B, nKV, S, dh]")
    L, B2, nKV, S, dh2 = k_all.shape
    req((B2, dh2) == (B, dh) and 0 <= int(layer) < L, "flash_decode: cache shape vs q / layer")
    req(dh in (128, 256), f"flash_decode: dh must be 128 or 256, got {dh}")
    req(nH % nKV == 0 and nH // nKV <= 8, "flash_decode: nH must be nKV * g with g <= 8")
    req((vs_all is not None) == quant, "flash_decode: both or neither scale slab")
    want = torch.int8 if quant else torch.bfloat16
    req(k_all.dtype == want and v_all.dtype == want, f"flash_decode: cache must be {want}")
    req(k_all.is_contiguous() and v_all.is_contiguous(), "flash_decode: cache must be contiguous")
    if quant:
        req(ks_all.dtype == torch.bfloat16 and vs_all.dtype == torch.bfloat16
            and ks_all.shape == (L, B, nKV, S) and vs_all.shape == (L, B, nKV, S)
            and ks_all.is_contiguous() and vs_all.is_contiguous(),
            "flash_decode: scales must be contiguous bf16 [L, B, nKV, S]")
    req(positions.dtype == torch.int32 and positions.shape == (B,)
        and positions.is_contiguous(), "flash_decode: positions must be int32 [B]")
    for t in (k_all, v_all, ks_all, vs_all, positions):
        req(t is None or t.device == q.device, "flash_decode: operands on different devices")
    layer = int(layer)
    out = torch.empty_like(q)
    err = _cuda.lib().ftcf_flash_decode(
        q.data_ptr(), k_all[layer].data_ptr(),
        ks_all[layer].data_ptr() if quant else None,
        v_all[layer].data_ptr(), vs_all[layer].data_ptr() if quant else None,
        positions.data_ptr(), out.data_ptr(), B, nKV, nH // nKV, S, dh, int(quant),
        float(sm_scale), _cuda.stream_of(q),
    )
    _cuda.check(err, "flash_decode")
    flash_decode_stacked.launches += 1
    return out


flash_decode_stacked.launches = 0


def gather_pages(slab_l: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """A layer's page slab ``[P, nKV, ps(, dh)]`` read through ``page_table``
    ``[B, n_pg]`` as the dense ``[B, nKV, n_pg * ps(, dh)]`` view."""
    B, n_pg = page_table.shape
    g = slab_l[page_table.reshape(-1).long()]  # [B * n_pg, nKV, ps(, dh)]
    g = g.reshape((B, n_pg) + tuple(slab_l.shape[1:])).transpose(1, 2)
    return g.reshape((B, slab_l.shape[1], n_pg * slab_l.shape[2]) + tuple(slab_l.shape[3:]))


def flash_decode_paged_plain(q, pk, pks, pv, pvs, layer, positions, page_table, sm_scale):
    """K4's plain math over the pages gathered into a dense view."""
    def dense(slab):
        return None if slab is None else gather_pages(slab[layer], page_table)[None]

    return flash_decode_stacked_plain(
        q, dense(pk), dense(pks), dense(pv), dense(pvs), 0, positions, sm_scale
    )


def _check_pages(name, q_dtype, pk, pks, pv, pvs, page_table, rows, dh, nH):
    """Shape, type, contiguity and device checks shared by K9 and K10."""
    req = _cuda.require
    quant = pks is not None
    req(q_dtype == torch.bfloat16, f"{name}: q must be bf16")
    req(pk.ndim == 5 and pk.shape == pv.shape, f"{name}: pages [L, P, nKV, ps, dh]")
    L, P, nKV, ps, dh2 = pk.shape
    req(dh2 == dh and dh in (128, 256), f"{name}: dh must be 128 or 256 and match q")
    req(nH % nKV == 0, f"{name}: nH must be a multiple of nKV")
    req((pvs is not None) == quant, f"{name}: both or neither scale slab")
    want = torch.int8 if quant else torch.bfloat16
    req(pk.dtype == want and pv.dtype == want, f"{name}: pages must be {want}")
    req(pk.is_contiguous() and pv.is_contiguous(), f"{name}: pages must be contiguous")
    if quant:
        req(pks.dtype == torch.bfloat16 and pvs.dtype == torch.bfloat16
            and pks.shape == (L, P, nKV, ps) and pvs.shape == (L, P, nKV, ps)
            and pks.is_contiguous() and pvs.is_contiguous(),
            f"{name}: scales must be contiguous bf16 [L, P, nKV, ps]")
    req(page_table.dtype == torch.int32 and page_table.ndim == 2
        and page_table.shape[0] == rows and page_table.is_contiguous(),
        f"{name}: page table must be contiguous int32 [B, n_pg]")
    return L, nKV, ps, quant


def flash_decode_paged(
    q: torch.Tensor,  # [B, nH, dh] bf16
    pk: torch.Tensor,  # [L, P, nKV, ps, dh] int8 or bf16 page pool
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
    L, nKV, ps, quant = _check_pages("flash_decode_paged", q.dtype, pk, pks, pv, pvs,
                                     page_table, B, dh, nH)
    req(nH // nKV <= 8, "flash_decode_paged: g = nH / nKV must be <= 8")
    req(0 <= int(layer) < L, "flash_decode_paged: layer out of range")
    req(positions.dtype == torch.int32 and positions.shape == (B,)
        and positions.is_contiguous(), "flash_decode_paged: positions must be int32 [B]")
    for t in (pk, pv, pks, pvs, positions, page_table):
        req(t is None or t.device == q.device, "flash_decode_paged: operands on different devices")
    layer = int(layer)
    out = torch.empty_like(q)
    err = _cuda.lib().ftcf_flash_decode_paged(
        q.data_ptr(), pk[layer].data_ptr(), pks[layer].data_ptr() if quant else None,
        pv[layer].data_ptr(), pvs[layer].data_ptr() if quant else None,
        positions.data_ptr(), page_table.data_ptr(), out.data_ptr(), B, nKV, nH // nKV,
        page_table.shape[1], ps, dh, int(quant), float(sm_scale), _cuda.stream_of(q),
    )
    _cuda.check(err, "flash_decode_paged")
    flash_decode_paged.launches += 1
    return out


flash_decode_paged.launches = 0


def flash_chunk_paged_plain(q, pk, pks, pv, pvs, layer, pos, page_table, sm_scale):
    """Full-softmax form of K10's math (the JAX _kernel in chunk mode): fp32
    scores times the key scales and sm_scale, query c of row b bounded at
    ``pos[b] + c``, (probabilities times the value scales) rounded to q's
    dtype, fp32 PV; the C queries and the gq heads of a KV head share its
    keys."""
    B, C, nH, dh = q.shape
    k = gather_pages(pk[layer], page_table)  # [B, nKV, S, dh]
    v = gather_pages(pv[layer], page_table)
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
    pk: torch.Tensor,  # [L, P, nKV, ps, dh] int8 or bf16
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
    L, nKV, ps, quant = _check_pages("flash_chunk_paged", q.dtype, pk, pks, pv, pvs,
                                     page_table, B, dh, nH)
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
        page_table.shape[1], ps, dh, int(quant), float(sm_scale), _cuda.stream_of(q),
    )
    _cuda.check(err, "flash_chunk_paged")
    flash_chunk_paged.launches += 1
    return out


flash_chunk_paged.launches = 0
