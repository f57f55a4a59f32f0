"""KV cache: dense preallocated slabs, bf16/fp32, int8 or nibble-packed int4,
and the paged pool's dispatch (port of engine/kv_cache.py).

The dense cache is a dict of stacked slabs, ``k``/``v`` ``[L, B, nKV, S, dh]``
and, for int8, ``k_s``/``v_s`` ``[L, B, nKV, S]`` bf16 with one symmetric
scale per cached vector. ``"int4"`` packs K and V (keys ``k4``/``v4``,
``[L, B, nKV, S/2, dh]`` int8: sequence positions 2i and 2i + 1 share byte
row i, 2i in the low nibble) and ``"int8k_int4v"`` packs only V (``k`` int8,
``v4``); scales stay per unpacked position, so S must be even. A paged cache
(``engine/paged_kv.py``, a dict with a block table ``pt``) takes the same
write and attend calls, which dispatch to its page writes and to K9/K10.
On the card, a head dim that the attention kernels have no instance for (K10
outside 128 and 256, K4/K9/K11 outside 64, 128 and 256: head dims for which
the JAX package runs no kernel either) goes to the plain version, as the JAX
package sends it to XLA, and counts in the dispatcher's ``plain_routes``.
Unlike the JAX package's functional updates, writes here are in place, so a
pool never copies a slab; each write function also returns the cache for the
same call shape.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..core.config import GptNeoXConfig
from ..core.device import resolve_device
from ..ops.attention import MASK_VALUE
from ..ops.flash_decode import (
    chunk_kernel_takes,
    decode_kernel_takes,
    flash_chunk_paged,
    flash_decode_beam_plain,
    flash_decode_beam_stacked,
    flash_decode_paged,
    flash_decode_paged_plain,
    flash_decode_stacked,
    flash_decode_stacked_plain,
    pack_seq_pairs as _pack_seq_pairs,
    quantize_vec as _quantize_vec,
    unpack_seq_pairs as _unpack_seq_pairs,
    write_pair_byte,
)
from . import paged_kv
from .paged_kv import PACKED_KINDS, packed4, slab

Cache = Dict[str, torch.Tensor]


def init_cache(
    config: GptNeoXConfig, batch: int, max_seq_len: int, dtype=torch.bfloat16, device=None,
    kv_heads: Optional[int] = None, layers: Optional[int] = None,
) -> Cache:
    """Zeroed slabs on ``device`` (the CUDA card when None). ``dtype``: a torch
    dtype, or ``"int4"`` (K and V packed) / ``"int8k_int4v"`` (K int8, V
    packed). ``kv_heads``: the heads a slab holds (a tensor-parallel rank's,
    ``parallel.sharding.cache_heads``); default all of the config's.
    ``layers``: the layers it holds (a pipeline stage's,
    ``parallel.sharding.stage_layers``); default all."""
    device = resolve_device(device)
    shape = (layers or config.layer_num, batch, kv_heads or config.kv_heads, max_seq_len,
             config.size_per_head)
    if isinstance(dtype, str):
        if dtype not in PACKED_KINDS:
            raise ValueError(f"unknown KV cache kind {dtype!r}: a torch dtype, 'int4' or "
                             "'int8k_int4v'")
        if max_seq_len % 2:
            raise ValueError(f"int4 KV packs sequence-position pairs: max_seq_len {max_seq_len} "
                             "must be even")
        pshape = shape[:3] + (max_seq_len // 2, shape[4])
        c = {
            "k_s": torch.zeros(shape[:-1], dtype=torch.bfloat16, device=device),
            "v_s": torch.zeros(shape[:-1], dtype=torch.bfloat16, device=device),
            "v4": torch.zeros(pshape, dtype=torch.int8, device=device),
        }
        if dtype == "int4":
            c["k4"] = torch.zeros(pshape, dtype=torch.int8, device=device)
        else:
            c["k"] = torch.zeros(shape, dtype=torch.int8, device=device)
        return c
    if dtype == torch.int8:
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_s": torch.zeros(shape[:-1], dtype=torch.bfloat16, device=device),
            "v_s": torch.zeros(shape[:-1], dtype=torch.bfloat16, device=device),
        }
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def quantized(cache: Cache) -> bool:
    return "k_s" in cache


def seq_len_of(cache: Cache) -> int:
    """Slots per row: the dense length (from the scale slab when there is
    one: a packed slab holds half as many rows), or the paged pool's logical
    length (pages per slot times the page size)."""
    if paged_kv.is_paged(cache):
        return paged_kv.logical_seq_len(cache)
    if quantized(cache):
        return cache["k_s"].shape[-1]
    return cache["k"].shape[-2]


def write_prefill(cache: Cache, layer: int, k: torch.Tensor, v: torch.Tensor) -> Cache:
    """Write positions [0, S) of layer ``layer`` (k, v: [B, S, nKV, dh]); a
    packed slab takes int4 codes (qmax 7) in position pairs, S even."""
    S = k.shape[1]
    for name, t in (("k", k), ("v", v)):
        t = t.transpose(1, 2)  # [B, nKV, S, dh]
        if packed4(cache, name):
            if S % 2:
                raise ValueError(f"int4 KV prefill width must be even, got {S}")
            q, s = _quantize_vec(t, 7.0)
            cache[name + "4"][layer, :, :, : S // 2] = _pack_seq_pairs(q)
            cache[name + "_s"][layer, :, :, :S] = s
        elif quantized(cache):
            q, s = _quantize_vec(t)
            cache[name][layer, :, :, :S] = q
            cache[name + "_s"][layer, :, :, :S] = s
        else:
            cache[name][layer, :, :, :S] = t.to(cache[name].dtype)
    return cache


def prompt_tables(config: GptNeoXConfig, table: dict, device, heads=None, layers=None) -> dict:
    """Checked prefix tables: ``{task: (kv, length)}`` with kv ``[L, 2,
    kv_heads, P, dh]`` (numpy or torch) and ``length <= P``, as fp32 on
    ``device``; with ``heads`` = (first, count) only those KV heads (a
    tensor-parallel rank's cache heads), with ``layers`` = (first, count)
    only those layers (a pipeline stage's). Raises ValueError on another
    shape."""
    out = {}
    for tid, (kv, length) in table.items():
        kv = kv if torch.is_tensor(kv) else torch.from_numpy(np.asarray(kv, np.float32))
        if not (kv.ndim == 5 and tuple(kv.shape[:3]) == (config.layer_num, 2, config.kv_heads)
                and kv.shape[4] == config.size_per_head and kv.shape[3] >= int(length)):
            raise ValueError(
                f"prompt task {tid}: table of shape {tuple(kv.shape)}, expected "
                f"[{config.layer_num}, 2, {config.kv_heads}, P >= {int(length)}, "
                f"{config.size_per_head}]")
        if heads is not None:
            kv = kv[:, :, heads[0]:heads[0] + heads[1]]
        if layers is not None:
            kv = kv[layers[0]:layers[0] + layers[1]]
        out[tid] = (kv.to(device=device, dtype=torch.float32), int(length))
    return out


def write_prefix(cache: Cache, k_pre: torch.Tensor, v_pre: torch.Tensor, row=None) -> Cache:
    """Write prefix-prompt K/V into slots [0, P) of every layer: k_pre, v_pre
    [L, B, nKV, P, dh] float over the cache's B rows, or with ``row`` one
    row's [L, nKV, P, dh] (a pool slot). As the reference preloads a tuned
    prefix, no rotary is applied; an int8 cache quantizes the prefix per
    vector, as every write does. A row whose prompt is shorter than P leaves
    slots its input then overwrites before they become visible."""
    if paged_kv.is_paged(cache) or packed4(cache, "k") or packed4(cache, "v"):
        raise ValueError(
            "prompt learning requires an unpacked KV cache (int8/bf16): prefix widths are "
            "per-row and may straddle int4 position-pair bytes"
        )
    P = k_pre.shape[-2]
    sel = (slice(None), slice(None) if row is None else row)
    for name, t in (("k", k_pre), ("v", v_pre)):
        if quantized(cache):
            q, sc = _quantize_vec(t)
            cache[name][sel + (slice(None), slice(0, P))] = q
            cache[name + "_s"][sel + (slice(None), slice(0, P))] = sc.to(cache[name + "_s"].dtype)
        else:
            cache[name][sel + (slice(None), slice(0, P))] = t.to(cache[name].dtype)
    return cache


def _put_rows(cache: Cache, layer: int, name: str, t: torch.Tensor, rows, cols, keep=None):
    """cache[name][layer][rows, :, cols] = t, quantized per vector for an int8
    cache; where ``keep`` (broadcast like t's leading axes) is True the old
    bytes are written back instead."""
    pairs = [(name, t)]
    if quantized(cache):
        q, s = _quantize_vec(t)
        pairs = [(name, q), (name + "_s", s)]
    for n, val in pairs:
        slab = cache[n][layer]
        val = val.to(slab.dtype)
        if keep is not None:
            old = slab[rows, :, cols]
            val = torch.where(keep.reshape(keep.shape + (1,) * (val.ndim - keep.ndim)), old, val)
        slab[rows, :, cols] = val


def write_decode(
    cache: Cache, layer: int, k: torch.Tensor, v: torch.Tensor, positions: torch.Tensor,
    skip=None, skip_mode: str = "preserve",
) -> Cache:
    """Write one token per row (k, v: [B, 1, nKV, dh]) at slot positions[b].

    ``skip`` [B] bool marks rows whose write must not disturb readable cache
    state: ``skip_mode="preserve"`` writes their old bytes back;
    ``"sacrifice_last"`` (the continuous batcher) sends them to slot S-1,
    which every owning row rewrites before it becomes attention-valid. A
    paged cache sends skipped rows to its garbage page (skip_mode is moot).
    Packed slabs read-modify-write the position-pair byte."""
    if paged_kv.is_paged(cache):
        return paged_kv.write_decode_paged(cache, layer, k, v, positions, skip)
    if skip_mode not in ("preserve", "sacrifice_last"):
        raise ValueError(f"unknown skip_mode {skip_mode!r}")
    pos = positions.long()
    keep = None
    if skip is not None and skip_mode == "sacrifice_last":
        pos = torch.where(skip, torch.full_like(pos, seq_len_of(cache) - 1), pos)
    elif skip is not None:
        keep = skip
    rows = torch.arange(pos.shape[0], device=pos.device)
    for name, t in (("k", k[:, 0]), ("v", v[:, 0])):
        if packed4(cache, name):
            write_pair_byte(cache[name + "4"][layer], cache[name + "_s"][layer], rows, pos, t,
                            keep)
        else:
            _put_rows(cache, layer, name, t, rows, pos, keep)
    return cache


def write_chunk(
    cache: Cache, layer: int, k: torch.Tensor, v: torch.Tensor, pos: torch.Tensor,
    active: torch.Tensor,
) -> Cache:
    """Write a C-token chunk per row (k, v: [B, C, nKV, dh]) at per-row slot
    offsets ``pos`` [B]; rows with ``active`` False keep their bytes (they may
    be mid-generation while other slots chunk-prefill). A paged cache
    dispatches to its page writes."""
    if paged_kv.is_paged(cache):
        return paged_kv.write_chunk_paged(cache, layer, k, v, pos, active)
    if packed4(cache, "k") or packed4(cache, "v"):
        raise ValueError(
            "chunk writes need an unpacked dense KV cache (int8/bf16): per-row chunk offsets "
            "may straddle int4 position-pair bytes (a paged pool takes packed pages)"
        )
    B, C = k.shape[0], k.shape[1]
    rows = torch.arange(B, device=pos.device)[:, None]
    cols = pos.long()[:, None] + torch.arange(C, device=pos.device)[None, :]  # [B, C]
    keep = (~active)[:, None].expand(B, C)
    _put_rows(cache, layer, "k", k, rows, cols, keep)
    _put_rows(cache, layer, "v", v, rows, cols, keep)
    return cache


def attend_chunk(
    cache: Cache,
    layer: int,
    q: torch.Tensor,  # [B, C, nH, dh]
    valid: torch.Tensor,  # [B, C, S] bool, keys visible to each query
    sm_scale: float,
    positions=None,  # [B] int32 chunk starts: a paged cache then runs K10
) -> torch.Tensor:
    """C-query attention over layer ``layer``: [B, C, nH, dh]. A paged cache
    with ``positions`` goes to K10 where it has an instance for the head dim
    (``chunk_kernel_takes``); otherwise the plain math below (the JAX
    package computes it in XLA), with the g query heads of a KV head folded
    into the query axis as the JAX code folds them."""
    B, C, nH, dh = q.shape
    if paged_kv.is_paged(cache):
        if positions is not None:
            if not q.is_cuda or chunk_kernel_takes(dh):
                return flash_chunk_paged(
                    q.contiguous(), slab(cache, "pk"), cache.get("pk_s"),
                    slab(cache, "pv"), cache.get("pv_s"), layer, positions, cache["pt"],
                    sm_scale,
                )
            attend_chunk.plain_routes += 1
        cache_l = paged_kv.gather_layer_dense(cache, layer)
    else:
        cache_l = _layer_dense(cache, layer)
    nKV = cache_l["k"].shape[1]
    if nH != nKV:
        g = nH // nKV
        qc = q.reshape(B, C, nKV, g, dh).transpose(2, 3).reshape(B, C * g, nKV, dh)
        out = _attend_dense(cache_l, qc, valid.repeat_interleave(g, dim=1), sm_scale)
        return out.reshape(B, C, g, nKV, dh).transpose(2, 3).reshape(B, C, nH, dh)
    return _attend_dense(cache_l, q, valid, sm_scale)


attend_chunk.plain_routes = 0


def _layer_dense(cache: Cache, layer: int) -> Cache:
    """Layer ``layer`` of a dense cache, packed slabs unpacked to int8."""
    out = {}
    for n, t in cache.items():
        if n in ("k4", "v4"):
            out[n[0]] = _unpack_seq_pairs(t[layer])
        else:
            out[n] = t[layer]
    return out


def _attend_dense(cache_l: Cache, q, valid, sm_scale):
    """MHA over one layer's dense view: fp32 scores times the key scales and
    sm_scale, masked softmax, (probabilities times the value scales) rounded
    to q's dtype for an int8 cache or to the cache's dtype otherwise, fp32 PV."""
    scores = torch.einsum("bchd,bhsd->bchs", q.float(), cache_l["k"].float())
    if "k_s" in cache_l:
        scores = scores * cache_l["k_s"].float()[:, None]
    scores = scores * sm_scale
    scores = scores.masked_fill(~valid[:, :, None, :], MASK_VALUE)
    probs = torch.softmax(scores, dim=-1)
    if "v_s" in cache_l:
        pv = (probs * cache_l["v_s"].float()[:, None]).to(q.dtype)
    else:
        pv = probs.to(cache_l["v"].dtype)
    out = torch.einsum("bchs,bhsd->bchd", pv.float(), cache_l["v"].float())
    return out.to(q.dtype)


def attend_decode(
    cache: Cache,
    layer: int,
    q: torch.Tensor,  # [B, nH, dh]
    sm_scale: float,
    positions: torch.Tensor,  # [B] int32
    beam=None,  # (bw, indir [B, S] int32): beam rows read through the cache indirection
) -> torch.Tensor:
    """Single-token attention over layer ``layer`` of the cache: K4 for a
    dense cache, K11 for a dense cache with ``beam``, K9 for a paged one (the
    kernel on CUDA where it has an instance for the head dim,
    ``decode_kernel_takes``; its plain version on the CPU and for other
    head dims). The scales commute out of both contractions: scores = (q . k8)
    * k_s, out = (p * v_s) @ v8. Beam indirection addresses row-contiguous
    slabs: a paged cache refuses it."""
    paged = paged_kv.is_paged(cache)
    k, v = slab(cache, "pk" if paged else "k"), slab(cache, "pv" if paged else "v")
    kernel = not q.is_cuda or decode_kernel_takes(q.shape[2])
    if q.is_cuda and not kernel:
        attend_decode.plain_routes += 1
    if paged:
        if beam is not None:
            raise ValueError("paged pools do not support beam search")
        fn = flash_decode_paged if kernel else flash_decode_paged_plain
        return fn(q, k, cache.get("pk_s"), v, cache.get("pv_s"), layer, positions, cache["pt"],
                  sm_scale)
    if beam is not None:
        bw, indir = beam
        fn = flash_decode_beam_stacked if kernel else flash_decode_beam_plain
        return fn(q, k, cache.get("k_s"), v, cache.get("v_s"), layer, positions, indir, bw,
                  sm_scale)
    fn = flash_decode_stacked if kernel else flash_decode_stacked_plain
    return fn(q, k, cache.get("k_s"), v, cache.get("v_s"), layer, positions, sm_scale)


attend_decode.plain_routes = 0
