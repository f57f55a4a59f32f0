"""Paged KV cache: page-pool slabs and per-slot block tables (port of
engine/paged_kv.py).

  - ``pk``/``pv``: ``[L, P, nKV, ps, dh]`` page-pool slabs (P pages of ps
    positions, every layer per page id); ``pk_s``/``pv_s`` ``[L, P, nKV, ps]``
    bf16 per-vector scales when the pages are int8 or packed.
  - packed int4 pages: ``"int4"`` gives ``pk4``/``pv4``, ``"int8k_int4v"``
    ``pk`` (int8) and ``pv4``, ``[L, P, nKV, ps/2, dh]`` int8 with positions
    2i and 2i + 1 of a page in byte row i (2i in the low nibble, the dense
    cache's order); the scales stay per unpacked position and ps is even.
  - ``pt``: ``[B, n_pg]`` int32 block table: slot b's logical positions
    ``[j*ps, (j+1)*ps)`` live in physical page ``pt[b, j]``.
  - page 0 is the garbage page: never allocated, the write target of rows
    that must not disturb readable state (skipped decode rows, inactive
    chunk rows).

Writes are in place (one index_put per slab: the pool never copies a slab)
and each write function also returns the cache. Int8 and int4 codes and
scales are the dense cache's (``ops.flash_decode.quantize_vec`` and
``write_pair_byte``), bit for bit the JAX package's; ``packed4`` and
``slab`` serve the dense cache's slabs as well as the pages. Packed pages
are safe where the dense pool's packed slabs are not: chunk starts are
multiples of an even prompt bucket, and decode writes read-modify-write the
pair byte per row. Decode attention over the pool is
K9, chunk attention K10 (``ops/flash_decode.py``).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from ..core.config import GptNeoXConfig
from ..core.device import resolve_device
from ..ops.flash_decode import gather_pages, pack_seq_pairs, quantize_vec, write_pair_byte

Cache = Dict[str, torch.Tensor]

PACKED_KINDS = ("int4", "int8k_int4v")


def is_paged(cache: Cache) -> bool:
    return "pt" in cache


def quantized(cache: Cache) -> bool:
    return "pk_s" in cache


def packed4(cache: Cache, which: str) -> bool:
    """True when slab ``which`` ("k"/"v" of a dense cache, "pk"/"pv" of
    pages) is stored nibble-packed."""
    return f"{which}4" in cache


def slab(cache: Cache, which: str) -> torch.Tensor:
    """The K or V slab ``which`` (as in ``packed4``), packed or not."""
    return cache.get(which + "4", cache.get(which))


def page_size(cache: Cache) -> int:
    """Positions per page: the scale slab carries the unpacked size."""
    if quantized(cache):
        return cache["pk_s"].shape[3]
    return cache["pk"].shape[3]


def num_pages(cache: Cache) -> int:
    return slab(cache, "pk").shape[1]


def logical_seq_len(cache: Cache) -> int:
    return cache["pt"].shape[1] * page_size(cache)


def init_paged_cache(
    config: GptNeoXConfig,
    num_slots: int,
    max_seq_len: int,
    n_pages: int,
    page_size: int = 256,
    dtype=torch.bfloat16,
    device=None,
    kv_heads: Optional[int] = None,
) -> Cache:
    """Zeroed pages on ``device`` (the CUDA card when None): bf16, fp32, int8
    with bf16 per-vector scales, or the packed kinds ``"int4"`` /
    ``"int8k_int4v"`` (even page size); block tables all pointing at page 0.
    ``kv_heads``: the heads a page holds (a tensor-parallel rank's); default
    all of the config's."""
    if isinstance(dtype, str) and dtype not in PACKED_KINDS:
        raise ValueError(f"unknown paged-cache dtype string {dtype!r}")
    if dtype in PACKED_KINDS and page_size % 2:
        raise ValueError(f"packed int4 pages pair positions: page_size {page_size} must be even")
    if max_seq_len % page_size:
        raise ValueError(f"max_seq_len {max_seq_len} is not a multiple of page_size {page_size}")
    if n_pages < 2:
        raise ValueError("need at least the garbage page and one real page")
    device = resolve_device(device)
    shape = (config.layer_num, n_pages, kv_heads or config.kv_heads, page_size,
             config.size_per_head)
    if dtype in PACKED_KINDS:
        pshape = shape[:3] + (page_size // 2, shape[4])
        c = {
            "pk_s": torch.zeros(shape[:-1], dtype=torch.bfloat16, device=device),
            "pv_s": torch.zeros(shape[:-1], dtype=torch.bfloat16, device=device),
            "pv4": torch.zeros(pshape, dtype=torch.int8, device=device),
        }
        if dtype == "int4":
            c["pk4"] = torch.zeros(pshape, dtype=torch.int8, device=device)
        else:
            c["pk"] = torch.zeros(shape, dtype=torch.int8, device=device)
    elif dtype == torch.int8:
        c = {
            "pk": torch.zeros(shape, dtype=torch.int8, device=device),
            "pv": torch.zeros(shape, dtype=torch.int8, device=device),
            "pk_s": torch.zeros(shape[:-1], dtype=torch.bfloat16, device=device),
            "pv_s": torch.zeros(shape[:-1], dtype=torch.bfloat16, device=device),
        }
    else:
        c = {
            "pk": torch.zeros(shape, dtype=dtype, device=device),
            "pv": torch.zeros(shape, dtype=dtype, device=device),
        }
    c["pt"] = torch.zeros((num_slots, max_seq_len // page_size), dtype=torch.int32, device=device)
    return c


class PageAllocator:
    """Host-side free list over page ids [1, P) (page 0 = garbage page)."""

    def __init__(self, n_pages: int):
        self.n_pages = n_pages
        self._free: List[int] = list(range(n_pages - 1, 0, -1))

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def pages_needed(self, capacity: int, ps: int) -> int:
        return -(-capacity // ps)

    def can(self, n: int) -> bool:
        return len(self._free) >= n

    def alloc(self, n: int) -> List[int]:
        if not self.can(n):
            raise RuntimeError(f"allocator exhausted: want {n}, free {len(self._free)}")
        return [self._free.pop() for _ in range(n)]

    def release(self, pages: List[int]) -> None:
        self._free.extend(pages)


def _write(cache: Cache, layer: int, name: str, t: torch.Tensor, pages, offs) -> None:
    """cache[name][layer][pages, :, offs] = t (quantized per vector for int8
    pages). ``pages``/``offs`` broadcast to t's leading axes."""
    if quantized(cache):
        q, s = quantize_vec(t)
        cache[name][layer][pages, :, offs] = q
        cache[name + "_s"][layer][pages, :, offs] = s
    else:
        cache[name][layer][pages, :, offs] = t.to(cache[name].dtype)


def write_decode_paged(
    cache: Cache, layer: int, k: torch.Tensor, v: torch.Tensor, positions: torch.Tensor,
    skip=None,
) -> Cache:
    """Write one token per row (k, v: [B, 1, nKV, dh]) at logical position
    ``positions[b]``: physical page ``pt[b, pos // ps]``, offset ``pos % ps``.
    ``skip`` rows write the garbage page instead; packed pages
    read-modify-write the position-pair byte."""
    ps = page_size(cache)
    pos = positions.long()
    rows = torch.arange(pos.shape[0], device=pos.device)
    pages = cache["pt"][rows, pos // ps].long()
    if skip is not None:
        pages = torch.where(skip, torch.zeros_like(pages), pages)
    offs = pos % ps
    for name, t in (("pk", k[:, 0]), ("pv", v[:, 0])):
        if packed4(cache, name):
            write_pair_byte(cache[name + "4"][layer], cache[name + "_s"][layer], pages, offs, t)
        else:
            _write(cache, layer, name, t, pages, offs)
    return cache


def write_chunk_paged(
    cache: Cache, layer: int, k: torch.Tensor, v: torch.Tensor, pos: torch.Tensor,
    active: torch.Tensor,
) -> Cache:
    """Write a C-token chunk per row (k, v: [B, C, nKV, dh]) at per-row chunk
    starts ``pos`` (multiples of C). ps % C == 0 keeps a chunk within one
    page; inactive rows write the garbage page. Packed pages take whole
    position pairs: C must be even."""
    ps = page_size(cache)
    B, C = k.shape[0], k.shape[1]
    if ps % C:
        raise ValueError(
            f"prompt_bucket ({C}) must divide page_size ({ps}) so chunk writes stay "
            "within one page"
        )
    p = pos.long()
    rows = torch.arange(B, device=p.device)
    pages = cache["pt"][rows, p // ps].long()
    pages = torch.where(active, pages, torch.zeros_like(pages))[:, None]  # [B, 1]
    offs = (p % ps)[:, None] + torch.arange(C, device=p.device)[None, :]  # [B, C]
    for name, t in (("pk", k), ("pv", v)):
        if not packed4(cache, name):
            _write(cache, layer, name, t, pages, offs)
            continue
        if C % 2:
            raise ValueError(f"packed int4 pages need an even prompt_bucket, got {C}")
        q, s = quantize_vec(t, 7.0)  # [B, C, nKV(, dh)]
        cache[name + "4"][layer][pages, :, offs[:, ::2] // 2] = pack_seq_pairs(q, 1)
        cache[name + "_s"][layer][pages, :, offs] = s
    return cache


def gather_layer_dense(cache: Cache, layer: int) -> Cache:
    """Layer ``layer`` as a dense per-layer view {"k": [B, nKV, S, dh], "v",
    and "k_s"/"v_s" [B, nKV, S] for quantized pages}, each slot's pages
    gathered through its block table (a copy); packed pages come out
    unpacked to int8."""
    names = {"pk": "k", "pk4": "k", "pv": "v", "pv4": "v", "pk_s": "k_s", "pv_s": "v_s"}
    return {
        names[n]: gather_pages(cache[n][layer], cache["pt"], n.endswith("4"))
        for n in names if n in cache
    }
