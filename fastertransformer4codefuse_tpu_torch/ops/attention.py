"""Prefill attention and masks (port of ops/attention.py).

``prefill_attention`` dispatches as the JAX one does, minus its TPU gate: a
CUDA tensor with the prompt lengths goes to K5 ``prefill_attention_flash``
(CUDA in ``csrc/prefill_flash.cu``: wgmma products, K/V tiles by TMA) at
every S, MHA and GQA alike, where K5 has an instance for the head dim
(``prefill_kernel_takes``: dh 64, 128 or 256, those of the JAX package's
flash kernel); other head dims take the plain masked form on the card too,
as the JAX package takes its XLA path for them, and count in
``prefill_attention.plain_routes``. The JAX package's ``S >=
2048`` switch (``_flash_ok``) was a v5e measurement and is not carried over.
The CPU runs the plain masked form with fp32 scores, which is what the JAX
package runs below S = 2048.
"""
from __future__ import annotations

import torch

from . import _cuda

MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
PREFILL_HEAD_DIMS = (64, 128, 256)  # the dh K5 takes


def prefill_kernel_takes(dh: int) -> bool:
    """Whether K5 has an instance for this head dim."""
    return dh in PREFILL_HEAD_DIMS


def prefill_attention(
    q: torch.Tensor,  # [B, S, nH, dh]
    k: torch.Tensor,  # [B, S, nKV, dh]
    v: torch.Tensor,  # [B, S, nKV, dh]
    mask,  # [B, S, S] bool, True = may attend; None: made from input_lengths
    sm_scale: float,
    input_lengths=None,  # [B] int32: CUDA tensors then run K5
) -> torch.Tensor:
    """Causal prefill attention. A CUDA tensor with ``input_lengths`` runs K5
    (which builds no mask) where it has an instance for the head dim;
    otherwise the plain masked math (counted in ``plain_routes`` on the
    card)."""
    if q.is_cuda and input_lengths is not None:
        if prefill_kernel_takes(q.shape[3]):
            return prefill_attention_flash(q, k, v, input_lengths, sm_scale)
        prefill_attention.plain_routes += 1
    if mask is None:
        mask = make_prefill_mask(input_lengths, q.shape[1])
    B, S, nH, dh = q.shape
    nKV = k.shape[2]
    if nKV != nH:
        # GQA: the g query heads of a KV head contract with it, no repeat copy
        g = nH // nKV
        qg = q.reshape(B, S, nKV, g, dh).float()
        scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * sm_scale
        scores = scores.masked_fill(~mask[:, None, None], MASK_VALUE)
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype).float(), v.float())
        return out.reshape(B, S, nH, dh).to(q.dtype)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    scores = scores.masked_fill(~mask[:, None], MASK_VALUE)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


prefill_attention.plain_routes = 0


def prefill_attention_flash_plain(q, k, v, input_lengths, sm_scale):
    """K5's plain version: the masked prefill (causal, keys below the row's
    length) with fp32 scores and probabilities rounded to v's dtype. Rows at
    or past a row's length attend its valid prefix, as the kernel's do."""
    return prefill_attention(q, k, v, make_prefill_mask(input_lengths, q.shape[1]), sm_scale)


def prefill_attention_flash(
    q: torch.Tensor,  # [B, S, nH, dh] bf16
    k: torch.Tensor,  # [B, S, nKV, dh] bf16
    v: torch.Tensor,
    input_lengths: torch.Tensor,  # [B] int32
    sm_scale: float,
) -> torch.Tensor:
    """K5: causal flash attention over the prompt, query i of row b bounded
    at min(i, input_lengths[b] - 1). A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel or raises (dh 64, 128 or 256, bf16)."""
    if not q.is_cuda:
        return prefill_attention_flash_plain(q, k, v, input_lengths, sm_scale)
    req = _cuda.require
    req(q.ndim == 4 and k.ndim == 4 and k.shape == v.shape, "prefill_flash: q/k/v [B, S, n, dh]")
    B, S, nH, dh = q.shape
    nKV = k.shape[2]
    req(k.shape[:2] == (B, S) and k.shape[3] == dh, "prefill_flash: k/v shape vs q")
    req(prefill_kernel_takes(dh), f"prefill_flash: dh must be 64, 128 or 256, got {dh}")
    req(nH % nKV == 0, "prefill_flash: nH must be a multiple of nKV")
    req(all(t.dtype == torch.bfloat16 for t in (q, k, v)), "prefill_flash: q/k/v must be bf16")
    req(input_lengths.dtype == torch.int32 and input_lengths.shape == (B,)
        and input_lengths.is_contiguous(), "prefill_flash: input_lengths must be int32 [B]")
    for t in (k, v, input_lengths):
        req(t.device == q.device, "prefill_flash: operands on different devices")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    req(q.data_ptr() % 16 == 0 and k.data_ptr() % 16 == 0 and v.data_ptr() % 16 == 0,
        "prefill_flash: q/k/v must be 16-byte aligned (TMA)")
    out = torch.empty_like(q)
    err = _cuda.lib().ftcf_prefill_flash(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), input_lengths.data_ptr(), out.data_ptr(),
        B, S, nKV, nH // nKV, dh, float(sm_scale), _cuda.stream_of(q),
    )
    _cuda.check(err, "prefill_flash")
    prefill_attention_flash.launches += 1
    return out


prefill_attention_flash.launches = 0


def make_prefill_mask(input_lengths: torch.Tensor, seq_len: int) -> torch.Tensor:
    """Causal & right-padding mask [B, S, S]: token i may attend token j iff
    j <= i and j < input_length."""
    pos = torch.arange(seq_len, device=input_lengths.device)
    causal = pos[None, :, None] >= pos[None, None, :]
    in_len = pos[None, None, :] < input_lengths[:, None, None]
    return causal & in_len


def make_decode_valid(positions: torch.Tensor, cache_len: int) -> torch.Tensor:
    """[B, cache_len] bool: slot j participates iff j <= positions[b] (rows
    are packed contiguously; the new token's slot is written before it is
    attended)."""
    pos = torch.arange(cache_len, device=positions.device)[None, :]
    return pos <= positions[:, None]
