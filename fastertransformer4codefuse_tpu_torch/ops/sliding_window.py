"""K12: banded sliding-window attention (port of ops/sliding_window.py).

Longformer's local attention: query i sees key j iff |i - j| <= w_half
(``causal=True``: i - w_half <= j <= i) and j is below the row's length, the
count of False in ``is_masked`` (right padding, as the JAX kernel assumes).
Rows at or past the length, the padded rows of a right-padded batch, are 0.
The CUDA kernel is K5's TMA + wgmma body (``csrc/prefill_flash.cuh``) under
the ``Band`` policy, entered from ``csrc/sliding_window.cu``: a 128-query
block walks only the 128-key tiles of its band, so its work grows as S
(2 w_half + tile), not S^2. ``sliding_window_attention_plain``
is the same function in plain PyTorch, dense and masked: the CPU path and the
kernel's oracle.
"""
from __future__ import annotations

import torch

from . import _cuda

MASK_VALUE = float(torch.finfo(torch.float32).min)


def _lengths(is_masked: torch.Tensor) -> torch.Tensor:
    return (~is_masked).sum(dim=1, dtype=torch.int32)


def sliding_window_attention_plain(
    q: torch.Tensor,  # [B, S, nH, dh], already scaled by 1/sqrt(dh)
    k: torch.Tensor,  # [B, S, nH, dh]
    v: torch.Tensor,
    w_half: int,
    is_masked: torch.Tensor,  # [B, S] bool, True = padding
    causal: bool = False,
) -> torch.Tensor:
    """The band mask over fp32 scores, softmax, probabilities rounded to v's
    dtype (as the kernel rounds them to bf16), and rows at or past the length
    set to 0. Returns [B, S, nH, dh] in q's dtype."""
    S = q.shape[1]
    lengths = _lengths(is_masked)
    i = torch.arange(S, device=q.device)
    d = i[:, None] - i[None, :]  # query minus key
    band = ((d >= 0) & (d <= w_half)) if causal else d.abs() <= w_half
    allow = band[None] & (i[None, None, :] < lengths[:, None, None])  # [B, S(q), S(k)]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    scores = scores.masked_fill(~allow[:, None], MASK_VALUE)
    probs = torch.softmax(scores, dim=-1).to(v.dtype).float()
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    real = i[None, :] < lengths[:, None]  # [B, S]
    return out.masked_fill(~real[:, :, None, None], 0.0).to(q.dtype)


def sliding_window_attention(
    q: torch.Tensor,  # [B, S, nH, dh] bf16, already scaled by 1/sqrt(dh)
    k: torch.Tensor,  # [B, S, nH, dh] bf16
    v: torch.Tensor,
    w_half: int,
    is_masked: torch.Tensor,  # [B, S] bool, True = padding
    chunk: int = 128,
    causal: bool = False,
) -> torch.Tensor:
    """K12. A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises (bf16, dh 64 or 128). ``chunk`` is accepted only for
    parity with the JAX signature, where it is the Pallas kernel's block of
    queries and keys: it changes nothing here (the CUDA kernel's tiles are
    fixed at 128 queries by 128 keys, and the plain version has no blocks)."""
    w = int(w_half)
    if not q.is_cuda:
        return sliding_window_attention_plain(q, k, v, w, is_masked, causal=causal)
    req = _cuda.require
    req(q.ndim == 4 and k.shape == q.shape and v.shape == q.shape,
        "sliding_window: q/k/v must share one shape [B, S, nH, dh]")
    B, S, nH, dh = q.shape
    req(dh in (64, 128), f"sliding_window: dh must be 64 or 128, got {dh}")
    req(all(t.dtype == torch.bfloat16 for t in (q, k, v)), "sliding_window: q/k/v must be bf16")
    req(is_masked.dtype == torch.bool and is_masked.shape == (B, S),
        "sliding_window: is_masked must be a bool [B, S]")
    req(w >= 0, f"sliding_window: w_half must be >= 0, got {w}")
    req(chunk > 0, f"sliding_window: chunk must be > 0, got {chunk}")
    for t in (k, v, is_masked):
        req(t.device == q.device, "sliding_window: operands on different devices")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    req(all(t.data_ptr() % 16 == 0 for t in (q, k, v)), "sliding_window: q/k/v not 16-byte aligned")
    lengths = _lengths(is_masked)
    out = torch.empty_like(q)
    err = _cuda.lib().ftcf_sliding_window(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        B, S, nH, dh, min(w, S), int(causal), _cuda.stream_of(q),
    )
    _cuda.check(err, "sliding_window")
    sliding_window_attention.launches += 1
    if causal:
        sliding_window_attention.launches_causal += 1
    return out


sliding_window_attention.launches = 0
sliding_window_attention.launches_causal = 0
