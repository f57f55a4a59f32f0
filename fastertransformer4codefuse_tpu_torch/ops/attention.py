"""Prefill attention and masks (port of ops/attention.py).

``prefill_attention`` dispatches as the JAX one does, minus its TPU gate: a
CUDA tensor with the prompt lengths goes to K5 ``prefill_attention_flash``
at every S, MHA and GQA alike, where K5 has an instance for the head dim
(``prefill_kernel_takes``: dh 64, 128 or 256, those of the JAX package's
flash kernel); other head dims take the plain masked form on the card too,
as the JAX package takes its XLA path for them, and count in
``prefill_attention.plain_routes``. The JAX package's ``S >=
2048`` switch (``_flash_ok``) was a v5e measurement and is not carried over.
The CPU runs the plain masked form with fp32 scores, which is what the JAX
package runs below S = 2048.

K5 on the card is ``PrefillFlash``, a ``torch.autograd.Function``, as the
library kernel is a ``jax.custom_vjp``: bf16 operands run
``csrc/prefill_flash.cu`` (wgmma products, K/V tiles by TMA; serving, no
gradient); fp32 operands run ``csrc/prefill_flash_f32.cu``, which also
keeps each row's log-sum-exp, and their gradient runs the two backward
kernels of ``csrc/prefill_flash_bwd.cu`` (``prefill_flash_bwd_dkv``,
``prefill_flash_bwd_dq``), with delta = rowsum(dO * O) a plain reduction
between, as the library computes ``di`` outside its kernels. A gradient of
non-fp32 operands raises: every gradient of the repo is fp32.
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


def _require_operands(q, k, v, input_lengths, dtypes, what):
    """The shape, dtype and device checks K5's kernels share."""
    req = _cuda.require
    req(q.ndim == 4 and k.ndim == 4 and k.shape == v.shape, f"{what}: q/k/v [B, S, n, dh]")
    B, S, nH, dh = q.shape
    nKV = k.shape[2]
    req(k.shape[:2] == (B, S) and k.shape[3] == dh, f"{what}: k/v shape vs q")
    req(prefill_kernel_takes(dh), f"{what}: dh must be 64, 128 or 256, got {dh}")
    req(nH % nKV == 0, f"{what}: nH must be a multiple of nKV")
    req(q.dtype in dtypes and k.dtype == q.dtype and v.dtype == q.dtype,
        f"{what}: q/k/v must be one of {dtypes}, got {q.dtype}, {k.dtype}, {v.dtype}")
    req(input_lengths.dtype == torch.int32 and input_lengths.shape == (B,)
        and input_lengths.is_contiguous(), f"{what}: input_lengths must be int32 [B]")
    for t in (k, v, input_lengths):
        req(t.device == q.device, f"{what}: operands on different devices")


def _aligned(what, *ts):
    ts = tuple(t.contiguous() for t in ts)
    _cuda.require(all(t.data_ptr() % 16 == 0 for t in ts),
                  f"{what}: operands must be 16-byte aligned")
    return ts


def prefill_flash_forward(q, k, v, input_lengths, sm_scale):
    """K5's forward launch on the card, checked operands: (out, lse [B, nH, S]
    fp32), or (out, None) for bf16. No gradient: ``PrefillFlash`` wraps it."""
    _require_operands(q, k, v, input_lengths, (torch.bfloat16, torch.float32), "prefill_flash")
    B, S, nH, dh = q.shape
    nKV = k.shape[2]
    q, k, v = _aligned("prefill_flash", q, k, v)
    out = torch.empty_like(q)
    if q.dtype == torch.bfloat16:
        lse = None
        err = _cuda.lib().ftcf_prefill_flash(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), input_lengths.data_ptr(), out.data_ptr(),
            B, S, nKV, nH // nKV, dh, float(sm_scale), _cuda.stream_of(q),
        )
    else:
        lse = torch.empty(B, nH, S, dtype=torch.float32, device=q.device)
        err = _cuda.lib().ftcf_prefill_flash_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), input_lengths.data_ptr(), out.data_ptr(),
            lse.data_ptr(), B, S, nKV, nH // nKV, dh, float(sm_scale), _cuda.stream_of(q),
        )
    _cuda.check(err, "prefill_flash")
    prefill_attention_flash.launches += 1
    if lse is not None:
        prefill_attention_flash.launches_f32 += 1
    return out, lse


class PrefillFlash(torch.autograd.Function):
    """K5 on the card with its gradient: the forward is the bf16 kernel, or
    the fp32 one with each row's log-sum-exp saved; the backward (fp32) is
    the dK/dV and dQ kernels over delta = rowsum(dO * O)."""

    @staticmethod
    def forward(ctx, q, k, v, input_lengths, sm_scale):
        out, lse = prefill_flash_forward(q, k, v, input_lengths, sm_scale)
        if lse is not None:
            ctx.save_for_backward(q, k, v, out, lse, input_lengths)
        ctx.sm_scale = sm_scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, input_lengths = ctx.saved_tensors
        dout = dout.contiguous()
        delta = (dout * out).sum(-1).transpose(1, 2).contiguous()  # [B, nH, S]
        dk, dv = prefill_flash_bwd_dkv(q, k, v, dout, lse, delta, input_lengths, ctx.sm_scale)
        dq = prefill_flash_bwd_dq(q, k, v, dout, lse, delta, input_lengths, ctx.sm_scale)
        return dq, dk, dv, None, None


def prefill_attention_flash(
    q: torch.Tensor,  # [B, S, nH, dh] bf16 or fp32
    k: torch.Tensor,  # [B, S, nKV, dh]
    v: torch.Tensor,
    input_lengths: torch.Tensor,  # [B] int32
    sm_scale: float,
) -> torch.Tensor:
    """K5: causal flash attention over the prompt, query i of row b bounded
    at min(i, input_lengths[b] - 1). A CPU tensor takes the plain version
    (differentiated by autograd); a CUDA tensor runs ``PrefillFlash`` or
    raises (dh 64, 128 or 256; bf16 or fp32; a gradient in fp32 only)."""
    if not q.is_cuda:
        return prefill_attention_flash_plain(q, k, v, input_lengths, sm_scale)
    _cuda.require(
        q.dtype == torch.float32 or not torch.is_grad_enabled()
        or not any(t.requires_grad for t in (q, k, v)),
        "prefill_flash: K5's backward runs in fp32 only (no bf16 instance: no path of the "
        "repo takes a bf16 gradient)")
    return PrefillFlash.apply(q, k, v, input_lengths, float(sm_scale))


prefill_attention_flash.launches = 0  # bf16 and fp32
prefill_attention_flash.launches_f32 = 0  # the fp32 instances alone


def _plain_scores(q, k, input_lengths, sm_scale, einsum=torch.einsum):
    """Masked fp32 scores [B, nKV, g, S, S] (g query heads a KV head)."""
    B, S, nH, dh = q.shape
    nKV = k.shape[2]
    qg = q.float().reshape(B, S, nKV, nH // nKV, dh)
    s = einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * sm_scale
    mask = make_prefill_mask(input_lengths, S)
    return s.masked_fill(~mask[:, None, None], MASK_VALUE)


def prefill_flash_lse_plain(q, k, input_lengths, sm_scale):
    """The fp32 forward's log-sum-exp [B, nH, S] of the masked scores."""
    B, S, nH, _ = q.shape
    return torch.logsumexp(_plain_scores(q, k, input_lengths, sm_scale), -1).reshape(B, nH, S)


def prefill_flash_bwd_plain(q, k, v, dout, lse, delta, input_lengths, sm_scale,
                            einsum=torch.einsum):
    """The backward kernels' plain version, from the same operands: P =
    exp(scores - lse) (0 where masked), dS = P * (dO V^T - delta); returns
    (dq, dk, dv) in fp32, dk and dv summed over a KV head's query heads.
    ``einsum`` computes its five products (a model of another product's
    rounding can stand in for it)."""
    B, S, nH, dh = q.shape
    nKV = k.shape[2]
    g = nH // nKV
    qg = q.float().reshape(B, S, nKV, g, dh)
    dog = dout.float().reshape(B, S, nKV, g, dh)
    p = torch.exp(_plain_scores(q, k, input_lengths, sm_scale, einsum)
                  - lse.float().reshape(B, nKV, g, S)[..., None])
    dp = einsum("bqhgd,bkhd->bhgqk", dog, v.float())
    ds = p * (dp - delta.float().reshape(B, nKV, g, S)[..., None])
    dv = einsum("bhgqk,bqhgd->bkhd", p, dog)
    dk = einsum("bhgqk,bqhgd->bkhd", ds, qg) * sm_scale
    dq = einsum("bhgqk,bkhd->bqhgd", ds, k.float()).reshape(B, S, nH, dh) * sm_scale
    return dq, dk, dv


def _require_backward(q, k, v, dout, lse, delta, input_lengths, what):
    _require_operands(q, k, v, input_lengths, (torch.float32,), what)
    B, S, nH, _ = q.shape
    _cuda.require(dout.shape == q.shape and dout.dtype == torch.float32,
                  f"{what}: dout must be fp32 like q")
    for t in (lse, delta):
        _cuda.require(t.shape == (B, nH, S) and t.dtype == torch.float32,
                      f"{what}: lse and delta must be fp32 [B, nH, S]")
    for t in (dout, lse, delta):
        _cuda.require(t.device == q.device, f"{what}: operands on different devices")


def prefill_flash_bwd_dkv(q, k, v, dout, lse, delta, input_lengths, sm_scale):
    """K5's backward, dK and dV [B, S, nKV, dh] fp32: the kernel on a CUDA
    tensor (or raises), the plain version on a CPU one."""
    if not q.is_cuda:
        return prefill_flash_bwd_plain(q, k, v, dout, lse, delta, input_lengths, sm_scale)[1:]
    _require_backward(q, k, v, dout, lse, delta, input_lengths, "prefill_flash_bwd_dkv")
    B, S, nH, dh = q.shape
    nKV = k.shape[2]
    q, k, v, dout, lse, delta = _aligned("prefill_flash_bwd_dkv", q, k, v, dout, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = _cuda.lib().ftcf_prefill_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), input_lengths.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B, S, nKV, nH // nKV, dh, float(sm_scale), _cuda.stream_of(q),
    )
    _cuda.check(err, "prefill_flash_bwd_dkv")
    prefill_flash_bwd_dkv.launches += 1
    return dk, dv


prefill_flash_bwd_dkv.launches = 0


def prefill_flash_bwd_dq(q, k, v, dout, lse, delta, input_lengths, sm_scale):
    """K5's backward, dQ [B, S, nH, dh] fp32: the kernel on a CUDA tensor (or
    raises), the plain version on a CPU one."""
    if not q.is_cuda:
        return prefill_flash_bwd_plain(q, k, v, dout, lse, delta, input_lengths, sm_scale)[0]
    _require_backward(q, k, v, dout, lse, delta, input_lengths, "prefill_flash_bwd_dq")
    B, S, nH, dh = q.shape
    nKV = k.shape[2]
    q, k, v, dout, lse, delta = _aligned("prefill_flash_bwd_dq", q, k, v, dout, lse, delta)
    dq = torch.empty_like(q)
    err = _cuda.lib().ftcf_prefill_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), input_lengths.data_ptr(), dq.data_ptr(),
        B, S, nKV, nH // nKV, dh, float(sm_scale), _cuda.stream_of(q),
    )
    _cuda.check(err, "prefill_flash_bwd_dq")
    prefill_flash_bwd_dq.launches += 1
    return dq


prefill_flash_bwd_dq.launches = 0


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
