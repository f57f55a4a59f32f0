"""Mixture-of-Experts FFN: top-k routing and capacity-bucketed expert
products (port of ops/moe.py).

The JAX function's steps, one for one:
  - router: fp32 logits and softmax over E experts, top-k, the k weights
    renormalized (Mixtral's norm_topk_prob);
  - rows marked invalid (padding, idle pool slots) take the null expert id
    E, which sorts past every bucket and holds no capacity;
  - capacity: each expert's bucket holds C = min(max(ceil(T k / E *
    factor), 1), T k) slots; an assignment beyond it is dropped;
  - dispatch: the T k (token, choice) slots stably sorted by expert id,
    each expert reading a contiguous [C, H] bucket;
  - one batched product a projection over all experts ([E, C, H] @ [E, H,
    I]: ``torch.bmm``; the JAX package computes these as einsums outside any
    Pallas kernel);
  - combine: each token's kept slots weighted by the router, renormalized
    over the experts that survived the capacity cut.

The combine does not scatter-add as the JAX function does (``.at[].add``):
on CUDA ``index_add_`` on floats uses atomics, whose order, and so the last
bits, change from run to run, which would break greedy determinism. Every
token owns exactly k (token, choice) slots, so the port gathers each slot's
expert output into [T, k, H] and sums over k in a fixed order.

Expert parallelism (``expert_offset``): the weights hold experts [offset,
offset + E_local) of the router's E. Routing, capacity (from the global T
and E) and the combine's weights are computed over all E on every rank; the
rank runs only its experts' buckets and returns its partial sum, the tokens'
outputs from its experts weighted as in the full sum, which the layer's FFN
all-reduce completes (the JAX package shards the E axis of the same
einsums over tp, sharding.py:58-60).

The products run in the activations' dtype (bf16 on the card) with fp32
sums, as the JAX einsums do (``preferred_element_type=float32``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .linear import apply_act


def moe_ffn(
    x2d: torch.Tensor,  # [T, H]
    router_w: torch.Tensor,  # [H, E]
    egate_w: Optional[torch.Tensor],  # [E, H, I], or None for ungated experts
    eup_w: torch.Tensor,  # [E, H, I]
    edown_w: torch.Tensor,  # [E, I, H]
    top_k: int,
    capacity_factor: float,
    act: str = "silu",
    valid: Optional[torch.Tensor] = None,  # [T] bool: False rows route nowhere (output 0)
    expert_offset: int = 0,  # the router's id of eup_w's first expert
) -> torch.Tensor:
    """The MoE FFN of ``x2d``: [T, H] in x's dtype (this rank's partial sum
    when the weights hold a slice of the experts)."""
    T, H = x2d.shape
    E = router_w.shape[-1]
    El, lo = eup_w.shape[0], expert_offset
    k = top_k
    dev = x2d.device

    probs = torch.softmax(x2d.float() @ router_w.float(), dim=-1)  # [T, E]
    w, idx = torch.topk(probs, k, dim=-1)  # [T, k]
    w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)
    if valid is not None:
        idx = torch.where(valid[:, None], idx, torch.full_like(idx, E))

    C = int(math.ceil(T * k / E * capacity_factor))
    C = min(max(C, 1), T * k)

    # ---- sort-based dispatch
    e_of = idx.reshape(T * k)  # expert of each (token, choice) slot
    order = torch.argsort(e_of, stable=True)  # slots grouped by expert
    counts = torch.bincount(e_of, minlength=E + 1)[:E]  # the null id E counts nowhere
    starts = torch.cumsum(counts, 0) - counts
    slot_c = torch.arange(C, device=dev)[None, :]
    take = torch.clamp(starts[lo:lo + El, None] + slot_c, 0, T * k - 1)  # [El, C]
    flat_slot = order[take]  # [El, C] index into (token, choice) space
    kept = slot_c < counts[lo:lo + El, None]  # [El, C]
    tok_of_slot = flat_slot // k
    xe = x2d[tok_of_slot.reshape(-1)].reshape(El, C, H)
    xe = torch.where(kept[..., None], xe, torch.zeros_like(xe))

    # ---- batched expert FFN
    dt = x2d.dtype
    up = torch.bmm(xe, eup_w.to(dt)).float()
    if egate_w is not None:
        g = torch.bmm(xe, egate_w.to(dt)).float()
        h = apply_act(g, act).to(dt) * up.to(dt)
    else:
        h = apply_act(up, act).to(dt)
    ye = torch.bmm(h, edown_w.to(dt)).float()  # [El, C, H]

    # ---- combine in token order: slot (t, j) sits at bucket row rank[t, j]
    # of its expert, kept if that expert's bucket reached it
    pos_in_order = torch.empty_like(order)
    pos_in_order[order] = torch.arange(T * k, device=dev)
    e_safe = torch.clamp(e_of, max=E - 1)
    rank = pos_in_order - starts[e_safe]
    slot_kept = (e_of < E) & (rank < C)
    here = slot_kept & (e_of >= lo) & (e_of < lo + El)  # kept by this rank's experts
    row = torch.where(here, (e_safe - lo) * C + rank, torch.zeros_like(rank))
    out = ye.reshape(El * C, H)[row].reshape(T, k, H)
    out = torch.where(here.reshape(T, k, 1), out, torch.zeros_like(out))
    kept_w = torch.where(slot_kept, w.reshape(T * k), torch.zeros_like(w.reshape(T * k)))
    kept_w = kept_w.reshape(T, k)
    y = (out * kept_w[..., None]).sum(dim=1)
    denom = kept_w.sum(dim=1)
    y = y / torch.clamp(denom, min=1e-9)[:, None]
    return y.to(x2d.dtype)
