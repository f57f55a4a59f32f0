"""Batched top-k / top-p token selection (port of sampling/sample.py).

Semantics of the reference's top-k -> top-p chain: restrict to the k highest
logits (k = 0: no restriction), then to the smallest prefix of those whose
mass reaches p (p = 0: no restriction); k = 0 and p = 0 is greedy. The draw
is Gumbel-max over the masked logits, which samples the renormalized
truncated distribution. The Gumbel noise is an argument: the engine draws it
from one ``torch.Generator`` per request row (``gumbel_noise``), and a test
can feed the JAX package's noise to compare token for token.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from .processors import NEG_INF


def top_k_stable(x: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of each row, equal values
    in index order (``jax.lax.top_k``'s ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class SampleResult(NamedTuple):
    tokens: torch.Tensor  # [BB] int32
    log_probs: torch.Tensor  # [BB] fp32, under the full processed distribution
    # (zeros when need_log_probs is False)


def gumbel_noise(generators: Sequence[torch.Generator], n: int, device) -> torch.Tensor:
    """[len(generators), n] standard Gumbel noise, row b from generator b."""
    u = torch.stack([torch.rand(n, generator=g, device=device) for g in generators])
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(u.clamp_(min=tiny)))


def _chosen_log_probs(logits, tokens, need):
    if not need:
        return torch.zeros(logits.shape[0], dtype=torch.float32, device=logits.device)
    lp = torch.log_softmax(logits, dim=-1)
    return lp.gather(1, tokens.long()[:, None])[:, 0]


def top_k_top_p_filter(logits: torch.Tensor, top_k: torch.Tensor, top_p: torch.Tensor):
    """Logits outside each row's top-k / top-p set replaced by NEG_INF."""
    BB, V = logits.shape
    k = top_k.long()
    p = top_p.float()
    k = torch.where((k <= 0) & (p <= 0.0), torch.ones_like(k), k).clamp(max=V)
    # the JAX package's rank order: a stable ascending argsort reversed, so
    # among equal logits the higher id ranks first
    order = torch.argsort(logits, dim=-1, stable=True).flip(-1)
    sorted_logits = logits.gather(1, order)
    ranks = torch.empty_like(order).scatter_(
        1, order, torch.arange(V, device=logits.device).expand(BB, V)
    )
    keep_k = torch.where(k[:, None] > 0, ranks < k[:, None], torch.ones_like(ranks, dtype=torch.bool))
    col = torch.arange(V, device=logits.device)[None, :]
    limit = torch.where(k > 0, k, V)[:, None]
    kept_sorted = torch.where(col < limit, sorted_logits, torch.full_like(sorted_logits, NEG_INF))
    probs_sorted = torch.softmax(kept_sorted, dim=-1)
    cum = torch.cumsum(probs_sorted, dim=-1)
    keep_sorted_p = (cum - probs_sorted) < p[:, None]
    keep_sorted_p[:, 0] = True
    keep_p = torch.gather(keep_sorted_p, 1, ranks)
    keep_p = torch.where(p[:, None] > 0.0, keep_p, torch.ones_like(keep_p))
    return torch.where(keep_k & keep_p, logits, torch.full_like(logits, NEG_INF))


def sample_top_k_top_p(logits, top_k, top_p, gumbel, need_log_probs: bool = True) -> SampleResult:
    """Full-sort path for any per-row k (0 = off) and p. ``gumbel`` [BB, V]."""
    masked = top_k_top_p_filter(logits, top_k, top_p)
    tokens = torch.argmax(masked + gumbel, dim=-1).to(torch.int32)
    return SampleResult(tokens, _chosen_log_probs(logits, tokens, need_log_probs))


def top_k_top_p_filter_capped(logits, top_k, top_p, cap: int):
    """(masked top-``cap`` logits [BB, cap], their ids) for rows with
    0 < top_k <= cap. Equal logits keep the lower id first, the order of the
    JAX path's ``lax.top_k`` (``torch.topk`` leaves the order of ties
    unspecified)."""
    cap = min(cap, logits.shape[1])
    vals, idxs = top_k_stable(logits, cap)
    ranks = torch.arange(cap, device=logits.device)[None, :]
    kept = torch.where(ranks < top_k.long()[:, None], vals, torch.full_like(vals, NEG_INF))
    probs = torch.softmax(kept, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_p = (cum - probs) < top_p.float()[:, None]
    keep_p[:, 0] = True
    keep_p = torch.where(top_p.float()[:, None] > 0.0, keep_p, torch.ones_like(keep_p))
    return torch.where(keep_p, kept, torch.full_like(kept, NEG_INF)), idxs, vals


def sample_top_k_top_p_capped(logits, top_k, top_p, gumbel, cap: int = 128,
                              need_log_probs: bool = True) -> SampleResult:
    """Capped path, same semantics as the full sort for k <= cap.
    ``gumbel`` [BB, min(cap, V)]."""
    masked, idxs, vals = top_k_top_p_filter_capped(logits, top_k, top_p, cap)
    pick = torch.argmax(masked + gumbel, dim=-1)
    tokens = idxs.gather(1, pick[:, None])[:, 0].to(torch.int32)
    if not need_log_probs:
        return SampleResult(tokens, torch.zeros_like(logits[:, 0]))
    lse = torch.logsumexp(logits, dim=-1)
    return SampleResult(tokens, vals.gather(1, pick[:, None])[:, 0] - lse)


def sample_greedy(logits: torch.Tensor, need_log_probs: bool = True) -> SampleResult:
    """argmax: no sort, no noise."""
    tokens = torch.argmax(logits, dim=-1).to(torch.int32)
    return SampleResult(tokens, _chosen_log_probs(logits, tokens, need_log_probs))
