"""Prompt-lookup speculative decoding (port of engine/speculative.py):
multi-token greedy steps, no draft model.

Code-generation outputs repeat their context (identifiers, imports, whole
lines). Prompt lookup drafts the next k tokens by matching the trailing
n-gram against the tokens already in context and copying what followed,
then verifies the whole draft in one chunked forward:

  - propose: the trailing n-gram compared against every window of the token
    buffer at once (n shifted equality vectors AND-ed); the latest match's
    continuation is the draft. A missing match drafts whatever the buffer
    holds there, which verification rejects (that iteration emits one token,
    a plain decode step);
  - verify: [last committed, d1..dk] through ``models.gptneox.prefill_chunk``,
    the chunked program the continuous batcher runs (cache positions
    [p, p + k + 1) written, hidden states for all k + 1 positions), greedy
    argmax at every position;
  - accept: the longest prefix of drafts matching the model's own argmaxes
    commits, plus the model's token at the first mismatch (the bonus), cut at
    the first end id and at the length budget. Every emitted token is the
    greedy token of this chunked program.

Rejected-draft K/V left in the cache sit past the committed length, so the
position mask never reads them before the next chunk rewrites them.

The JAX package runs the loop as one ``lax.while_loop`` on the device (and a
second one for a single row). Here one host loop serves any number of rows:
it enqueues each iteration's device ops and reads back one flag, whether
every row is done: one host sync an iteration. The verify's GEMMs are the main
path's kernels (K13 and K1 at rows x (k + 1) rows); its attention runs over
the dense cache in plain PyTorch, as dense pools' chunk attention does (the
JAX package runs it in XLA). A packed int4 KV cache is refused: chunk writes
at any position would straddle its position-pair bytes.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from ..models import gptneox as model
from ..ops.rotary import make_rotary_tables
from . import kv_cache


def propose_ngram(tokens: np.ndarray, n: int, k: int) -> np.ndarray:
    """Host reference of the device matcher: the (up to) k tokens that
    followed the most recent earlier occurrence of ``tokens[-n:]``."""
    T = len(tokens)
    if T < n + 1:
        return np.empty((0,), np.int32)
    pattern = tokens[T - n:]
    win = np.lib.stride_tricks.sliding_window_view(tokens[: T - 1], n)
    hits = np.nonzero((win == pattern[None, :]).all(axis=1))[0]
    for start in hits[::-1]:
        cont = tokens[start + n: start + n + k]
        if len(cont):
            return cont.astype(np.int32)
    return np.empty((0,), np.int32)


def propose_device(tokens: torch.Tensor, l: torch.Tensor, n: int, k: int):
    """Latest-match prompt lookup for every row at once. tokens [B, S] int32
    with committed prefix [0, l[b]) in row b. Returns (draft [B, k] int32,
    has [B] bool): the k buffer tokens after the latest window that equals
    the trailing n-gram, starts before it and lies inside the prefix; without
    one, the k tokens at n - 1 (harmless: verification rejects them)."""
    B, S = tokens.shape
    dev = tokens.device
    lm = l.long()
    p0 = torch.clamp(lm - n, 0, S - n)
    pattern = tokens.gather(1, p0[:, None] + torch.arange(n, device=dev)[None, :])  # [B, n]
    match = torch.ones((B, S), dtype=torch.bool, device=dev)
    for j in range(n):  # j-shifted equality, AND-ed
        match &= torch.roll(tokens, -j, dims=1) == pattern[:, j: j + 1]
    iota = torch.arange(S, device=dev)
    match &= iota[None, :] < (lm - n)[:, None]
    idx = torch.where(match, iota[None, :], -1).amax(dim=1)  # [B]
    start = torch.clamp(idx + n, 0, S - k)
    draft = tokens.gather(1, start[:, None] + torch.arange(k, device=dev)[None, :])
    return draft, idx >= 0


@dataclasses.dataclass
class SpecStats:
    iterations: int = 0
    drafted: int = 0
    accepted: int = 0
    emitted: int = 0
    cum_log_prob: float = 0.0  # sum of the committed tokens' greedy log-probs

    @property
    def tokens_per_step(self) -> float:
        return self.emitted / max(self.iterations, 1)


@dataclasses.dataclass
class Verify:
    """One verify step's device results, a row each: the draft, whether a
    match drafted it, the accepted count m, the candidates (drafts below m,
    then the bonus), the first end id among the first m + 1 candidates (k + 1
    where none), and the greedy log-prob of every verify position."""

    draft: torch.Tensor  # [B, k]
    has: torch.Tensor  # [B]
    m: torch.Tensor  # [B]
    cand: torch.Tensor  # [B, k + 1]
    first_end: torch.Tensor  # [B]
    lps: torch.Tensor  # [B, k + 1]


def verify_step(cfg, params, tokens, l, cache, active, k: int, ngram: int, rotary_tables,
                fused: bool = True, a8: bool = False, mesh=None) -> Verify:
    """Propose from ``tokens``, run [last committed, draft] through
    ``prefill_chunk`` at position l - 1 (rows with ``active`` False keep
    their cache bytes), and score the draft against the greedy argmaxes.
    Nothing here waits for the device. ``mesh``: the engine's, under tensor
    parallelism (``params`` the rank's slice)."""
    S = tokens.shape[1]
    C = k + 1
    dev = tokens.device
    draft, has = propose_device(tokens, l, ngram, k)
    pos = torch.clamp(l - 1, 0, S - 1)
    last = tokens.gather(1, pos.long()[:, None])
    chunk = torch.cat([last, draft], dim=1)  # [B, C]
    hidden, _ = model.prefill_chunk(cfg, params, chunk, pos, cache, active,
                                    rotary_tables=rotary_tables, fused=fused, a8=a8, mesh=mesh)
    logits = model.lm_logits(cfg, params, hidden, mesh)  # [B, C, V] fp32
    g = torch.argmax(logits, dim=-1).to(torch.int32)  # [B, C]
    # the leading run of matches
    m = torch.cumprod((draft == g[:, :k]).to(torch.int32), dim=1).sum(dim=1, dtype=torch.int32)
    iota = torch.arange(C, device=dev)[None, :]
    ext = torch.cat([draft, draft[:, -1:]], dim=1)
    bonus = g.gather(1, m.long()[:, None])
    cand = torch.where(iota < m[:, None], ext, bonus)
    is_end = (cand == cfg.end_id) & (iota <= m[:, None])
    first_end = torch.where(is_end, iota, C).amin(dim=1).to(torch.int32)
    lps = logits.gather(2, g.long()[..., None])[..., 0] - torch.logsumexp(logits, dim=-1)
    return Verify(draft, has, m, cand, first_end, lps)


def commit(tokens: torch.Tensor, l: torch.Tensor, cand: torch.Tensor, n: torch.Tensor) -> None:
    """Write the first n[b] candidates of row b at l[b] in place (the other
    buffer entries of the window keep their values)."""
    S, C = tokens.shape[1], cand.shape[1]
    iota = torch.arange(C, device=tokens.device)[None, :]
    cols = torch.clamp(l, 0, S - C).long()[:, None] + iota
    old = tokens.gather(1, cols)
    tokens.scatter_(1, cols, torch.where(iota < n[:, None], cand, old))


def _buffer_len(engine, in_len: int, output_len: int, C: int) -> int:
    """The cache and token buffer length, the JAX function's: room for the
    output and one verify chunk past it, bucketed."""
    S = in_len + output_len + C + 1
    bucket = max(engine.runtime.seq_bucket, C)
    return -(-S // bucket) * bucket


def _prefill(engine, ids: torch.Tensor, n: torch.Tensor, cache):
    """The prompts' forward: (first greedy token [B], its log-prob [B])."""
    cfg, params = engine.config, engine.params
    hidden, _ = model.prefill(cfg, params, ids, n, cache, fused=engine.runtime.fused_decode,
                              a8=engine.runtime.act_int8, mesh=engine.mesh)
    logits = model.lm_logits(cfg, params, model.last_token_hidden(hidden, n), engine.mesh)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    lp = logits.gather(1, tok.long()[:, None])[:, 0] - torch.logsumexp(logits, dim=-1)
    return tok, lp


def _setup(engine, prompts: List[List[int]], output_len: int, k: int):
    if engine.pp > 1:
        raise ValueError("speculative decoding runs the whole layer stack on one rank: it is "
                         "not served under pipeline parallelism")
    if engine.packed_kv():
        raise ValueError(
            "speculative decoding writes (k + 1)-token chunks at any position: it needs an "
            "unpacked KV cache (int8 or bf16), not packed int4 position pairs"
        )
    cfg, dev = engine.config, engine.device
    B = len(prompts)
    in_lens = [len(p) for p in prompts]
    S = _buffer_len(engine, max(in_lens), output_len, k + 1)
    cache = kv_cache.init_cache(cfg, B, S, engine._cache_dtype(), dev,
                                kv_heads=engine.kv_heads[1])
    ids = np.full((B, S), cfg.end_id, np.int32)
    for b, p in enumerate(prompts):
        ids[b, : len(p)] = p
    ids = torch.from_numpy(ids).to(dev)
    n = torch.tensor(in_lens, dtype=torch.int32, device=dev)
    rot = make_rotary_tables(S, cfg.rotary_embedding_dim, cfg.rotary_base, dev)
    return ids, n, cache, rot


def _truncate_at_end(out: List[int], in_len: int, end_id: int) -> List[int]:
    for i in range(in_len, len(out)):
        if out[i] == end_id:
            return out[: i + 1]
    return out


def speculative_generate_batched(
    engine,
    prompts: List[List[int]],
    output_len: int,
    k: int = 8,
    ngram: int = 3,
) -> tuple[List[List[int]], List[SpecStats]]:
    """Batched greedy generation with per-row prompt-lookup speculation.

    Returns (each row's tokens, prompt included; each row's SpecStats). A
    row's tokens are those it gets alone; the loop runs until the slowest
    row finishes (finished rows ride along, their cache bytes kept and their
    commits 0), so the iteration count is shared. One host sync an
    iteration: the stop check."""
    cfg = engine.config
    if output_len <= 0:
        return [list(p) for p in prompts], [SpecStats() for _ in prompts]
    C, end_id = k + 1, cfg.end_id
    tokens, n, cache, rot = _setup(engine, prompts, output_len, k)
    B = len(prompts)
    first, first_lp = _prefill(engine, tokens, n, cache)
    rows = torch.arange(B, device=tokens.device)
    tokens[rows, n.long()] = first
    l = n + 1
    stop_at = n + output_len
    done = (first == end_id) | (l >= stop_at)
    acc = torch.zeros(B, dtype=torch.int32, device=tokens.device)
    drf = torch.zeros_like(acc)
    lp = torch.zeros(B, dtype=torch.float32, device=tokens.device)
    it = 0
    iota = torch.arange(C, device=tokens.device)[None, :]
    while not bool(done.all()):  # the iteration's one sync
        v = verify_step(cfg, engine.params, tokens, l, cache, ~done, k, ngram, rot,
                        engine.runtime.fused_decode, engine.runtime.act_int8, engine.mesh)
        n_commit = torch.minimum(torch.minimum(v.m, v.first_end) + 1, stop_at - l)
        n_commit = torch.where(done, 0, n_commit)
        commit(tokens, l, v.cand, n_commit)
        lp += torch.where(iota < n_commit[:, None], v.lps, 0.0).sum(dim=1)
        acc += torch.where(done, 0, v.m)
        drf += torch.where(~done & v.has, k, 0).to(torch.int32)
        l = l + n_commit
        done = done | (v.first_end < C) | (l >= stop_at)
        it += 1
    tokens_h, l_h = tokens.cpu().numpy(), l.cpu().numpy()
    acc_h, drf_h = acc.cpu().numpy(), drf.cpu().numpy()
    lp_h, first_lp_h = lp.cpu().numpy(), first_lp.float().cpu().numpy()
    outs, stats = [], []
    for b, p in enumerate(prompts):
        out = _truncate_at_end([int(t) for t in tokens_h[b, : int(l_h[b])]], len(p), end_id)
        outs.append(out)
        stats.append(SpecStats(
            iterations=1 + it, drafted=int(drf_h[b]), accepted=int(acc_h[b]),
            emitted=len(out) - len(p), cum_log_prob=float(first_lp_h[b]) + float(lp_h[b]),
        ))
    return outs, stats


def speculative_generate(
    engine,
    prompt: List[int],
    output_len: int,
    k: int = 8,
    ngram: int = 3,
) -> tuple[List[int], SpecStats]:
    """Greedy generation with prompt-lookup speculation (B = 1): the batched
    loop on one row. Returns (the token sequence, prompt included;
    SpecStats); the prompt's prefill counts as the first iteration."""
    outs, stats = speculative_generate_batched(engine, [prompt], output_len, k, ngram)
    return outs[0], stats[0]
