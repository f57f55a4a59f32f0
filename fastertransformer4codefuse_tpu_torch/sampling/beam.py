"""Beam search decoding (port of sampling/beam.py).

Per step: the logit processors (optional-last-tokens, bad words,
temperature, repetition penalty, min length), log-softmax, a finished beam
as a single frozen ``end_id`` candidate at log-prob 0, per-beam top-bw, the
diversity penalty on sibling rank, the GNMT length penalty on the ranking
score only, the cross-beam merge per batch, then the reorder of tokens,
lengths, finished flags, scores and the cache indirection by parent, and
stop words.

The KV cache stays fixed: a beam's reassignment moves only its ``[BB, S]``
int32 row of ``beam_indir``, which decode attention resolves (K11). Prompts
are tiled beam-minor (row b * bw + j) before the prefill, prompt-learning
prompts with them; only beam 0 proposes at the first merge.

Ties: ``jax.lax.top_k`` and ``jnp.argsort`` take the lower index first.
``torch.topk`` documents no tie order, so every selection here is a stable
descending sort, sliced (``top_k_stable``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.rotary import make_rotary_tables
from . import processors as proc
from .sample import top_k_stable

NEG_INF = proc.NEG_INF


def _length_penalty_factor(lengths: torch.Tensor, len_penalty: torch.Tensor) -> torch.Tensor:
    """GNMT length normalisation ((5 + len) / 6) ** alpha."""
    base = (5.0 + lengths.float()) / 6.0
    return torch.pow(base, len_penalty.float())


def merge_candidates(log_probs, cum, finished, seq_lens, input_lens, diversity, len_penalty,
                     bw: int, end_id: int):
    """One beam step's selection over ``R = G * bw`` beam-minor rows.

    log_probs [R, V] fp32 (processed, log-softmaxed); cum, diversity,
    len_penalty [R] fp32; finished [R] bool; seq_lens, input_lens [R] int32.
    Returns (src [R] int64: the global parent row of each new hypothesis,
    tok [R] int32, cum [R] fp32: the parent's score plus the token's)."""
    R, V = log_probs.shape
    dev = log_probs.device
    frozen = torch.where(torch.arange(V, device=dev) == end_id, 0.0, NEG_INF)
    log_probs = torch.where(finished[:, None], frozen[None, :], log_probs)
    top_lp, top_id = top_k_stable(log_probs, bw)  # [R, bw]
    cand_cum = cum[:, None] + top_lp
    rank = torch.arange(bw, dtype=torch.float32, device=dev)[None, :]
    cand_score = cand_cum - diversity[:, None] * rank
    new_lens = torch.where(finished, seq_lens, seq_lens + 1)
    cand_score = cand_score / _length_penalty_factor(new_lens - input_lens, len_penalty)[:, None]
    G = R // bw
    _, sel = top_k_stable(cand_score.reshape(G, bw * bw), bw)  # [G, bw]
    new_tok = torch.gather(top_id.reshape(G, bw * bw), 1, sel).reshape(-1).to(torch.int32)
    new_cum = torch.gather(cand_cum.reshape(G, bw * bw), 1, sel).reshape(-1)
    src = (torch.arange(G, device=dev)[:, None] * bw + sel // bw).reshape(-1)
    return src, new_tok, new_cum


def _process_logits(engine, st, inputs, s) -> torch.Tensor:
    """The processors in the engine's order, as the beam layer applies them
    (no presence penalty)."""
    end_id = engine.config.end_id
    logits = s.logits
    T = s.tokens.shape[1]
    if st.use_optional_last:
        logits = proc.apply_optional_last_tokens(
            logits, inputs["optional_last_tokens"], 1, s.gen_step == 0
        )
    if st.use_bad_words:
        logits = proc.ban_bad_words(logits, s.tokens, s.seq_lens, inputs["bad_words"], 1)
    if st.use_temperature:
        logits = proc.apply_temperature(logits, inputs["temperature"])
    if st.use_rep_penalty:
        buf_valid = torch.arange(T, device=logits.device)[None, :] < s.seq_lens[:, None]
        logits = proc.apply_repetition_penalty(
            logits, s.tokens, buf_valid, inputs["repetition_penalty"]
        )
    if st.use_min_length:
        gen_lens = s.seq_lens - inputs["input_lengths"]
        logits = proc.apply_min_length(logits, gen_lens, inputs["min_length"], end_id)
    return logits


def beam_advance(engine, st, inputs, s, bw: int) -> None:
    """Select each batch's next bw hypotheses and reorder the row state by
    parent (in place on ``s``)."""
    end_id = engine.config.end_id
    BB, T = s.tokens.shape
    log_probs = torch.log_softmax(_process_logits(engine, st, inputs, s).float(), dim=-1)
    src, new_tok, new_cum = merge_candidates(
        log_probs, s.cum_log_probs, s.finished, s.seq_lens, inputs["input_lengths"],
        inputs["diversity_rate"], inputs["len_penalty"], bw, end_id,
    )
    rows = torch.arange(BB, device=src.device)
    tokens = s.tokens.index_select(0, src)
    seq_lens = s.seq_lens.index_select(0, src)
    finished = s.finished.index_select(0, src)
    indir = s.beam_indir.index_select(0, src)
    prev_cum = s.cum_log_probs.index_select(0, src)

    tok = torch.where(finished, torch.full_like(new_tok, end_id), new_tok)
    write_idx = seq_lens.clamp(0, T - 1).long()
    tokens[rows, write_idx] = torch.where(finished, tokens[rows, write_idx], tok)
    # the next forward writes row r's new KV into row r itself, at the cache
    # slot = buffer index + the row's prompt length (the prompt's slots are
    # never re-pointed: every beam of a row shares its prompt KV)
    own = (rows % bw).to(torch.int32)
    cache_idx = write_idx
    if st.prompt_width:
        cache_idx = write_idx + inputs["prompt_lengths"].long()
    indir[rows, cache_idx] = torch.where(finished, indir[rows, cache_idx], own)
    seq_lens = seq_lens + (~finished).to(torch.int32)
    cum = torch.where(finished, prev_cum, new_cum)

    newly = tok == end_id
    if st.use_stop_words:
        newly = newly | proc.stop_words_criterion(tokens, seq_lens, inputs["stop_words"], 1)
    if s.step_log_probs is not None:
        # the buffer follows the hypothesis' reorder path, so a returned
        # beam's per-step values sum to its cumulative log-prob
        slp = s.step_log_probs.index_select(0, src)
        slp[:, min(s.gen_step, slp.shape[1] - 1)] = torch.where(
            finished, torch.zeros_like(new_cum), new_cum - prev_cum
        )
        s.step_log_probs = slp
    s.tokens, s.seq_lens, s.cum_log_probs, s.beam_indir = tokens, seq_lens, cum, indir
    s.finished = finished | newly
    s.newest = tok
    s.gen_step += 1


def beam_prefill(engine, st, inputs, bw: int):
    """Prefill the tiled prompts; only beam 0 of each batch proposes at the
    first merge, and every row reads its own prompt KV."""
    s = engine._prefill_state(st, inputs)
    beam_idx = torch.arange(st.batch, device=engine.device) % bw
    s.cum_log_probs = torch.where(beam_idx == 0, 0.0, NEG_INF).to(torch.float32)
    width = st.total_len + st.prompt_width  # the whole cache, prompt slots included
    s.beam_indir = beam_idx.to(torch.int32)[:, None].expand(st.batch, width).contiguous()
    return s


def sort_outputs(inputs, s, B: int, bw: int):
    """Each batch's beams best-first by the length-penalised score (a stable
    sort: ties keep beam order)."""
    factor = _length_penalty_factor(s.seq_lens - inputs["input_lengths"], inputs["len_penalty"])
    score = (s.cum_log_probs / factor).reshape(B, bw)
    order = torch.sort(-score, dim=1, stable=True).indices
    src = (torch.arange(B, device=order.device)[:, None] * bw + order).reshape(-1)
    slp = None if s.step_log_probs is None else s.step_log_probs.index_select(0, src)
    return (s.tokens.index_select(0, src), s.seq_lens.index_select(0, src),
            s.cum_log_probs.index_select(0, src), slp)


def beam_search_generate(
    engine,
    input_ids,
    output_len: int,
    beam_width: int,
    callback=None,
    beam_search_diversity_rate=None,
    len_penalty=None,
    **sampling_kwargs,
):
    """``engine.generate(beam_width > 1)``: (output ids [B, bw, T], lengths
    and scores [B, bw], per-step log-probs [B, bw, out_len] or None), beams
    best-first.
    The loop has the engine's structure: ``output_len - 1`` advance-then-
    forward iterations and a final advance, stopping once every row has
    finished. ``callback`` gets every beam's newest token each step,
    ``{"last_tokens": [[tok] * bw] * B, "idxs": [[gen_idx] * bw] * B}``."""
    B, bw = len(input_ids), int(beam_width)
    dev = engine.device
    tiled = [list(ids) for ids in input_ids for _ in range(bw)]
    # beams ignore top_k / top_p; the cumulative score is always kept
    for key in ("top_k", "top_p", "return_cum_log_probs"):
        sampling_kwargs.pop(key, None)
    # per-batch request arrays become per-row (beam-minor)
    for key, v in list(sampling_kwargs.items()):
        if v is None or np.isscalar(v):
            continue
        arr = np.asarray(v)
        if arr.ndim >= 1 and arr.shape[0] == B:
            sampling_kwargs[key] = np.repeat(arr, bw, axis=0)
    st, inputs = engine._prepare(tiled, output_len, **sampling_kwargs)

    def tile_param(v, default):
        arr = np.broadcast_to(np.asarray(default if v is None else v, np.float32), (B,))
        return torch.from_numpy(np.repeat(arr, bw)).to(dev)

    inputs["diversity_rate"] = tile_param(beam_search_diversity_rate, 0.0)
    inputs["len_penalty"] = tile_param(len_penalty, 0.0)

    engine.decode_forwards = 0
    s = beam_prefill(engine, st, inputs, bw)
    cfg = engine.config
    rotary_tables = make_rotary_tables(st.total_len + st.prompt_width, cfg.rotary_embedding_dim,
                                       cfg.rotary_base, dev)
    in_lens = inputs["input_lengths"]

    def emit():
        callback({
            "last_tokens": s.newest.reshape(B, bw).tolist(),
            "idxs": (s.seq_lens - in_lens - 1).reshape(B, bw).tolist(),
        })

    while s.gen_step < st.output_len - 1 and not bool(s.finished.all()):
        beam_advance(engine, st, inputs, s, bw)
        if callback is not None:
            emit()
        engine._forward_newest(s, rotary_tables, beam_width=bw)
    # once every beam has finished a further advance only permutes the rows
    # into score order, which the stable sort below gives as well
    if not bool(s.finished.all()):
        beam_advance(engine, st, inputs, s, bw)
        if callback is not None:
            emit()

    tokens, seq_lens, cum, slp = sort_outputs(inputs, s, B, bw)
    return (tokens.cpu().numpy().reshape(B, bw, -1), seq_lens.cpu().numpy().reshape(B, bw),
            cum.cpu().numpy().reshape(B, bw),
            None if slp is None else slp.cpu().numpy().reshape(B, bw, -1))
