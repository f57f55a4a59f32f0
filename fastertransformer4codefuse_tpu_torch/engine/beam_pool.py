"""Beam search served from the continuous-batching pool (port of
engine/beam_pool.py).

Each slot holds ``beam_width`` device rows (the tiled-prompt layout of
``sampling/beam.py``): a request joins by chunk-prefilling all its beam
rows and retires when every beam has finished, mid-flight with the others.

Per tick: forward every row's newest token through the slot's beam
indirection (K11; finished beams and rows that are not ready write at slot
S - 1), the logit processors, then the selection of ``sampling/beam.py``
(per-beam top-bw, diversity and length penalties, the merge) per slot, and
the reorder of the rows' tokens, lengths, scores and indirection by
parent. Rows that are not ready (mid-prefill or empty slots) pass through an
identity gather. The KV slabs never move.

Dense slabs only: the indirection addresses row-contiguous slabs. The beam
width is the pool's; a ``MultiPoolServer`` class per width serves mixed
traffic. Beams do not stream text (the best row changes under reorders):
``on_token`` gets beam 0's token each tick.

The tick copies its rows' tokens, lengths and scores to the host with its
other results (pinned buffers behind the tick's event), so retiring a slot
reads no device state.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..models import gptneox as model
from ..sampling import processors as proc
from ..sampling.beam import NEG_INF, merge_candidates
from .batcher import ContinuousBatcher, Request, encode_word_list


class BeamPool(ContinuousBatcher):
    """Slot pool where every slot decodes ``beam_width`` hypotheses."""

    def __init__(
        self,
        engine,
        max_slots: int = 4,
        beam_width: int = 2,
        max_seq_len: int = 2048,
        prompt_bucket: int = 128,
        stop_words_width: int = 16,
        bad_words_width: int = 16,
        optional_last_width: int = 8,
        pipeline_ticks: bool = False,
    ):
        if int(beam_width) < 2:
            raise ValueError("beam_width 1 is the sampling pool (ContinuousBatcher)")
        if engine.pp > 1:
            raise ValueError("beam pools under pipeline parallelism: use the static path")
        self.beam_width = int(beam_width)
        self._row_mult = self.beam_width
        super().__init__(
            engine,
            max_slots=max_slots,
            max_seq_len=max_seq_len,
            prompt_bucket=prompt_bucket,
            stop_words_width=stop_words_width,
            bad_words_width=bad_words_width,
            optional_last_width=optional_last_width,
            paged=None,
            pipeline_ticks=pipeline_ticks,
        )

    # ------------------------------------------------------------ state ----
    def _init_state(self):
        st = super()._init_state()
        R, S, dev = self.rows, self.max_seq_len, self.device
        st["cum_lp"] = torch.zeros((R,), dtype=torch.float32, device=dev)
        st["finished"] = torch.zeros((R,), dtype=torch.bool, device=dev)
        st["beam_indir"] = torch.zeros((R, S), dtype=torch.int32, device=dev)
        st["diversity"] = torch.zeros((R,), dtype=torch.float32, device=dev)
        st["len_penalty"] = torch.zeros((R,), dtype=torch.float32, device=dev)
        return st

    # -------------------------------------------------------- admission ----
    def make_request(self, prompt, output_len: int, **kw) -> Request:
        kw.pop("beam_width", None)  # the pool's
        if kw.get("on_text") is not None:
            raise ValueError(
                "beam pools do not stream text (the best-so-far row changes under reorders); "
                "use on_token or the static path"
            )
        # beams ignore top_k, top_p, the presence penalty and the seed
        for key in ("top_k", "top_p", "presence_penalty", "random_seed"):
            kw.pop(key, None)
        return super().make_request(prompt, output_len, **kw)

    def _admit(self, r: Request, slot: int) -> None:
        """Install ``r`` in the slot's bw rows: the tiled prompt, its
        parameters, the initial scores (only beam 0 proposes at the first
        merge) and an indirection where every beam reads its own row; one
        int32 and one fp32 host-to-device copy."""
        S, bw = self.max_seq_len, self.beam_width
        ids = np.full((S,), self.cfg.end_id, np.int32)
        ids[: len(r.prompt)] = r.prompt
        olt = np.full((self.optional_last_width,), -1, np.int32)
        if r.optional_last_tokens:
            olt[: len(r.optional_last_tokens)] = list(r.optional_last_tokens)
        iv = self._h2d(np.concatenate([
            ids,
            np.array([len(r.prompt), self._stop_at(r), r.min_length], np.int32),
            encode_word_list(r.stop_words, self.stop_words_width).ravel(),
            encode_word_list(r.bad_words, self.bad_words_width).ravel(),
            olt,
        ]))
        fv = self._h2d(np.array(
            [r.temperature, r.repetition_penalty, r.beam_search_diversity_rate, r.len_penalty,
             0.0] + [NEG_INF] * (bw - 1), np.float32))
        st = self._state
        rows = slice(slot * bw, (slot + 1) * bw)
        o = 0

        def take(n):
            nonlocal o
            o += n
            return iv[o - n: o]

        st["tokens"][rows] = take(S)
        in_len, stop_at, min_length = take(3)
        st["seq_lens"][rows] = in_len
        st["input_lens"][rows] = in_len
        st["stop_at"][rows] = stop_at
        st["min_length"][rows] = min_length
        st["stop_words"][rows] = take(2 * self.stop_words_width).view(2, -1)
        st["bad_words"][rows] = take(2 * self.bad_words_width).view(2, -1)
        st["olt"][rows] = take(self.optional_last_width)
        for i, name in enumerate(("temperature", "rep_penalty", "diversity", "len_penalty")):
            st[name][rows] = fv[i]
        st["cum_lp"][rows] = fv[4:]
        st["prefill_pos"][rows] = 0
        st["steps"][rows] = 0
        st["active"][rows] = True
        st["finished"][rows] = False
        st["beam_indir"][rows] = torch.arange(bw, dtype=torch.int32, device=self.device)[:, None]
        r.slot = slot
        r._admit_ids, r._new_ids = list(r.prompt), []
        r._chunks_left = -(-max(len(r.prompt) - 1, 0) // self.prompt_bucket)
        self.running[slot] = r

    # ------------------------------------------------------------- tick ----
    def _step(self):
        """One decode tick over every row; returns device tensors: per slot
        (beam 0's token, a zero log-prob, done, ready), per row (tokens,
        lengths, scores) for retirement."""
        st, S, end_id = self._state, self.max_seq_len, self.cfg.end_id
        R, bw, n = self.rows, self.beam_width, self.max_slots
        target = torch.clamp(st["input_lens"] - 1, min=0)
        ready = st["active"] & (st["prefill_pos"] >= target)
        buf_idx = torch.clamp(st["seq_lens"] - 1, 0, S - 1)
        newest = st["tokens"].gather(1, buf_idx.long()[:, None])[:, 0]
        positions = torch.where(ready, buf_idx, torch.zeros_like(buf_idx))
        hidden, _ = model.decode_step(
            self.cfg, self.engine.params, newest, positions, st["cache"],
            rotary_tables=self._rotary, kv_skip=(~ready) | st["finished"],
            kv_skip_mode="sacrifice_last", beam=(bw, st["beam_indir"]),
            fused=self.engine.runtime.fused_decode, mesh=self.engine.mesh,
        )
        # the sampling pool's processors: a beam row's presence penalty stays 0
        logits = self._process_logits(st, model.lm_logits(self.cfg, self.engine.params, hidden,
                                                          self.engine.mesh))
        src, new_tok, new_cum = merge_candidates(
            torch.log_softmax(logits, dim=-1), st["cum_lp"], st["finished"], st["seq_lens"],
            st["input_lens"], st["diversity"], st["len_penalty"], bw, end_id,
        )
        rows = torch.arange(R, device=self.device)
        src = torch.where(ready, src, rows)  # rows that are not ready stay as they are
        tokens = st["tokens"].index_select(0, src)
        seq_lens = st["seq_lens"].index_select(0, src)
        finished = st["finished"].index_select(0, src)
        cum_prev = st["cum_lp"].index_select(0, src)
        indir = st["beam_indir"].index_select(0, src)

        keep = finished | ~ready
        tok = torch.where(keep, torch.full_like(new_tok, end_id), new_tok)
        write_idx = torch.clamp(seq_lens, 0, S - 1).long()[:, None]
        kept_tok = tokens.gather(1, write_idx)[:, 0]
        tokens.scatter_(1, write_idx, torch.where(keep, kept_tok, tok)[:, None])
        # the next forward writes row r's new KV into row r itself
        own = (rows % bw).to(torch.int32)
        kept_row = indir.gather(1, write_idx)[:, 0]
        indir.scatter_(1, write_idx, torch.where(keep, kept_row, own)[:, None])
        seq_lens = seq_lens + (~keep).to(torch.int32)
        cum = torch.where(keep, cum_prev, new_cum)
        stops = ((tok == end_id) | (seq_lens >= st["stop_at"])
                 | proc.stop_words_criterion(tokens, seq_lens, st["stop_words"], 1))
        finished = finished | (ready & ~finished & stops)

        slot_done = (ready & finished).reshape(n, bw).all(dim=1)
        st["tokens"], st["seq_lens"], st["cum_lp"] = tokens, seq_lens, cum
        st["finished"], st["beam_indir"] = finished, indir
        st["active"] &= ~slot_done.repeat_interleave(bw)
        st["steps"] += ready.to(torch.int32)
        self.decode_ticks += 1
        return (tok.reshape(n, bw)[:, 0], torch.zeros(n, device=self.device), slot_done,
                ready.reshape(n, bw).all(dim=1), tokens, seq_lens, cum)

    # ------------------------------------------------------------ retire ----
    def _process_results(self, fetched) -> List[Tuple[int, int, bool]]:
        tok_h, _, fin_h, ready_h, toks_h, lens_h, cum_h = fetched
        bw = self.beam_width
        emitted = []
        for slot, r in list(self.running.items()):
            if not bool(ready_h[slot]):
                continue
            t = int(tok_h[slot])
            done = bool(fin_h[slot])
            emitted.append((r.uid, t, done))
            if r.on_token is not None:
                r.on_token(t)
            if done:
                rows = slice(slot * bw, (slot + 1) * bw)
                lens, cum = lens_h[rows], cum_h[rows]
                # best-first by the length-penalised score, ties in beam order
                factor = np.power((5.0 + (lens - len(r.prompt)).astype(np.float32)) / 6.0,
                                  np.float32(r.len_penalty))
                order = np.argsort(-(cum / factor), kind="stable")
                r.beam_output_ids = [[int(x) for x in toks_h[slot * bw + j, : int(lens[j])]]
                                     for j in order]
                r.beam_cum_log_probs = [float(cum[j]) for j in order]
                r.output_ids = r.beam_output_ids[0]
                r.cum_log_prob = r.beam_cum_log_probs[0]
                r.done = True
                del self.running[slot]
        return emitted
