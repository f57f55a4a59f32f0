"""Speculative decoding served from the continuous-batching pool (port of
engine/spec_pool.py).

The pool's decode tick is a (k+1)-wide verify: every tick, each ready slot
proposes its own n-gram draft from its token buffer (the prompt-lookup
matcher of ``engine/speculative.py``), one [slots, k + 1] chunked forward
(``models.gptneox.prefill_chunk``, the program admission chunks ride)
verifies all slots, and each slot commits its own count: a slot that
accepted 5 drafts moves 6 tokens this tick while its neighbour moves 1.
Admission, chunked prefill, priority queueing, pipelined ticks and the
server seams are the base pool's.

Greedy only: every committed token is its verify row's argmax, so
``make_request`` refuses sampling parameters and processors. Dense KV (an
int8 or bf16 cache), no prompt tables.

The tick never synchronises with the device: its rows (candidates, commit
counts, log-probs, finished, ready) come back through the base pool's
fetch, pipelined or not. A finished request's output is its admitted ids and
the tokens it committed, which is what the device buffer holds (the JAX
pool reads that row back; here the host already has it).

Cache invariant (as in ``engine/speculative.py``): rejected-draft K/V sit
past the committed length, and the next tick's chunk rewrites them from
committed_len - 1 before any query can see them.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from .batcher import ContinuousBatcher, Request
from .speculative import commit, verify_step


class SpecPool(ContinuousBatcher):
    """Slot pool whose decode tick is a (k+1)-wide speculative verify."""

    speculative = True

    def __init__(self, engine, k: int = 8, ngram: int = 3, **kw):
        if kw.get("paged") is not None:
            raise ValueError("speculative pools are dense-KV; drop paged= or speculative=")
        if kw.get("prompt_table"):
            raise ValueError("speculative pool does not serve prompt learning")
        if engine.pp > 1:
            raise ValueError("speculative pool under pp>1: use the static path")
        self.k = int(k)
        self.ngram = int(ngram)
        super().__init__(engine, **kw)

    # -------------------------------------------------------- admission ----
    def make_request(self, prompt, output_len, **kw) -> Request:
        kw.pop("random_seed", None)  # greedy: deterministic
        r = super().make_request(prompt, output_len, **kw)
        C = self.k + 1
        if len(r.prompt) + r.output_len > self.max_seq_len - (C + 1):
            raise ValueError(
                f"speculative pool needs a {C + 1}-token draft margin: prompt + output must be "
                f"<= {self.max_seq_len - (C + 1)}"
            )
        for name, val, want in (
            ("top_k", r.top_k, 1), ("top_p", r.top_p, 0.0), ("temperature", r.temperature, 1.0),
            ("repetition_penalty", r.repetition_penalty, 1.0),
            ("presence_penalty", r.presence_penalty, 0.0), ("min_length", r.min_length, 0),
        ):
            if val != want:
                raise ValueError(f"speculative pool is greedy-only: {name} must be {want}")
        if any(r.stop_words or []) or any(r.bad_words or []) or r.optional_last_tokens:
            raise ValueError(
                "speculative pool serves processor-free requests only (stop/bad words, "
                "optional-last: use the sampling pool)"
            )
        return r

    # ------------------------------------------------------------- tick ----
    def _step(self):
        """One verify tick over all slots; returns device tensors (candidates
        [slots, k + 1], commit counts, log-probs [slots, k + 1], finished,
        ready)."""
        st, C = self._state, self.k + 1
        target = torch.clamp(st["input_lens"] - 1, min=0)
        ready = st["active"] & (st["prefill_pos"] >= target)
        l = torch.clamp(st["seq_lens"], min=1)  # the committed buffer length
        v = verify_step(self.cfg, self.engine.params, st["tokens"], l, st["cache"], ready,
                        self.k, self.ngram, self._rotary, self.engine.runtime.fused_decode,
                        self.engine.runtime.act_int8, self.engine.mesh)
        n = torch.minimum(torch.minimum(v.m, v.first_end) + 1, st["stop_at"] - l)
        n = torch.where(ready, torch.clamp(n, min=0), 0)
        commit(st["tokens"], l, v.cand, n)
        st["seq_lens"] += n
        finished = ready & ((v.first_end < C) | (st["seq_lens"] >= st["stop_at"]))
        st["active"] &= ~finished
        st["steps"] += ready.to(torch.int32)
        self.decode_ticks += 1
        return v.cand, n, v.lps, finished, ready

    # -------------------------------------------------------- results ----
    def _process_results(self, fetched) -> List[Tuple[int, int, bool]]:
        cand_h, n_h, lp_h, fin_h, ready_h = fetched
        emitted = []
        for slot, r in list(self.running.items()):
            if not bool(ready_h[slot]):
                continue  # still chunk-prefilling this tick
            c = int(n_h[slot])
            done = bool(fin_h[slot])
            for j in range(c):
                t = int(cand_h[slot, j])
                emitted.append((r.uid, t, done and j == c - 1))
                r._new_ids.append(t)
                if self.return_log_probs:
                    r.cum_log_prob += float(lp_h[slot, j])
                    if r.step_log_probs is None:
                        r.step_log_probs = []
                    r.step_log_probs.append(float(lp_h[slot, j]))
                if r.on_token is not None:
                    r.on_token(t)
                if r._decoder is not None:
                    r._decoder.append_token(t)
            if done:
                r.output_ids = r._admit_ids + r._new_ids
                r.done = True
                if r._decoder is not None and (not r.output_ids
                                               or r.output_ids[-1] != self.cfg.end_id):
                    r._decoder.append_token(self.cfg.end_id)  # flush the tail text
                del self.running[slot]
        return emitted
