"""T5 serving engine: sampled and beam decoding, float or int8 weights (port
of engine/t5_engine.py).

A host loop of device ops over ``models/t5.py``'s encoder and decoder step,
as ``engine/engine.py`` is for the decoder families:

  - ``generate``: one encoder pass, then one decoder step a token: greedy,
    or per-row top-k / top-p with per-row temperature, each row drawing its
    Gumbel noise from its own ``torch.Generator`` seeded with its
    ``random_seed`` (``sampling/sample.py``); the loop ends once every row
    has emitted ``end_id``, and a finished row is padded with ``end_id``.
  - ``beam_width > 1``: HuggingFace's vectorized ``_beam_search``
    (transformers 4.57, generation/utils.py ``_get_top_k_continuations``,
    ``_update_finished_beams``, ``_check_early_stop_heuristic``): 2k
    continuations, running and finished beam sets, length-penalized
    finalization and the ``early_stopping=False`` improvement heuristic, so
    the beams equal ``hf.generate(num_beams=k)``'s token for token. Top-k
    takes a stable descending sort: equal scores keep the lower flat index
    first, the order of the JAX package's ``lax.top_k``. The self-attention
    slabs are reordered by each step's parents.
  - int8: ``models.t5.quantize_t5_params`` weights, through the same model
    functions.

Tensor parallelism (``mesh=``, the JAX engine's): the engine keeps its
rank's slice (``models.t5.shard_t5_params``) and every rank of the tp group
runs the same loop on the same, replicated-head logits, so all draw the
same tokens.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..models import t5 as t5m
from ..models.t5 import T5Config
from ..sampling.sample import gumbel_noise, sample_top_k_top_p, top_k_stable

NEG = -1.0e9


class T5Output(NamedTuple):
    output_ids: np.ndarray  # [B, beams, L] generated ids (no decoder start)
    sequence_lengths: np.ndarray  # [B, beams] generated length incl. eos
    scores: np.ndarray  # [B, beams] (beam: length-penalized; sampling: 0)


@dataclasses.dataclass(frozen=True)
class _Statics:
    batch: int
    in_width: int
    out_len: int
    beam_width: int
    greedy: bool
    length_penalty: float
    early_stopping: bool


def _gather_beams(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, n, ...], idx [B, m] -> [B, m, ...]."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


class T5Engine:
    """Host-facing T5 engine on the params' device."""

    def __init__(self, config: T5Config, params, mesh=None):
        self.config = config
        self.mesh = mesh
        self.params = params if mesh is None else t5m.shard_t5_params(config, params, mesh)
        self.device = params["embed"].device
        self.decode_forwards = 0  # decoder steps of the last generate call

    # ------------------------------------------------------------ helpers --
    def _prepare(self, input_ids, output_len, beam_width, top_k, top_p,
                 temperature, random_seed, length_penalty, early_stopping):
        B = len(input_ids)
        lens = np.array([len(x) for x in input_ids], np.int32)
        W = int(-(-int(lens.max()) // 8) * 8)
        ids = np.zeros((B, W), np.int32)
        for i, x in enumerate(input_ids):
            ids[i, : len(x)] = np.asarray(x, np.int32)

        def per(v, default, dtype):
            if v is None:
                return np.full((B,), default, dtype)
            if np.isscalar(v):
                return np.full((B,), v, dtype)
            a = np.asarray(v, dtype)
            if a.shape != (B,):
                raise ValueError(f"expected one value a row ({B}), got shape {a.shape}")
            return a

        top_k = per(top_k, 1, np.int32)
        top_p = per(top_p, 0.0, np.float32)
        temperature = per(temperature, 1.0, np.float32)
        seeds = per(random_seed, 0, np.int64)
        st = _Statics(
            batch=B, in_width=W, out_len=int(output_len), beam_width=int(beam_width),
            greedy=bool((top_k == 1).all() and (top_p <= 0).all()),
            length_penalty=float(length_penalty), early_stopping=bool(early_stopping),
        )
        dev = self.device
        inputs = {
            "ids": torch.from_numpy(ids).to(dev),
            "lens": torch.from_numpy(lens).to(dev),
            "top_k": torch.from_numpy(top_k).to(dev),
            "top_p": torch.from_numpy(top_p).to(dev),
            "temperature": torch.from_numpy(temperature).to(dev),
            "seeds": seeds.tolist(),
        }
        return st, inputs

    def _step_noise(self, generators, step: int, n: int) -> torch.Tensor:
        """Gumbel noise [B, n] of decoder step ``step``, row b from
        ``generators[b]`` (each row draws n numbers a step)."""
        return gumbel_noise(generators, n, self.device)

    # ------------------------------------------------------------ sampling --
    def _sample(self, st: _Statics, inputs) -> np.ndarray:
        cfg, params, dev = self.config, self.params, self.device
        B = st.batch
        enc = t5m.encode(cfg, params, inputs["ids"], inputs["lens"], self.mesh)
        state = t5m.init_decoder_state(cfg, params, enc, inputs["lens"], st.out_len + 1,
                                       self.mesh)
        gens = None if st.greedy else [
            torch.Generator(device=dev).manual_seed(s) for s in inputs["seeds"]]
        out = torch.full((B, st.out_len), cfg.end_id, dtype=torch.int32, device=dev)
        tok = torch.full((B,), cfg.start_id, dtype=torch.int32, device=dev)
        finished = torch.zeros((B,), dtype=torch.bool, device=dev)
        for i in range(st.out_len):
            logits, state = t5m.decode_step(cfg, params, state, tok, i, self.mesh)
            self.decode_forwards += 1
            if st.greedy:
                nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            else:
                logits = logits / torch.clamp(inputs["temperature"], min=1e-6)[:, None]
                noise = self._step_noise(gens, i, logits.shape[1])
                nxt = sample_top_k_top_p(logits, inputs["top_k"], inputs["top_p"], noise,
                                         need_log_probs=False).tokens
            tok = torch.where(finished, cfg.end_id, nxt).to(torch.int32)
            out[:, i] = tok
            finished |= tok == cfg.end_id
            if bool(finished.all()):
                break
        return out.cpu().numpy()

    # ---------------------------------------------------------------- beam --
    def _beam(self, st: _Statics, inputs):
        cfg, params, dev = self.config, self.params, self.device
        k, B, V = st.beam_width, st.batch, cfg.vocab_size
        K = 2 * k  # beams to keep (one eos token)
        Lmax = st.out_len  # generated tokens (the decoder start excluded)
        lp_pow = st.length_penalty
        f32 = dict(dtype=torch.float32, device=dev)

        enc = t5m.encode(cfg, params, inputs["ids"], inputs["lens"], self.mesh)
        # encoder rows tiled beam-minor: row b*k + j
        enc_t = enc.repeat_interleave(k, dim=0)
        lens_t = inputs["lens"].repeat_interleave(k, dim=0)
        state = t5m.init_decoder_state(cfg, params, enc_t, lens_t, Lmax + 1, self.mesh)

        running_seq = torch.full((B, k, Lmax), cfg.end_id, dtype=torch.long, device=dev)
        running_scores = torch.zeros((B, k), **f32)
        running_scores[:, 1:] = NEG
        seq = torch.full((B, k, Lmax), cfg.end_id, dtype=torch.long, device=dev)
        scores = torch.full((B, k), NEG, **f32)
        seq_lens = torch.zeros((B, k), dtype=torch.long, device=dev)
        finished = torch.zeros((B, k), dtype=torch.bool, device=dev)
        unsat = torch.ones((B, 1), dtype=torch.bool, device=dev)  # the heuristic unsatisfied
        hits = torch.zeros((B, K), dtype=torch.bool, device=dev)
        tok = torch.full((B * k,), cfg.start_id, dtype=torch.long, device=dev)
        top_mask = torch.arange(K, device=dev) < k  # the top-k of the 2k continuations
        rows0 = torch.arange(B, device=dev)[:, None] * k

        cur = 0
        while cur < Lmax:
            go = unsat.any() & ~hits.all()
            if st.early_stopping:
                go = go & ~finished.all()
            if not bool(go):
                break
            logits, state = t5m.decode_step(cfg, params, state, tok, cur, self.mesh)
            self.decode_forwards += 1
            log_probs = torch.log_softmax(logits.float(), dim=-1).reshape(B, k, V)
            acc = (log_probs + running_scores[:, :, None]).reshape(B, k * V)

            # the top-K continuations
            topk_lp, topk_idx = top_k_stable(acc, K)
            parent = topk_idx // V
            token = topk_idx % V
            topk_seq = _gather_beams(running_seq, parent)
            topk_seq[:, :, cur] = token

            # stopping criteria of a continuation: eos or the last position
            hits = (token == cfg.end_id) | (cur + 1 >= Lmax)

            # the next running beams: the best k continuations not finished
            run_lp = topk_lp + hits.float() * NEG
            _, nxt = top_k_stable(run_lp, k)
            new_running_seq = _gather_beams(topk_seq, nxt)
            new_running_scores = _gather_beams(run_lp, nxt)
            new_parent = _gather_beams(parent, nxt)  # [B, k]: the cache reorder

            # the finished-beam update (HF _update_finished_beams); the length
            # penalty is a Python double, as HF computes it
            denom = torch.tensor(float((cur + 1) ** lp_pow), **f32)
            pen = topk_lp / denom
            if st.early_stopping:
                pen = pen + finished.all(dim=-1, keepdim=True).float() * NEG
            pen = pen + (~unsat).float() * NEG
            just_done = hits & top_mask[None, :]
            pen = pen + (~just_done).float() * NEG
            m_seq = torch.cat([seq, topk_seq], dim=1)
            m_scores = torch.cat([scores, pen], dim=1)
            m_fin = torch.cat([finished, just_done], dim=1)
            m_lens = torch.cat([seq_lens, torch.full((B, K), cur + 1, dtype=torch.long,
                                                     device=dev)], dim=1)
            _, best = top_k_stable(m_scores, k)
            seq = _gather_beams(m_seq, best)
            scores = _gather_beams(m_scores, best)
            finished = _gather_beams(m_fin, best)
            seq_lens = _gather_beams(m_lens, best)

            # reorder the self-attention slabs to the surviving parents
            rows = (rows0 + new_parent).reshape(-1)
            state["self_k"] = state["self_k"][:, rows]
            state["self_v"] = state["self_v"][:, rows]

            # the early-stop heuristic (cur_len has advanced by one)
            best_possible = new_running_scores[:, :1] / denom
            worst_fin = torch.where(finished, scores.min(dim=1, keepdim=True).values,
                                    torch.full_like(scores, NEG))
            unsat = unsat & (best_possible > worst_fin).any(dim=-1, keepdim=True)

            running_seq, running_scores = new_running_seq, new_running_scores
            tok = running_seq[:, :, cur].reshape(-1)
            cur += 1
        return seq.cpu().numpy().astype(np.int32), scores.cpu().numpy(), \
            seq_lens.cpu().numpy().astype(np.int32)

    # ------------------------------------------------------------ host API --
    @torch.no_grad()
    def generate(
        self,
        input_ids: Sequence[Sequence[int]],
        output_len: int,
        beam_width: int = 1,
        top_k=None,
        top_p=None,
        temperature=None,
        random_seed=None,
        length_penalty: float = 1.0,
        early_stopping: bool = False,
    ) -> T5Output:
        """Encode ``input_ids`` (ragged lists) and decode ``output_len``
        tokens a row; per-row ``top_k``, ``top_p``, ``temperature`` and
        ``random_seed`` (scalars or one value a row)."""
        st, inputs = self._prepare(
            input_ids, output_len, beam_width, top_k, top_p, temperature,
            random_seed, length_penalty, early_stopping,
        )
        B = st.batch
        self.decode_forwards = 0
        if st.beam_width == 1:
            out = self._sample(st, inputs)
            lens = np.zeros((B,), np.int32)
            for b in range(B):
                eos = np.where(out[b] == self.config.end_id)[0]
                lens[b] = (eos[0] + 1) if eos.size else st.out_len
            return T5Output(output_ids=out[:, None, :], sequence_lengths=lens[:, None],
                            scores=np.zeros((B, 1), np.float32))
        seq, scores, seq_lens = self._beam(st, inputs)
        return T5Output(output_ids=seq, sequence_lengths=seq_lens, scores=scores)
