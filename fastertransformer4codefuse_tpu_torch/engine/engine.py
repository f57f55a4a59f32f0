"""Generation engine: prefill, a decode loop and the sampling stack (port of
engine/engine.py).

The JAX engine runs the whole generation as one jitted ``lax.while_loop``;
here the loop is Python, with the same step structure: ``output_len - 1``
sample-then-forward iterations and a final sample-only step, stopping early
once every row has finished. Ragged batches are packed per row (row b's new
token lands in cache slot ``seq_lens[b]``), so rotary positions stay exact.

Sampling draws its Gumbel noise from one ``torch.Generator`` per request row,
seeded with the row's ``random_seed``: the same seed gives the same tokens,
but not the JAX package's tokens (another generator).

Prompt learning (the reference's prompt_learning_table): a prefix prompt is a
task's saved K/V ``[L, 2, kv_heads, P, dh]`` written into cache slots
[0, p_len) of its row; a soft prompt is ``[B, P, H]`` embeddings run through
``prefill_chunk`` at slots [0, P). The input then prefills as one chunk at
the row's offset (cache slot and rotary position = buffer index + p_len) and
decodes there. Unlike the JAX static engine, which checks and writes
``head_num`` heads and so refuses every GQA/MQA prefix table, the table holds
``kv_heads`` heads, as the JAX pool's does.

With ``RuntimeConfig.debug_enabled()`` each ``generate`` first runs
``utils.debug.debug_verify``; otherwise nothing of it runs.

Tensor and data parallelism (``mesh=``, ``parallel/``): the engine keeps
this rank's slice of the params (``parallel.sharding.shard_params``) and
caches of its KV heads, and every forward runs the model's counted
collectives over the tp group. All ranks of a tp group run the same host
loop on the same logits (the vocab slices all-gathered, every reduce
bit-equal on every rank) with the same generators, so they draw the same
tokens and stop together. dp splits a batch's rows into contiguous blocks,
one a dp group, at the batch's padded width, and gathers the outputs: every
rank returns the whole ``GenerationOutput``.

Pipeline parallelism (a mesh with ``pp > 1``, ``parallel/pipeline.py``):
the engine keeps its stage's block of the layers (then its tp slice) and a
cache of that many layers; the prefill, the prompt chunks and every decode
forward run the model's functions at the stage's layers
(``RuntimeConfig.pp_microbatches`` microbatches where they divide the width
or the rows, ``pipeline.microbatches``), which hand the last stage's hidden
to every stage, and each rank then computes the head
and samples as above. The DEBUG sweep is not served under pp.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..core.config import GptNeoXConfig, RuntimeConfig
from ..core.dtypes import torch_dtype
from . import kv_cache
from .paged_kv import PACKED_KINDS
from ..models import gptneox as model
from ..models.params import Params
from ..ops.rotary import make_rotary_tables
from ..parallel import pipeline
from ..parallel.distributed import Mesh, gather_rows
from ..parallel.sharding import cache_heads, shard_params, stage_layers
from ..sampling import processors as proc
from ..sampling.beam import beam_search_generate
from ..sampling.sample import (
    gumbel_noise,
    sample_greedy,
    sample_top_k_top_p,
    sample_top_k_top_p_capped,
)


@dataclasses.dataclass
class DecodeState:
    tokens: torch.Tensor  # [B, T] int32 packed sequence buffer
    seq_lens: torch.Tensor  # [B] int32 current length per row
    finished: torch.Tensor  # [B] bool
    cum_log_probs: torch.Tensor  # [B] fp32
    logits: torch.Tensor  # [B, V] fp32, for the next sample
    cache: dict
    newest: torch.Tensor  # [B] int32, the token sampled this step
    generators: Optional[list]  # one torch.Generator per row (sampled requests)
    step_log_probs: Optional[torch.Tensor]  # [B, output_len] fp32
    gen_step: int = 0
    # beam search: [B, T + P] int32, the beam (in [0, bw)) of its group whose
    # cache row holds each cache slot of the row's hypothesis
    beam_indir: Optional[torch.Tensor] = None
    # prompt learning: [B] int32, the cache slot / rotary offset of buffer
    # index 0 (the prompt holds slots [0, offset))
    pos_offset: Optional[torch.Tensor] = None


@dataclasses.dataclass(frozen=True)
class _Statics:
    """Per-request shape and processor flags."""

    batch: int
    input_width: int
    total_len: int
    output_len: int
    greedy: bool
    use_temperature: bool
    use_rep_penalty: bool
    use_pres_penalty: bool
    use_min_length: bool
    use_stop_words: bool
    use_bad_words: bool
    use_optional_last: bool
    sampling_cap: int  # 0 = full sort; >0 = top-cap fast path
    use_output_log_probs: bool = False
    use_cum_log_probs: bool = False
    prompt_width: int = 0  # P, the prompts' cache slots padded to 8 (0: none)
    prompt_kind: str = "none"  # "none" | "prefix" | "soft"


def _pad_to(x: np.ndarray, width: int, axis: int, value) -> np.ndarray:
    pad = width - x.shape[axis]
    if pad <= 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return np.pad(x, widths, constant_values=value)


class GenerationOutput(NamedTuple):
    output_ids: np.ndarray  # [B, beam, T] int32: input + generated + end padding
    sequence_lengths: np.ndarray  # [B, beam] int32
    cum_log_probs: np.ndarray  # [B, beam] fp32
    output_log_probs: Optional[np.ndarray] = None  # [B, beam, out_len] fp32


class GptNeoXEngine:
    """Host-facing engine over a parameter dict on one device.

    ``decode_forwards`` counts the decode-step forwards of the last
    ``generate`` call (each runs every layer once). ``mesh``
    (``parallel.distributed.Mesh``, from ``parallel.sharding.build_mesh``):
    ``params`` are the full weights, and the engine keeps this rank's slice.
    """

    def __init__(
        self,
        config: GptNeoXConfig,
        params: Params,
        runtime: Optional[RuntimeConfig] = None,
        mesh: Optional[Mesh] = None,
    ):
        self.config = config
        self.runtime = runtime or RuntimeConfig()
        rt = self.runtime
        self.pp = 1 if mesh is None else mesh.pp
        if rt.pipeline_para_size > 1 and rt.pipeline_para_size != self.pp:
            raise ValueError(f"pipeline_para_size {rt.pipeline_para_size} needs a mesh of as many "
                             f"pp stages (parallel.sharding.build_mesh(pp=...)), got {self.pp}")
        self.mesh = mesh
        if mesh is not None:
            params = shard_params(config, params, mesh)
        self.params = params
        self.kv_heads = cache_heads(config, mesh)
        # (first, count) of the layers this rank's stage holds (all without pp)
        self.stage = stage_layers(config, mesh)
        self.device = params["final_ln_w"].device
        self.decode_forwards = 0
        # {task id: (kv [L, 2, kv_heads, P, dh] fp32 on the device, length)}
        self._prompt_table: dict = {}

    # ------------------------------------------------------------ prompts --
    def set_prompt_learning_table(self, table) -> None:
        """Register prefix prompts: ``table[task_id] = (kv, length)``, kv
        ``[L, 2, kv_heads, P, dh]`` (numpy or torch), the saved per-layer K/V
        of a tuned prefix, ``length <= P``. Requests pick a task with
        ``prompt_learning_task_name_ids``."""
        self._prompt_table = kv_cache.prompt_tables(self.config, table, self.device,
                                                    heads=self.kv_heads, layers=self.stage)

    def _prepare_prompt(self, B, task_ids, soft_embedding, soft_lengths):
        """(kind, P, device inputs) of a request's prompts: P the widest
        prompt padded to 8."""
        cfg, dev = self.config, self.device
        if task_ids is not None:
            if soft_embedding is not None:
                raise ValueError("prefix and soft prompts are exclusive")
            task_ids = list(task_ids)
            if len(task_ids) != B:
                raise ValueError(f"{len(task_ids)} prompt task ids for a batch of {B}")
            unknown = [t for t in task_ids if t not in self._prompt_table]
            if unknown:
                raise ValueError(f"unknown prompt task {unknown[0]}")
            lens = [self._prompt_table[t][1] for t in task_ids]
            P = -(-max(max(lens), 1) // 8) * 8
            shape = (self.stage[1], B, self.kv_heads[1], P, cfg.size_per_head)
            k_pre = torch.zeros(shape, dtype=torch.float32, device=dev)
            v_pre = torch.zeros_like(k_pre)
            for b, t in enumerate(task_ids):
                kv, n = self._prompt_table[t]
                k_pre[:, b, :, :n] = kv[:, 0, :, :n]
                v_pre[:, b, :, :n] = kv[:, 1, :, :n]
            return "prefix", P, {
                "prefix_k": k_pre, "prefix_v": v_pre,
                "prompt_lengths": torch.tensor(lens, dtype=torch.int32, device=dev),
            }
        if soft_embedding is not None:
            emb = torch.as_tensor(np.asarray(soft_embedding, np.float32)
                                  if not torch.is_tensor(soft_embedding) else soft_embedding)
            if not (emb.ndim == 3 and emb.shape[0] == B and emb.shape[2] == cfg.hidden_size):
                raise ValueError(f"soft prompt of shape {tuple(emb.shape)}, expected "
                                 f"[{B}, P, {cfg.hidden_size}]")
            lens = (np.full((B,), emb.shape[1], np.int32) if soft_lengths is None
                    else np.asarray(soft_lengths, np.int32))
            P = -(-emb.shape[1] // 8) * 8
            emb = torch.nn.functional.pad(emb.float(), (0, 0, 0, P - emb.shape[1]))
            return "soft", P, {
                "prompt_embeds": emb.to(dev),
                "prompt_lengths": torch.from_numpy(lens).to(dev),
            }
        return "none", 0, {}

    def _cache_dtype(self):
        """The KV cache's torch dtype, or the packed int4 kind ("int4",
        "int8k_int4v") as the string the cache constructors take."""
        name = self.runtime.kv_cache_dtype or self.runtime.dtype
        return name if name in PACKED_KINDS else torch_dtype(name)

    def packed_kv(self) -> bool:
        """The KV cache pairs sequence positions in int4 bytes."""
        return self._cache_dtype() in PACKED_KINDS

    # ------------------------------------------------------------------ step --
    def _sample_and_advance(self, st: _Statics, inputs, s: DecodeState) -> None:
        """Process logits -> sample -> stop criteria, in the JAX order:
        optional-last-tokens -> bad words -> temperature -> repetition /
        presence penalty -> min length -> top-k/top-p draw."""
        end_id = self.config.end_id
        B, T = s.tokens.shape
        logits = s.logits
        if st.use_optional_last:
            logits = proc.apply_optional_last_tokens(
                logits, inputs["optional_last_tokens"], 1, s.gen_step == 0
            )
        if st.use_bad_words:
            logits = proc.ban_bad_words(logits, s.tokens, s.seq_lens, inputs["bad_words"], 1)
        if st.use_temperature:
            logits = proc.apply_temperature(logits, inputs["temperature"])
        if st.use_rep_penalty or st.use_pres_penalty:
            buf_valid = torch.arange(T, device=self.device)[None, :] < s.seq_lens[:, None]
            if st.use_rep_penalty:
                logits = proc.apply_repetition_penalty(
                    logits, s.tokens, buf_valid, inputs["repetition_penalty"]
                )
            if st.use_pres_penalty:
                logits = proc.apply_presence_penalty(
                    logits, s.tokens, buf_valid, inputs["presence_penalty"]
                )
        if st.use_min_length:
            gen_lens = s.seq_lens - inputs["input_lengths"]
            logits = proc.apply_min_length(logits, gen_lens, inputs["min_length"], end_id)

        need_lp = st.use_cum_log_probs or st.use_output_log_probs
        if st.greedy:
            res = sample_greedy(logits, need_log_probs=need_lp)
        elif st.sampling_cap:
            noise = gumbel_noise(s.generators, min(st.sampling_cap, logits.shape[1]), self.device)
            res = sample_top_k_top_p_capped(
                logits, inputs["top_k"], inputs["top_p"], noise, cap=st.sampling_cap,
                need_log_probs=need_lp,
            )
        else:
            noise = gumbel_noise(s.generators, logits.shape[1], self.device)
            res = sample_top_k_top_p(
                logits, inputs["top_k"], inputs["top_p"], noise, need_log_probs=need_lp
            )

        tok = torch.where(s.finished, torch.full_like(res.tokens, end_id), res.tokens)
        lp = torch.where(s.finished, torch.zeros_like(res.log_probs), res.log_probs)
        rows = torch.arange(B, device=self.device)
        write_idx = s.seq_lens.clamp(0, T - 1).long()
        s.tokens[rows, write_idx] = torch.where(s.finished, s.tokens[rows, write_idx], tok)
        s.seq_lens = s.seq_lens + (~s.finished).to(torch.int32)
        s.cum_log_probs = s.cum_log_probs + lp
        newly_finished = tok == end_id
        if st.use_stop_words:
            newly_finished = newly_finished | proc.stop_words_criterion(
                s.tokens, s.seq_lens, inputs["stop_words"], 1
            )
        s.finished = s.finished | newly_finished
        if s.step_log_probs is not None:
            s.step_log_probs[:, s.gen_step] = lp
        s.gen_step += 1
        s.newest = tok

    def _forward_newest(self, s: DecodeState, rotary_tables, beam_width: int = 1) -> None:
        """Decode-forward each row's newest token: the logits of the next
        sample.

        With ``beam_width > 1`` the cache stays fixed and attention resolves
        ``s.beam_indir`` (K11). Finished rows write at slot S - 1
        (``sacrifice_last``): after a reorder the hypothesis in row r is no
        longer the lineage that wrote row r's slab, so a write at its frozen
        position would clobber bytes that other beams still read through the
        indirection; every row that reaches S - 1 writes it itself before it
        attends over it."""
        B, T = s.tokens.shape
        buf_idx = (s.seq_lens - 1).clamp(0, T - 1)
        newest = s.tokens[torch.arange(B, device=self.device), buf_idx.long()]
        kw = {}
        if beam_width > 1:
            kw = dict(beam=(beam_width, s.beam_indir), kv_skip=s.finished,
                      kv_skip_mode="sacrifice_last")
        positions = buf_idx.to(torch.int32)
        if s.pos_offset is not None:
            positions = positions + s.pos_offset
        hidden, s.cache = model.decode_step(
            self.config, self.params, newest, positions, s.cache,
            rotary_tables=rotary_tables, fused=self.runtime.fused_decode, mesh=self.mesh,
            microbatches=pipeline.microbatches(self.mesh, self.runtime.pp_microbatches, B,
                                               beam_width),
            **kw,
        )
        s.logits = model.lm_logits(self.config, self.params, hidden, self.mesh)
        self.decode_forwards += 1

    def _prefill_state(self, st: _Statics, inputs) -> DecodeState:
        cfg = self.config
        B = st.batch
        tokens = inputs["tokens"]
        input_lengths = inputs["input_lengths"]
        rt = self.runtime
        cache = kv_cache.init_cache(cfg, B, st.total_len + st.prompt_width, self._cache_dtype(),
                                    self.device, kv_heads=self.kv_heads[1],
                                    layers=self.stage[1])
        pos_offset = None

        def chunk_fn(toks, pos, cache, active, embeds=None):
            return model.prefill_chunk(cfg, self.params, toks, pos, cache, active,
                                       fused=rt.fused_decode, a8=rt.act_int8, embeds=embeds,
                                       mesh=self.mesh)

        if st.prompt_width:
            # the prompt holds slots [0, p_len) of its row; the input
            # prefills as one chunk at p_len (the chunk program's dense
            # attention over the prompt and the input)
            pos_offset = inputs["prompt_lengths"]
            active = torch.ones(B, dtype=torch.bool, device=self.device)
            if st.prompt_kind == "prefix":
                kv_cache.write_prefix(cache, inputs["prefix_k"], inputs["prefix_v"])
            else:
                emb = inputs["prompt_embeds"].to(self.params["final_ln_w"].dtype)
                dummy = torch.zeros((B, st.prompt_width), dtype=torch.int32, device=self.device)
                chunk_fn(dummy, torch.zeros_like(pos_offset), cache, active, embeds=emb)
            hidden, cache = chunk_fn(tokens[:, : st.input_width], pos_offset, cache, active)
        else:
            hidden, cache = model.prefill(
                cfg, self.params, tokens[:, : st.input_width], input_lengths, cache,
                fused=rt.fused_decode, a8=rt.act_int8, mesh=self.mesh,
                microbatches=pipeline.microbatches(self.mesh, rt.pp_microbatches, st.input_width),
            )
        logits = model.lm_logits(cfg, self.params, model.last_token_hidden(hidden, input_lengths),
                                 self.mesh)
        generators = None
        if not st.greedy:
            generators = [
                torch.Generator(device=self.device).manual_seed(int(seed))
                for seed in inputs["random_seed"]
            ]
        return DecodeState(
            tokens=tokens,
            seq_lens=input_lengths.clone(),
            finished=torch.zeros(B, dtype=torch.bool, device=self.device),
            cum_log_probs=torch.zeros(B, dtype=torch.float32, device=self.device),
            logits=logits,
            cache=cache,
            newest=torch.full((B,), cfg.end_id, dtype=torch.int32, device=self.device),
            generators=generators,
            step_log_probs=(
                torch.zeros(B, st.output_len, dtype=torch.float32, device=self.device)
                if st.use_output_log_probs else None
            ),
            pos_offset=pos_offset,
        )

    # -------------------------------------------------------------- host API --
    def _prepare(
        self,
        input_ids: Sequence[Sequence[int]],
        output_len: int,
        top_k=None,
        top_p=None,
        temperature=None,
        repetition_penalty=None,
        presence_penalty=None,
        min_length=None,
        random_seed=None,
        stop_words_list: Optional[np.ndarray] = None,
        bad_words_list: Optional[np.ndarray] = None,
        optional_last_tokens: Optional[np.ndarray] = None,
        prompt_learning_task_name_ids=None,
        request_prompt_embedding=None,
        request_prompt_lengths=None,
        output_log_probs: bool = False,
        return_cum_log_probs: bool = False,
        _longest: int = 0,
    ):
        """(statics, device inputs) of a request; ``_longest``: pad as if the
        longest prompt had this length (a dp group's rows, at the width of
        the whole batch)."""
        cfg = self.config
        B = len(input_ids)
        prompt_kind, prompt_width, prompt_inputs = self._prepare_prompt(
            B, prompt_learning_task_name_ids, request_prompt_embedding, request_prompt_lengths)
        if prompt_width and self.packed_kv():
            raise ValueError(
                "prompt learning requires an unpacked KV cache (int8/bf16): prefix widths are "
                "per-row and may straddle int4 position-pair bytes")
        lengths = np.array([len(x) for x in input_ids], np.int32)
        if not (lengths > 0).all():
            raise ValueError("input len must be larger than zero")
        max_in = max(int(lengths.max()), _longest)
        bucket = max(self.runtime.seq_bucket, 1)
        input_width = max(min(-(-max_in // bucket) * bucket, max_in + bucket), max_in)
        total_len = input_width + int(output_len)
        if self.packed_kv():
            # packed caches pair sequence positions per byte: even widths only
            if input_width % 2:
                raise ValueError(
                    f"int4 KV needs an even prefill width, got {input_width}: use an even "
                    "seq_bucket"
                )
            total_len += total_len % 2

        tokens = np.full((B, total_len), cfg.end_id, np.int32)
        for i, ids in enumerate(input_ids):
            tokens[i, : len(ids)] = np.asarray(ids, np.int32)

        def per_sample(v, default, dtype):
            if v is None:
                return np.full((B,), default, dtype)
            if np.isscalar(v):
                return np.full((B,), v, dtype)
            arr = np.asarray(v, dtype)
            if arr.shape != (B,):
                raise ValueError(f"per-sample parameter of shape {arr.shape}, batch {B}")
            return arr

        top_k = per_sample(top_k, 1, np.int32)
        top_p = per_sample(top_p, 0.0, np.float32)
        temperature = per_sample(temperature, 1.0, np.float32)
        repetition_penalty = per_sample(repetition_penalty, 1.0, np.float32)
        presence_penalty = per_sample(presence_penalty, 0.0, np.float32)
        min_length = per_sample(min_length, 0, np.int32)
        random_seed = per_sample(random_seed, 0, np.int64)

        greedy = bool((top_k == 1).all() and (top_p <= 0.0).all())
        if (top_k > 0).all() and int(top_k.max()) <= 128:
            sampling_cap = max(64, 1 << int(top_k.max() - 1).bit_length())
        else:
            sampling_cap = 0

        def words_arr(w, pad_mult=4):
            if w is None:
                return np.zeros((B, 2, 1), np.int32)
            w = np.asarray(w, np.int32)
            if w.ndim != 3 or w.shape[:2] != (B, 2):
                raise ValueError(f"word list of shape {w.shape}, expected [{B}, 2, L]")
            return _pad_to(w, max(-(-w.shape[2] // pad_mult) * pad_mult, 1), 2, -1)

        if optional_last_tokens is None:
            olt = np.full((B, 1), -1, np.int32)
        else:
            olt = np.asarray(optional_last_tokens, np.int32)
            olt = _pad_to(olt, max(-(-olt.shape[1] // 4) * 4, 1), 1, -1)

        st = _Statics(
            batch=B,
            input_width=input_width,
            total_len=total_len,
            output_len=int(output_len),
            greedy=greedy,
            use_temperature=bool((temperature != 1.0).any()),
            use_rep_penalty=bool((repetition_penalty != 1.0).any()),
            use_pres_penalty=bool((presence_penalty != 0.0).any()),
            use_min_length=bool((min_length > 0).any()),
            use_stop_words=stop_words_list is not None,
            use_bad_words=bad_words_list is not None,
            use_optional_last=optional_last_tokens is not None,
            sampling_cap=sampling_cap,
            use_output_log_probs=bool(output_log_probs),
            use_cum_log_probs=bool(return_cum_log_probs),
            prompt_width=prompt_width,
            prompt_kind=prompt_kind,
        )
        dev = self.device
        inputs = {
            "tokens": torch.from_numpy(tokens).to(dev),
            "input_lengths": torch.from_numpy(lengths).to(dev),
            "top_k": torch.from_numpy(top_k).to(dev),
            "top_p": torch.from_numpy(top_p).to(dev),
            "temperature": torch.from_numpy(temperature).to(dev),
            "repetition_penalty": torch.from_numpy(repetition_penalty).to(dev),
            "presence_penalty": torch.from_numpy(presence_penalty).to(dev),
            "min_length": torch.from_numpy(min_length).to(dev),
            "random_seed": random_seed.tolist(),
            "stop_words": torch.from_numpy(words_arr(stop_words_list)).to(dev),
            "bad_words": torch.from_numpy(words_arr(bad_words_list)).to(dev),
            "optional_last_tokens": torch.from_numpy(olt).to(dev),
        }
        inputs.update(prompt_inputs)
        return st, inputs

    @torch.inference_mode()
    def generate(
        self,
        input_ids: Sequence[Sequence[int]],
        output_len: int,
        beam_width: int = 1,
        callback: Optional[Callable[[dict], None]] = None,
        beam_search_diversity_rate=None,  # beam-only; ignored for sampling
        len_penalty=None,  # beam-only
        **sampling_kwargs,
    ) -> GenerationOutput:
        """Batched generation. With ``callback`` set, each step's newest
        tokens stream as ``{"last_tokens": [[tok]] * B, "idxs": [[gen_idx]] * B}``
        (gen_idx: 0-based index in the generated region; a finished row
        repeats end_id with its last index) -- the reference's callback
        message format. ``beam_width > 1`` runs beam search
        (``sampling/beam.py``): outputs per beam, best first. With
        ``RuntimeConfig.debug_enabled()`` the weights are swept and a checked
        prefill + decode step runs first (``utils.debug.debug_verify``),
        raising ``DebugCheckError`` at the first non-finite stage. Under dp
        (``mesh.dp > 1``) each dp group generates its block of rows and every
        rank returns the whole batch's output (no ``callback`` then)."""
        if self.mesh is not None and self.mesh.dp > 1:
            return self._generate_dp(input_ids, output_len, beam_width, callback,
                                     beam_search_diversity_rate, len_penalty, sampling_kwargs)
        return self._generate(input_ids, output_len, beam_width, callback,
                              beam_search_diversity_rate, len_penalty, **sampling_kwargs)

    def _generate(self, input_ids, output_len, beam_width, callback, beam_search_diversity_rate,
                  len_penalty, **sampling_kwargs) -> GenerationOutput:
        if self.runtime.debug_enabled():
            from ..utils.debug import debug_verify

            if self.pp > 1:
                raise NotImplementedError("the DEBUG sweep checks the whole layer stack on one "
                                          "rank; it is not served under pipeline parallelism")

            lens = np.array([len(x) for x in input_ids], np.int32)
            padded = np.full((len(input_ids), int(lens.max())), self.config.end_id, np.int32)
            for i, ids in enumerate(input_ids):
                padded[i, : len(ids)] = np.asarray(ids, np.int32)
            debug_verify(self, padded, lens)
        if beam_width != 1:
            return GenerationOutput(*beam_search_generate(
                self, input_ids, output_len, beam_width, callback=callback,
                beam_search_diversity_rate=beam_search_diversity_rate, len_penalty=len_penalty,
                **sampling_kwargs,
            ))
        st, inputs = self._prepare(input_ids, output_len, **sampling_kwargs)
        self.decode_forwards = 0
        s = self._prefill_state(st, inputs)
        rotary_tables = make_rotary_tables(
            st.total_len + st.prompt_width, self.config.rotary_embedding_dim,
            self.config.rotary_base, self.device
        )
        in_lens = inputs["input_lengths"]

        def emit():
            newest = s.newest.tolist()
            idxs = (s.seq_lens - in_lens - 1).tolist()
            callback({
                "last_tokens": [[t] for t in newest],
                "idxs": [[i] for i in idxs],
            })

        while s.gen_step < st.output_len - 1 and not bool(s.finished.all()):
            self._sample_and_advance(st, inputs, s)
            if callback is not None:
                emit()
            self._forward_newest(s, rotary_tables)
        already_done = bool(s.finished.all())
        self._sample_and_advance(st, inputs, s)
        if callback is not None and not already_done:
            emit()

        step_lp = s.step_log_probs
        return GenerationOutput(
            output_ids=s.tokens.cpu().numpy()[:, None, :],
            sequence_lengths=s.seq_lens.cpu().numpy()[:, None],
            cum_log_probs=s.cum_log_probs.cpu().numpy()[:, None],
            output_log_probs=None if step_lp is None else step_lp.cpu().numpy()[:, None, :],
        )

    def _generate_dp(self, input_ids, output_len, beam_width, callback, diversity, len_penalty,
                     sampling_kwargs) -> GenerationOutput:
        """This dp group's contiguous block of rows through ``generate`` at
        the whole batch's padded width, then every group's outputs gathered
        in row order."""
        if callback is not None:
            raise ValueError("streaming callbacks are not served under dp > 1: each dp group "
                             "generates other rows")
        B, mesh = len(input_ids), self.mesh
        rows = np.array_split(np.arange(B), mesh.dp)[mesh.dp_rank]
        lo, hi = (int(rows[0]), int(rows[-1]) + 1) if len(rows) else (0, 0)

        def rows_of(v):
            if v is None or np.isscalar(v):
                return v
            arr = np.asarray(v)
            return arr[lo:hi] if arr.ndim >= 1 and arr.shape[0] == B else v

        out = None
        if hi > lo:
            kw = {k: rows_of(v) for k, v in sampling_kwargs.items()}
            out = self._generate([list(x) for x in input_ids[lo:hi]], output_len, beam_width,
                                 None, rows_of(diversity), rows_of(len_penalty),
                                 _longest=max(len(x) for x in input_ids), **kw)
        parts = [p for p in gather_rows(out, mesh) if p is not None]
        return GenerationOutput(*(
            None if parts[0][i] is None else np.concatenate([p[i] for p in parts], axis=0)
            for i in range(len(parts[0]))))
