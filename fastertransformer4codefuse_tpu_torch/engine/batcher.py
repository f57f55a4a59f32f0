"""Continuous batching scheduler (port of engine/batcher.py).

A fixed pool of decode slots runs one decode tick over all slots; requests
join by chunk-prefilling into a free slot's cache region, one
``prompt_bucket``-wide chunk per tick, and retire the moment they finish.
Per tick, on the engine's device:
  - admission writes a request's tokens and per-slot sampling parameters into
    a free slot (pinned host buffers, asynchronous copies);
  - the chunk step advances every mid-prefill slot by one chunk through the
    layer stack (``models.gptneox.prefill_chunk``: K10 on a paged pool);
  - the decode step runs every slot whose prefill is complete through
    ``decode_step`` (K9 on a paged pool, K4 on dense slabs) and the full
    processor stack with per-slot parameters, in the engine's order:
    optional-last-tokens, bad words, temperature, repetition and presence
    penalties, min length, capped top-k/top-p, stop words.

KV modes: dense slabs ``[L, slots, nKV, max_seq_len, dh]``, or (``paged=``)
one shared page pool behind block tables (``engine/paged_kv.py``), with
admission-time page reservation or (``lazy=True``) just-in-time pages and
preempt-and-recompute under pressure, aged by priority. An engine with a
packed int4 KV cache (``"int4"``, ``"int8k_int4v"``) serves on pages only,
with an even prompt bucket and page size: chunk starts then fall on pair
bytes, while per-row chunk offsets in a dense slab would straddle them.

The device state is mutated in place (no copy of the cache or the token
buffer per tick). Dispatching a tick never synchronises with the device;
with ``pipeline_ticks`` the tick's (token, log-prob, finished, ready) rows
are copied asynchronously into pinned host buffers behind a CUDA event and
read after the next tick is dispatched, so the host's bookkeeping overlaps
the device's work. Emissions then lag one tick.

Sampling noise comes from one ``torch.Generator`` per sampled request,
seeded with its ``random_seed`` and kept on the ``Request`` across a
preemption, so a resumed request continues its stream (the JAX package's
``steps`` fold-in); greedy requests (top_k 1) draw none. The tokens equal
the JAX pool's for greedy requests; sampled ones follow another generator.

Prompt learning (``prompt_table={task: (kv [L, 2, kv_heads, P, dh], len)}``,
dense slabs only, as in the JAX package): every slot's cache holds
``prompt_width`` (the longest prompt padded to 8) slots ahead of its
``max_seq_len``; admission writes a request's prefix K/V into its slot's
first slots and its prompt length into ``pos_offset``, so that its chunks
and decode steps write and rotate at buffer index + offset. A request with no
task has offset 0.

Under tensor parallelism (the engine's ``mesh``) the slabs and pages hold
the rank's KV heads (``parallel.sharding.cache_heads``) and every chunk and
decode tick runs the model's collectives: each rank of the tp group must
drive its pool in lockstep, with the same requests submitted in the same
order and the same calls to ``step`` / ``run``: the threaded servers do so
under a mesh by serving in lockstep (``parallel/lockstep.py``), rank 0
publishing each round's admissions under its uids. The logits are
all-gathered and so the same bytes on every rank, and each request's
generator is seeded alike, so every rank emits the same tokens. A dp axis
plays no part in a pool: each dp group drives a pool of its own (under tp
or pp in lockstep, the same requests; on a dp-only mesh each rank serves
its own clients).

On a pipeline mesh (``pp > 1``, ``parallel/pipeline.py``) a dense pool's
slabs hold the rank's stage of the layers, and its chunk and decode ticks
run the model's ``prefill_chunk`` / ``decode_step`` through the stages (one
microbatch, as the JAX pool's ticks), driven in lockstep on every rank of
the mesh as under tp; paged pools refuse pp, as in the JAX package. Not ported: the JAX package's v5e
flash-decode gates.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models import gptneox as model
from ..ops.rotary import make_rotary_tables
from ..sampling import processors as proc
from ..sampling.sample import gumbel_noise, sample_top_k_top_p_capped
from . import kv_cache
from .paged_kv import PageAllocator, init_paged_cache


def encode_word_list(words: Optional[Sequence[Sequence[int]]], width: int) -> np.ndarray:
    """[[token ids]] -> the reference's [2, width] flat-ids + cumulative-offsets
    row pair (-1 padded). Single-request variant."""
    out = np.full((2, width), -1, np.int32)
    if not words:
        return out
    flat: List[int] = []
    offs: List[int] = []
    for w in words:
        flat.extend(int(t) for t in w)
        offs.append(len(flat))
    if len(flat) > width:
        raise ValueError(f"word list ({len(flat)} ids) exceeds pool width {width}")
    out[0, : len(flat)] = flat
    out[1, : len(offs)] = offs
    return out


@dataclasses.dataclass
class Request:
    uid: int
    prompt: List[int]
    output_len: int
    top_k: int = 1
    top_p: float = 0.0
    temperature: float = 1.0
    repetition_penalty: float = 1.0
    presence_penalty: float = 0.0
    min_length: int = 0
    random_seed: int = 0
    # admission priority: lower admits first among pending requests (FIFO
    # within a class, ties on uid); lazy paged pools also preempt by it
    priority: int = 0
    stop_words: Optional[Sequence[Sequence[int]]] = None
    bad_words: Optional[Sequence[Sequence[int]]] = None
    optional_last_tokens: Optional[Sequence[int]] = None
    # streaming hooks (called on the thread that drives the pool)
    on_token: Optional[Callable[[int], None]] = None
    on_text: Optional[Callable[[str], None]] = None
    tokenizer: Optional[object] = None
    # filled on completion
    output_ids: Optional[List[int]] = None
    done: bool = False
    slot: int = -1
    # accumulated as tokens emit (real values only with return_log_probs)
    cum_log_prob: float = 0.0
    step_log_probs: Optional[List[float]] = None
    # times this request was preempted (lazy paged pools; recompute on resume)
    preemptions: int = 0
    # prompt-learning task id (pools built with prompt_table=...)
    prompt_task_id: Optional[int] = None
    # beam pools (engine/beam_pool.BeamPool) only: the request's beam knobs
    # and, on completion, every beam best-first (output_ids is beam 0)
    beam_search_diversity_rate: float = 0.0
    len_penalty: float = 0.0
    beam_output_ids: Optional[List[List[int]]] = None
    beam_cum_log_probs: Optional[List[float]] = None
    _decoder: Optional[object] = None
    _chunks_left: int = 0
    _pages: Optional[List[int]] = None  # paged pools: this request's page ids
    # prompt + generated-so-far to re-prefill after a preemption
    _resume_ids: Optional[List[int]] = None
    _admit_ids: Optional[List[int]] = None  # the ids prefilled at the last admission
    _new_ids: Optional[List[int]] = None  # tokens emitted since the last admission
    _gen: Optional[torch.Generator] = None  # the sampling noise stream


# process-wide uid stream: requests stay uniquely addressable even when
# several pools coexist (engine/server.MultiPoolServer routes by uid)
_UIDS = itertools.count()


class ContinuousBatcher:
    """Slot-pool scheduler over a GptNeoXEngine's model functions.

    ``decode_ticks`` and ``chunk_ticks`` count the decode and chunk steps
    dispatched so far; ``preemptions`` the lazy pool's evictions. The device
    state holds ``rows = max_slots * _row_mult`` rows: one per slot here,
    ``beam_width`` per slot in a beam pool (``engine/beam_pool.py``);
    admission, ``running`` and retirement go by slot."""

    _row_mult = 1
    # a SpecPool (engine/spec_pool.py) serves speculative requests only, and
    # only it does: the servers route by this
    speculative = False

    def __init__(
        self,
        engine,
        max_slots: int = 8,
        max_seq_len: int = 2048,
        prompt_bucket: int = 128,
        stop_words_width: int = 16,
        bad_words_width: int = 16,
        optional_last_width: int = 8,
        sampling_cap: int = 64,
        return_log_probs: bool = False,
        paged: Optional[dict] = None,  # {"num_pages": P, "page_size": 256, "lazy": False}
        pipeline_ticks: bool = False,
        prompt_table: Optional[dict] = None,
    ):
        if max_seq_len % prompt_bucket:
            raise ValueError("max_seq_len must be a multiple of prompt_bucket")
        self.engine = engine
        self.cfg = engine.config
        self.device = engine.device
        self.max_slots = max_slots
        self.rows = max_slots * self._row_mult
        self.max_seq_len = max_seq_len
        self.prompt_bucket = prompt_bucket
        self.stop_words_width = stop_words_width
        self.bad_words_width = bad_words_width
        self.optional_last_width = optional_last_width
        self.sampling_cap = sampling_cap
        self.return_log_probs = return_log_probs
        self.pipeline_ticks = pipeline_ticks
        self.paged = dict(paged) if paged else None
        self.lazy = False
        if engine.pp > 1 and self.paged is not None:
            raise ValueError("paged pools under pipeline parallelism are not supported — use a "
                             "dense pool")
        if engine.packed_kv():
            if self.paged is None:
                raise ValueError(
                    "a dense pool needs an unpacked KV cache (int8/bf16): per-row chunk offsets "
                    "straddle int4 position-pair bytes; serve packed int4 KV on pages (paged=)"
                )
            if prompt_bucket % 2:  # the page size, a multiple of it, is then even too
                raise ValueError("packed int4 pages need an even prompt_bucket and page_size")
        if self.paged is not None:
            self.page_size = int(self.paged.get("page_size", 256))
            if self.page_size % prompt_bucket or max_seq_len % self.page_size:
                raise ValueError(
                    "page_size must be a multiple of prompt_bucket (chunk writes stay within "
                    "one page) and divide max_seq_len"
                )
            self.allocator = PageAllocator(int(self.paged["num_pages"]))
            # lazy=True: admission reserves only the prompt's pages; decode
            # pages come just in time, and on exhaustion the worst
            # (priority, uid) slot is preempted and later recomputed
            self.lazy = bool(self.paged.get("lazy", False))
        self.prompt_table = None
        self.prompt_width = 0
        if prompt_table:
            self._set_prompt_table(prompt_table)
        self.preemptions = 0
        self.decode_ticks = 0
        self.chunk_ticks = 0
        self._uid = _UIDS
        self.pending: List[Request] = []
        self.running: Dict[int, Request] = {}  # slot -> request
        self.requests: Dict[int, Request] = {}  # uid -> every submitted request
        self._inflight: List[tuple] = []  # dispatched, not-yet-fetched ticks
        self._pinned = self.device.type == "cuda"
        self._state = self._init_state()
        cfg = self.cfg
        self._rotary = make_rotary_tables(
            max_seq_len + self.prompt_width, cfg.rotary_embedding_dim, cfg.rotary_base,
            self.device
        )
        self._zero_noise = torch.zeros(
            (self.rows, min(sampling_cap, cfg.vocab_size)), dtype=torch.float32, device=self.device
        )

    def _set_prompt_table(self, table: dict) -> None:
        """Check and keep the prefix tables (fp32 on the pool's device); the
        prompt width is the longest prompt padded to 8."""
        if self.paged is not None:
            raise ValueError("prompt learning in paged pools is not supported (block tables "
                             "carry no prefix region): use a dense pool")
        self.prompt_table = kv_cache.prompt_tables(self.cfg, table, self.device,
                                                   heads=self.engine.kv_heads,
                                                   layers=self.engine.stage)
        longest = max(n for _, n in self.prompt_table.values())
        self.prompt_width = -(-longest // 8) * 8

    # ------------------------------------------------------------ state ----
    def _init_state(self):
        cfg, S, B, dev = self.cfg, self.max_seq_len, self.rows, self.device
        dt = self.engine._cache_dtype()
        nkv = self.engine.kv_heads[1]
        if self.paged is not None:
            cache = init_paged_cache(cfg, B, S, int(self.paged["num_pages"]), self.page_size,
                                     dt, dev, kv_heads=nkv)
        else:
            cache = kv_cache.init_cache(cfg, B, S + self.prompt_width, dt, dev, kv_heads=nkv,
                                        layers=self.engine.stage[1])

        def full(shape, value, dtype):
            return torch.full(shape, value, dtype=dtype, device=dev)

        i32, f32 = torch.int32, torch.float32
        return {
            "tokens": full((B, S), cfg.end_id, i32),
            "seq_lens": full((B,), 0, i32),
            "stop_at": full((B,), 0, i32),  # seq_len limit per slot
            "input_lens": full((B,), 0, i32),
            "prefill_pos": full((B,), 0, i32),  # cache slots filled so far
            "active": full((B,), False, torch.bool),
            "cache": cache,
            "top_k": full((B,), 1, i32),
            "top_p": full((B,), 0.0, f32),
            "temperature": full((B,), 1.0, f32),
            "rep_penalty": full((B,), 1.0, f32),
            "pres_penalty": full((B,), 0.0, f32),
            "min_length": full((B,), 0, i32),
            "stop_words": full((B, 2, self.stop_words_width), -1, i32),
            "bad_words": full((B, 2, self.bad_words_width), -1, i32),
            "olt": full((B, self.optional_last_width), -1, i32),
            "steps": full((B,), 0, i32),  # tokens generated since the first admission
            # prompt learning: cache slot / rotary offset of buffer index 0
            "pos_offset": full((B,), 0, i32),
        }

    def _h2d(self, arr: np.ndarray) -> torch.Tensor:
        """A host array on the pool's device. On CUDA it goes through pinned
        memory with an asynchronous copy, so admission does not wait for the
        ticks in flight."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self._pinned:
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    # -------------------------------------------------------- admission ----
    def make_request(self, prompt: Sequence[int], output_len: int, uid: Optional[int] = None,
                     **kw) -> Request:
        """Validate and build a Request without enqueueing it (uid assignment
        is atomic under the GIL, so this is safe from any thread). ``uid``:
        the leader's, where a follower of a lockstep front end builds the
        request it published (``engine/server.py``)."""
        r = Request(uid=next(self._uid) if uid is None else uid, prompt=list(prompt),
                    output_len=output_len, **kw)
        if not 1 <= r.top_k <= self.sampling_cap:
            raise ValueError(f"pool supports top_k in [1, {self.sampling_cap}]")
        if len(r.prompt) + r.output_len > self.max_seq_len:
            raise ValueError(
                f"prompt({len(r.prompt)}) + output({r.output_len}) exceeds the pool's "
                f"max_seq_len {self.max_seq_len}"
            )
        if self.lazy:
            # a single request must fit the whole pool even alone, or lazy
            # growth would preempt it against itself forever
            total = self.allocator.pages_needed(len(r.prompt) + r.output_len, self.page_size)
            if total > self.allocator.n_pages - 1:
                raise ValueError(
                    f"request needs {total} pages; pool has {self.allocator.n_pages - 1} "
                    "allocatable"
                )
        if r.prompt_task_id is not None:
            if self.prompt_table is None:
                raise ValueError("pool has no prompt_table; build the batcher with "
                                 "prompt_table={task: (kv, len)} to serve prompt learning")
            if r.prompt_task_id not in self.prompt_table:
                raise ValueError(f"unknown prompt task {r.prompt_task_id}")

        # widths validate here, on the client thread: a failure on the
        # driver thread would kill the whole pool
        def wl_len(words):
            return sum(len(w) for w in words) if words else 0

        if wl_len(r.stop_words) > self.stop_words_width:
            raise ValueError(
                f"stop_words need {wl_len(r.stop_words)} ids; pool width is "
                f"{self.stop_words_width}"
            )
        if wl_len(r.bad_words) > self.bad_words_width:
            raise ValueError(
                f"bad_words need {wl_len(r.bad_words)} ids; pool width is {self.bad_words_width}"
            )
        if r.optional_last_tokens and len(r.optional_last_tokens) > self.optional_last_width:
            raise ValueError(
                f"optional_last_tokens ({len(r.optional_last_tokens)}) exceed the pool's "
                f"optional_last_width {self.optional_last_width}"
            )
        return r

    def enqueue(self, r: Request) -> None:
        """Driver-thread-only: add a built request to the admission queue."""
        self.pending.append(r)
        self.requests[r.uid] = r

    def submit(self, prompt: Sequence[int], output_len: int, **kw) -> int:
        r = self.make_request(prompt, output_len, **kw)
        self.enqueue(r)
        return r.uid

    def _free_slots(self) -> List[int]:
        return [b for b in range(self.max_slots) if b not in self.running]

    def _stop_at(self, r: Request) -> int:
        return min(len(r.prompt) + r.output_len, self.max_seq_len)

    def _lazy_bound(self, r: Request, margin: int = 2) -> int:
        """Highest sequence position (exclusive) this request can touch within
        ``margin`` future ticks, capped at its stop length."""
        return min(len(r._admit_ids) + len(r._new_ids) + margin, self._stop_at(r))

    def _pt_row(self, pages: List[int]) -> np.ndarray:
        row = np.zeros((self.max_seq_len // self.page_size,), np.int32)
        row[: len(pages)] = pages
        return row

    def _admit(self, r: Request, slot: int) -> None:
        """Install ``r`` in ``slot``: its ids (the prompt, or after a
        preemption the prompt and the tokens generated so far) and its
        parameters, in one int32 and one fp32 host-to-device copy."""
        S = self.max_seq_len
        src = r._resume_ids if r._resume_ids is not None else r.prompt
        gen_offset = len(src) - len(r.prompt)
        ids = np.full((S,), self.cfg.end_id, np.int32)
        ids[: len(src)] = src
        olt = np.full((self.optional_last_width,), -1, np.int32)
        if r.optional_last_tokens:
            olt[: len(r.optional_last_tokens)] = list(r.optional_last_tokens)
        r._admit_ids = list(src)
        r._new_ids = []
        if self.paged is not None:
            # reservation: every page the request can ever touch; lazy: the
            # prompt's pages (+2-tick margin), the rest just in time
            cap = self._lazy_bound(r) if self.lazy else self._stop_at(r)
            r._pages = self.allocator.alloc(self.allocator.pages_needed(cap, self.page_size))
        p_off = 0 if r.prompt_task_id is None else self.prompt_table[r.prompt_task_id][1]
        ints = [
            ids,
            # in_len, stop_at, top_k, min_length (counted from the original
            # first generated token), steps (keeps the first-step-only
            # optional-last-tokens mask where an uninterrupted run has it),
            # the prompt's offset
            np.array([len(src), self._stop_at(r), r.top_k, max(0, r.min_length - gen_offset),
                      gen_offset, p_off], np.int32),
            encode_word_list(r.stop_words, self.stop_words_width).ravel(),
            encode_word_list(r.bad_words, self.bad_words_width).ravel(),
            olt,
        ]
        if self.paged is not None:
            ints.append(self._pt_row(r._pages))
        iv = self._h2d(np.concatenate(ints))
        fv = self._h2d(np.array([r.top_p, r.temperature, r.repetition_penalty,
                                 r.presence_penalty], np.float32))
        st = self._state
        o = 0

        def take(n):
            nonlocal o
            o += n
            return iv[o - n: o]

        st["tokens"][slot] = take(S)
        sc = take(6)
        for i, name in enumerate(("input_lens", "stop_at", "top_k", "min_length", "steps",
                                  "pos_offset")):
            st[name][slot] = sc[i]
        st["seq_lens"][slot] = sc[0]
        st["prefill_pos"][slot] = 0
        st["active"][slot] = True
        st["stop_words"][slot] = take(2 * self.stop_words_width).view(2, -1)
        st["bad_words"][slot] = take(2 * self.bad_words_width).view(2, -1)
        st["olt"][slot] = take(self.optional_last_width)
        if self.paged is not None:
            st["cache"]["pt"][slot] = take(self.max_seq_len // self.page_size)
        for i, name in enumerate(("top_p", "temperature", "rep_penalty", "pres_penalty")):
            st[name][slot] = fv[i]
        if r.prompt_task_id is not None:
            # the task's K/V into the slot's first slots (quantized per vector
            # on an int8 cache); the slots past its length are the input's
            kv, _ = self.prompt_table[r.prompt_task_id]
            kv_cache.write_prefix(st["cache"], kv[:, 0], kv[:, 1], row=slot)
        if r._gen is None and r.top_k > 1:
            r._gen = torch.Generator(device=self.device).manual_seed(int(r.random_seed))
        r.slot = slot
        # host mirror of the device's prefill progress: every chunk step
        # advances each mid-prefill slot by one bucket, and the chunks cover
        # [0, len - 1) (the first decode tick writes the last prompt token)
        r._chunks_left = -(-max(len(src) - 1, 0) // self.prompt_bucket)
        self.running[slot] = r
        if r.on_text is not None and r.tokenizer is not None and r._decoder is None:
            # kept across a preemption: the decoder is stateful
            from ..api.detok import TokenStreamDecoder

            r._decoder = TokenStreamDecoder(self.cfg.end_id, r.tokenizer, on_text=r.on_text)

    def _eff_key(self, r: Request):
        """Admission / victim order with priority aging: every preemption
        promotes the request one class, so sustained higher-priority
        pressure cannot starve it; ties stay FIFO by uid."""
        return (r.priority - r.preemptions, r.uid)

    def _admit_pending(self) -> None:
        for slot in self._free_slots():
            if not self.pending:
                break
            nxt = min(range(len(self.pending)), key=lambda i: self._eff_key(self.pending[i]))
            if self.paged is not None:
                r = self.pending[nxt]
                if self.lazy:
                    cap = min(len(r._resume_ids or r.prompt) + 2, self._stop_at(r))
                else:
                    cap = self._stop_at(r)
                if not self.allocator.can(self.allocator.pages_needed(cap, self.page_size)):
                    # head-of-line blocking keeps strict priority order;
                    # running requests hold or will release pages
                    break
            self._admit(self.pending.pop(nxt), slot)

    # -------------------------------------------- lazy paging / preemption --
    def _write_pt(self, slot: int, r: Request) -> None:
        self._state["cache"]["pt"][slot] = self._h2d(self._pt_row(r._pages))

    def _preempt(self, r: Request) -> None:
        """Evict a running request: keep prompt + generated on the host, free
        its pages, and re-queue it to be recomputed on re-admission."""
        # flush the ticks in flight first, so emissions go to the slot's
        # current occupant and the host mirror is complete
        self._flush()
        if r.done or r.slot < 0:
            return  # finished (or already evicted) during the flush
        slot = r.slot
        r._resume_ids = r._admit_ids + r._new_ids
        if r._pages:
            self.allocator.release(r._pages)
        r._pages = None
        self._state["active"][slot] = False
        # the slot's table points at the garbage page until it is reused
        self._state["cache"]["pt"][slot] = 0
        del self.running[slot]
        r.slot = -1
        r.preemptions += 1
        self.preemptions += 1
        self.pending.append(r)

    def _ensure_pages(self) -> None:
        """Lazy mode: grow each running slot's block table just in time; on
        exhaustion preempt strictly worse (priority, uid) slots, and if the
        positions the dispatched ticks will touch still cannot be covered,
        preempt the needing slot itself (an unmapped entry would send its
        writes to the garbage page)."""
        margin = len(self._inflight) + 2

        def stale(r, slot):
            # a flush inside _preempt can retire or evict any request
            return r.done or r.slot != slot or r._pages is None

        for slot, r in sorted(self.running.items(), key=lambda kv: self._eff_key(kv[1])):
            if stale(r, slot):
                continue
            bound = self._lazy_bound(r, margin)
            grow = self.allocator.pages_needed(bound, self.page_size) - len(r._pages)
            if grow <= 0:
                continue
            while not self.allocator.can(grow):
                victims = [
                    v for v in self.running.values()
                    if self._eff_key(v) > self._eff_key(r) and v._pages
                ]
                if not victims:
                    break
                self._preempt(max(victims, key=self._eff_key))
                if stale(r, slot):
                    break
            if stale(r, slot):
                continue
            if self.allocator.can(grow):
                r._pages.extend(self.allocator.alloc(grow))
                self._write_pt(slot, r)
                continue
            hard = self._lazy_bound(r, len(self._inflight) + 1)
            if len(r._pages) * self.page_size < hard:
                self._preempt(r)

    # ------------------------------------------------------------- ticks ----
    def _chunk(self) -> None:
        """Advance every mid-prefill slot by one prompt_bucket-wide chunk."""
        st, C, S = self._state, self.prompt_bucket, self.max_seq_len
        target = torch.clamp(st["input_lens"] - 1, min=0)
        prefilling = st["active"] & (st["prefill_pos"] < target)
        buf_pos = torch.clamp(st["prefill_pos"], 0, S - C)
        cols = buf_pos.long()[:, None] + torch.arange(C, device=self.device)[None, :]
        tok_chunk = st["tokens"].gather(1, cols)  # [B, C]
        # cache slot / rotary position = buffer index + the prompt's offset
        rt, eng = self.engine.runtime, self.engine
        args = (tok_chunk, buf_pos + st["pos_offset"], st["cache"], prefilling)
        kw = dict(rotary_tables=self._rotary, fused=rt.fused_decode, a8=rt.act_int8)
        model.prefill_chunk(self.cfg, eng.params, *args, mesh=eng.mesh, **kw)
        st["prefill_pos"] += prefilling.to(torch.int32) * C
        self.chunk_ticks += 1

    def _process_logits(self, st, logits: torch.Tensor) -> torch.Tensor:
        """The processor stack in the engine's order, with per-slot
        parameters: optional-last-tokens (first step only), bad words,
        temperature, repetition and presence penalties, min length."""
        S, end_id = self.max_seq_len, self.cfg.end_id
        first = st["steps"] == 0
        masked = proc.apply_optional_last_tokens(logits, st["olt"], 1, True)
        logits = torch.where(first[:, None], masked, logits)
        logits = proc.ban_bad_words(logits, st["tokens"], st["seq_lens"], st["bad_words"], 1)
        logits = proc.apply_temperature(logits, st["temperature"])
        buf_valid = torch.arange(S, device=logits.device)[None, :] < st["seq_lens"][:, None]
        logits = proc.apply_repetition_penalty(logits, st["tokens"], buf_valid, st["rep_penalty"])
        logits = proc.apply_presence_penalty(logits, st["tokens"], buf_valid, st["pres_penalty"])
        gen_lens = st["seq_lens"] - st["input_lens"]
        return proc.apply_min_length(logits, gen_lens, st["min_length"], end_id)

    def _noise(self) -> torch.Tensor:
        """[slots, min(cap, V)] Gumbel noise: a row from the request's own
        generator for each sampled request that decodes this tick, zeros
        elsewhere (greedy rows keep only their argmax)."""
        gens = []
        for b in range(self.max_slots):
            r = self.running.get(b)
            ready = r is not None and r._gen is not None and r._chunks_left == 0
            gens.append(r._gen if ready else None)
        if not any(g is not None for g in gens):
            return self._zero_noise
        n = self._zero_noise.shape[1]
        return torch.stack([
            self._zero_noise[b] if g is None else gumbel_noise([g], n, self.device)[0]
            for b, g in enumerate(gens)
        ])

    def _step(self):
        """One decode tick over all slots; returns device tensors (tok, lp,
        finished, ready), one row per slot."""
        st, S, end_id = self._state, self.max_seq_len, self.cfg.end_id
        target = torch.clamp(st["input_lens"] - 1, min=0)
        ready = st["active"] & (st["prefill_pos"] >= target)
        # forward the last real token of every ready slot; the other rows run
        # a position-0 dummy whose cache write lands where no row reads it
        buf_idx = torch.clamp(st["seq_lens"] - 1, 0, S - 1)
        newest = st["tokens"].gather(1, buf_idx.long()[:, None])[:, 0]
        positions = torch.where(ready, buf_idx + st["pos_offset"], torch.zeros_like(buf_idx))
        eng = self.engine
        args = (newest, positions, st["cache"])
        kw = dict(rotary_tables=self._rotary, kv_skip=~ready, kv_skip_mode="sacrifice_last",
                  fused=eng.runtime.fused_decode)
        hidden, _ = model.decode_step(self.cfg, eng.params, *args, mesh=eng.mesh, **kw)
        logits = self._process_logits(st, model.lm_logits(self.cfg, self.engine.params, hidden,
                                                          self.engine.mesh))
        res = sample_top_k_top_p_capped(
            logits, st["top_k"], st["top_p"], self._noise(), cap=self.sampling_cap,
            need_log_probs=self.return_log_probs,
        )
        tok = torch.where(ready, res.tokens, torch.full_like(res.tokens, end_id))
        lp = torch.where(ready, res.log_probs, torch.zeros_like(res.log_probs))
        write_idx = torch.clamp(st["seq_lens"], 0, S - 1).long()[:, None]
        old = st["tokens"].gather(1, write_idx)[:, 0]
        st["tokens"].scatter_(1, write_idx, torch.where(ready, tok, old)[:, None])
        st["seq_lens"] += ready.to(torch.int32)
        finished = ready & ((tok == end_id) | (st["seq_lens"] >= st["stop_at"]))
        finished |= ready & proc.stop_words_criterion(
            st["tokens"], st["seq_lens"], st["stop_words"], 1
        )
        st["active"] &= ~finished
        st["steps"] += ready.to(torch.int32)
        self.decode_ticks += 1
        return tok, lp, finished, ready

    def _dispatch_tick(self):
        """Enqueue a chunk step (when a slot is mid-prefill) and one decode
        tick; returns the tick's device rows, or None when nothing runs.
        Nothing here waits for the device."""
        if not self.running:
            return None
        if any(r._chunks_left > 0 for r in self.running.values()):
            self._chunk()
            for r in self.running.values():
                if r._chunks_left > 0:
                    r._chunks_left -= 1
        return self._step()

    def _start_fetch(self, out):
        """Copy a tick's rows toward the host: on CUDA asynchronously into
        pinned buffers, behind an event."""
        if not self._pinned:
            return out, None
        host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in out)
        for h, t in zip(host, out):
            h.copy_(t, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return host, ev

    @staticmethod
    def _fetch(item):
        host, ev = item
        if ev is not None:
            ev.synchronize()
        return tuple(h.cpu().numpy() for h in host)

    def _flush(self) -> None:
        while self._inflight:
            self._process_results(self._fetch(self._inflight.pop(0)))

    def step(self) -> List[Tuple[int, int, bool]]:
        """Admit pending requests into free slots, advance chunked prefills by
        one chunk, run one decode tick. Returns [(uid, token, finished)] for
        slots that produced a token.

        With ``pipeline_ticks`` the new tick is dispatched before the previous
        tick's rows are read, so emissions lag one tick; attribution stays
        right because a slot whose request finished reports ready=False on
        the tick in flight."""
        if self.lazy:
            self._ensure_pages()
        self._admit_pending()
        out = self._dispatch_tick()
        if not self.pipeline_ticks:
            return [] if out is None else self._process_results(self._fetch(self._start_fetch(out)))
        if out is not None:
            self._inflight.append(self._start_fetch(out))
        if not self._inflight or (out is not None and len(self._inflight) == 1):
            # the fresh tick stays in flight; it is read on the next call,
            # after that call's dispatch keeps the device busy
            return []
        return self._process_results(self._fetch(self._inflight.pop(0)))

    def _process_results(self, fetched) -> List[Tuple[int, int, bool]]:
        tok_h, lp_h, fin_h, ready_h = fetched
        emitted = []
        for slot, r in list(self.running.items()):
            if not bool(ready_h[slot]):
                continue  # still chunk-prefilling this tick
            t = int(tok_h[slot])
            done = bool(fin_h[slot])
            emitted.append((r.uid, t, done))
            r._new_ids.append(t)
            if self.return_log_probs:
                r.cum_log_prob += float(lp_h[slot])
                if r.step_log_probs is None:
                    r.step_log_probs = []
                r.step_log_probs.append(float(lp_h[slot]))
            if r.on_token is not None:
                r.on_token(t)
            if r._decoder is not None:
                r._decoder.append_token(t)
            if done:
                r.output_ids = r._admit_ids + r._new_ids
                r.done = True
                if r._decoder is not None and t != self.cfg.end_id:
                    r._decoder.append_token(self.cfg.end_id)  # flush the tail text
                if self.paged is not None and r._pages is not None:
                    self.allocator.release(r._pages)
                    r._pages = None
                del self.running[slot]
        return emitted

    def run(self, max_ticks: int = 100000) -> Dict[int, Request]:
        """Drive until every submitted request completes; returns uid->Request
        for every request ever submitted."""
        for _ in range(max_ticks):
            if not self.pending and not self.running and not self._inflight:
                break
            self.step()
        return dict(self.requests)
