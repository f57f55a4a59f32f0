"""The port's continuous batcher (fastertransformer4codefuse_tpu_torch/engine/
batcher.py) and chunked prefill (models/gptneox.py prefill_chunk, decode_step
with kv_skip) against the JAX package, on a tiny fp32 model with int8 weights
and embeddings made by the JAX package (``from_jax_params``), on the cases of
tests/test_batcher.py, tests/test_paged_batcher.py and
tests/test_paged_preemption.py.

Tolerances: logits within 1e-4 of max |logits| (fp32, summation order
only); greedy pool tokens identical to the JAX pool's; processed logits of a
tick within 1e-6 relative (the same fp32 elementwise ops); sampled requests
(another generator than jax.random) are held to themselves: the same seed
gives the same tokens, alone or among others, preempted or not."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fastertransformer4codefuse_tpu import GptNeoXConfig as JaxConfig
from fastertransformer4codefuse_tpu import GptNeoXEngine as JaxEngine
from fastertransformer4codefuse_tpu import RuntimeConfig as JaxRuntime
from fastertransformer4codefuse_tpu import init_params as jax_init_params
from fastertransformer4codefuse_tpu.engine import kv_cache as jkvc
from fastertransformer4codefuse_tpu.engine import paged_kv as jpaged
from fastertransformer4codefuse_tpu.engine.batcher import ContinuousBatcher as JaxBatcher
from fastertransformer4codefuse_tpu.models import gptneox as jm
from fastertransformer4codefuse_tpu.sampling import processors as jproc
from fastertransformer4codefuse_tpu_torch import (
    GptNeoXConfig,
    GptNeoXEngine,
    RuntimeConfig,
    from_jax_params,
)
from fastertransformer4codefuse_tpu_torch.engine import kv_cache as kvc
from fastertransformer4codefuse_tpu_torch.engine import paged_kv as paged
from fastertransformer4codefuse_tpu_torch.engine.batcher import ContinuousBatcher
from fastertransformer4codefuse_tpu_torch.models import gptneox as tm

torch.set_num_threads(2)

PROMPTS = [[3, 4, 5], [9, 8, 7, 6, 5], [11, 12], [20, 21, 22, 23],
           [30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40]]
MODES = {
    "dense": None,
    "paged": dict(num_pages=10, page_size=8),
    "lazy": dict(num_pages=6, page_size=8, lazy=True),
}


@pytest.fixture(scope="module")
def models():
    jcfg = JaxConfig.tiny(head_num=4, size_per_head=8, vocab_size=64)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0), dtype="fp32", int8_mode=1,
                         quantize_embeddings=True)
    rng = np.random.default_rng(1)
    layers = dict(jp["layers"])
    for k, v in layers.items():  # non-trivial biases
        if k.endswith("_b"):
            layers[k] = jnp.asarray(rng.standard_normal(v.shape) * 0.1, jnp.float32)
    jp = dict(jp, layers=layers)
    cfg = GptNeoXConfig(**dataclasses.asdict(jcfg))
    return jcfg, jp, cfg, from_jax_params(jp, device="cpu")


def _engines(models, kv="int8"):
    jcfg, jp, cfg, tp = models
    kw = dict(dtype="fp32", int8_mode=1, kv_cache_dtype=kv, seq_bucket=8)
    return JaxEngine(jcfg, jp, JaxRuntime(**kw)), GptNeoXEngine(cfg, tp, RuntimeConfig(**kw))


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("kv", ["fp32", "int8"])
@pytest.mark.parametrize("mode", ["dense", "paged"])
def test_prefill_chunk_and_decode_skip_match_jax(models, kv, mode):
    jcfg, jp, cfg, tp = models
    B, C, Smax = 3, 8, 32
    jdt, tdt = {"fp32": (jnp.float32, torch.float32), "int8": (jnp.int8, torch.int8)}[kv]
    if mode == "dense":
        jc = jkvc.init_cache(jcfg, B, Smax, jdt)
        tc = kvc.init_cache(cfg, B, Smax, tdt, "cpu")
    else:
        jc = jpaged.init_paged_cache(jcfg, B, Smax, n_pages=14, page_size=8, dtype=jdt)
        tc = paged.init_paged_cache(cfg, B, Smax, 14, 8, tdt, "cpu")
        pt = np.random.default_rng(2).permutation(np.arange(1, 14))[:12].reshape(3, 4)
        jc["pt"], tc["pt"] = jnp.asarray(pt, jnp.int32), torch.from_numpy(pt.astype(np.int32))
    rng = np.random.default_rng(3)
    ids = rng.integers(2, jcfg.vocab_size, (B, 2 * C)).astype(np.int32)

    @jax.jit
    def jchunk(p, tok, pos, c, act):
        h, c = jm.prefill_chunk(jcfg, p, tok, pos, c, act)
        return jm.lm_logits(jcfg, p, h), c

    @jax.jit
    def jdecode(p, tok, pos, c, skip):
        h, c = jm.decode_step(jcfg, p, tok, pos, c, kv_skip=skip, kv_skip_mode="sacrifice_last")
        return jm.lm_logits(jcfg, p, h), c

    # two chunks; row 2 sits the second one out (inactive: its bytes stay)
    for step, active in enumerate(([True, True, True], [True, True, False])):
        tok = ids[:, step * C:(step + 1) * C]
        pos = np.full((B,), step * C, np.int32)
        act = np.array(active)
        jl, jc = jchunk(jp, jnp.asarray(tok), jnp.asarray(pos), jc, jnp.asarray(act))
        h, _ = tm.prefill_chunk(cfg, tp, torch.from_numpy(tok), torch.from_numpy(pos), tc,
                                torch.from_numpy(act))
        rows = np.flatnonzero(act)  # an inactive row's chunk output is discarded
        assert _rel(tm.lm_logits(cfg, tp, h).numpy()[rows], np.asarray(jl)[rows]) < 1e-4, step
    lens = np.array([2 * C, 2 * C, C], np.int32)
    for t in range(3):
        tok = rng.integers(2, jcfg.vocab_size, B).astype(np.int32)
        pos = lens + t
        skip = np.array([False, t == 1, False])  # row 1 skips one step
        pos = np.where(skip, 0, pos).astype(np.int32)
        jl, jc = jdecode(jp, jnp.asarray(tok), jnp.asarray(pos), jc, jnp.asarray(skip))
        h, _ = tm.decode_step(cfg, tp, torch.from_numpy(tok), torch.from_numpy(pos), tc,
                              kv_skip=torch.from_numpy(skip), kv_skip_mode="sacrifice_last")
        rows = np.flatnonzero(~skip)
        assert _rel(tm.lm_logits(cfg, tp, h).numpy()[rows], np.asarray(jl)[rows]) < 1e-4, t


def _run_pool(cls, engine, paged_kw, reqs, late, pipeline=False, slots=2):
    """Submit ``reqs``, tick three times, submit ``late`` mid-flight, drive
    to the end; returns each request's output ids and the pool."""
    cb = cls(engine, max_slots=slots, max_seq_len=32, prompt_bucket=8, paged=paged_kw,
             pipeline_ticks=pipeline)
    uids = [cb.submit(**r) for r in reqs]
    for _ in range(3):
        cb.step()
    uids += [cb.submit(**r) for r in late]
    done = cb.run(max_ticks=600)
    assert all(done[u].done for u in uids)
    return [done[u].output_ids for u in uids], cb


@pytest.mark.parametrize("kv", ["fp32", "int8"])
@pytest.mark.parametrize("mode", list(MODES))
def test_pool_greedy_matches_jax_token_for_token(models, kv, mode):
    je, te = _engines(models, kv)
    lens = [20, 20, 6, 3, 9] if mode == "lazy" else [5, 4, 6, 3, 9]
    reqs = [dict(prompt=p, output_len=n, top_k=1) for p, n in zip(PROMPTS, lens)]
    want, jcb = _run_pool(JaxBatcher, je, MODES[mode], reqs[:2], reqs[2:])
    got, tcb = _run_pool(ContinuousBatcher, te, MODES[mode], reqs[:2], reqs[2:])
    assert got == want
    if mode != "dense":
        assert tcb.allocator.free_pages == tcb.allocator.n_pages - 1  # every page back
    if mode == "lazy":
        assert tcb.preemptions == jcb.preemptions >= 1
    # pipelined ticks: the same tokens, with one tick in flight after the first step
    piped, pcb = _run_pool(ContinuousBatcher, te, MODES[mode], reqs[:2], reqs[2:], pipeline=True)
    assert piped == want and not pcb._inflight


def _hetero_reqs(stop_tok, bad_tok):
    return [
        dict(prompt=[3, 4, 5], output_len=6, top_k=1, stop_words=[[stop_tok]]),
        dict(prompt=[9, 8, 7, 6, 5], output_len=5, top_k=1, temperature=0.8,
             repetition_penalty=1.3),
        dict(prompt=[11, 12], output_len=4, top_k=1, optional_last_tokens=[7, 9, 13]),
        dict(prompt=[20, 21, 22, 23], output_len=5, top_k=1, presence_penalty=0.5,
             min_length=3),
        dict(prompt=list(range(30, 40)), output_len=4, top_k=1, bad_words=[[bad_tok]]),
    ]


def test_pool_heterogeneous_params_and_stop_words_match_jax(models):
    je, te = _engines(models)
    probe = te.generate([[3, 4, 5]], output_len=6, top_k=1)
    reqs = _hetero_reqs(int(probe.output_ids[0, 0, 5]), int(probe.output_ids[0, 0, 3]))
    want, _ = _run_pool(JaxBatcher, je, MODES["paged"], reqs[:2], reqs[2:])
    got, _ = _run_pool(ContinuousBatcher, te, MODES["paged"], reqs[:2], reqs[2:])
    assert got == want
    assert len(got[0]) < 3 + 6  # the stop word ended request 0 early


def test_pool_processed_logits_match_jax(models):
    """One tick's processor stack (optional-last-tokens, bad words,
    temperature, repetition / presence penalty, min length) on the same pool
    state: the state equals the JAX pool's, and the processed logits of
    shared raw logits equal the JAX stack's."""
    je, te = _engines(models)
    reqs = _hetero_reqs(60, 61)
    for r in reqs:  # sampled parameters; the tokens stay greedy (top_k 1)
        r.update(temperature=0.7, repetition_penalty=1.2, presence_penalty=0.3, min_length=2)
    pools = []
    for cls, eng in ((JaxBatcher, je), (ContinuousBatcher, te)):
        cb = cls(eng, max_slots=4, max_seq_len=32, prompt_bucket=8, paged=MODES["paged"])
        for r in reqs[:4]:
            cb.submit(**r)
        for _ in range(3):
            cb.step()
        pools.append(cb)
    js, ts = pools[0]._state, pools[1]._state
    for name in ("tokens", "seq_lens", "input_lens", "stop_at", "steps", "olt", "bad_words",
                 "stop_words", "min_length", "temperature", "rep_penalty", "pres_penalty"):
        np.testing.assert_array_equal(ts[name].numpy(), np.asarray(js[name]), err_msg=name)
    V = je.config.vocab_size
    raw = np.random.default_rng(4).standard_normal((4, V)).astype(np.float32) * 3
    for steps in (None, 0):  # as the pool stands, and with every slot on its first step
        st = dict(js)
        if steps is not None:
            st["steps"] = jnp.zeros_like(js["steps"])
            ts = dict(ts, steps=torch.zeros_like(ts["steps"]))
        logits = jnp.asarray(raw)
        masked = jproc.apply_optional_last_tokens(logits, st["olt"], 1, True)
        logits = jnp.where((st["steps"] == 0)[:, None], masked, logits)
        logits = jproc.ban_bad_words(logits, st["tokens"], st["seq_lens"], st["bad_words"], 1)
        logits = jproc.apply_temperature(logits, st["temperature"])
        buf_valid = jnp.arange(32)[None, :] < st["seq_lens"][:, None]
        logits = jproc.apply_repetition_penalty(logits, st["tokens"], buf_valid, st["rep_penalty"])
        logits = jproc.apply_presence_penalty(logits, st["tokens"], buf_valid, st["pres_penalty"])
        want = jproc.apply_min_length(logits, st["seq_lens"] - st["input_lens"], st["min_length"],
                                      je.config.end_id)
        got = pools[1]._process_logits(ts, torch.from_numpy(raw))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


SAMPLED = dict(top_k=8, top_p=0.9, temperature=0.9, random_seed=42)


def _sampled_run(te, paged_kw, others, prompt=(3, 4, 5), out=16, priority=5, slots=2):
    cb = ContinuousBatcher(te, max_slots=slots, max_seq_len=32, prompt_bucket=8, paged=paged_kw)
    uid = cb.submit(list(prompt), out, priority=priority, **SAMPLED)
    for p, n in others:
        cb.submit(p, n, top_k=1, priority=0)
    done = cb.run(max_ticks=600)
    return done[uid], cb


def test_pool_sampling_is_per_request(models):
    _, te = _engines(models)
    alone, _ = _sampled_run(te, MODES["paged"], [])
    again, _ = _sampled_run(te, MODES["paged"], [])
    assert again.output_ids == alone.output_ids  # same seed, same tokens
    mixed, _ = _sampled_run(te, MODES["paged"], [([9, 8, 7, 6, 5], 10), ([11, 12], 12)])
    assert mixed.output_ids == alone.output_ids  # alone == among other requests
    # a request preempted under page pressure resumes its own noise stream
    lazy = dict(num_pages=5, page_size=8, lazy=True)
    pre, cb = _sampled_run(te, lazy, [([9, 8, 7, 6, 5], 16)])
    assert pre.preemptions >= 1 and cb.preemptions >= 1
    assert pre.output_ids == alone.output_ids
    other = ContinuousBatcher(te, max_slots=2, max_seq_len=32, prompt_bucket=8)
    o = other.requests[other.submit([3, 4, 5], 16, **dict(SAMPLED, random_seed=43))]
    other.run(600)
    assert o.output_ids != alone.output_ids  # another seed, another stream


def test_chunked_admission_does_not_stall_decode(models):
    _, te = _engines(models)
    cb = ContinuousBatcher(te, max_slots=2, max_seq_len=64, prompt_bucket=8)
    a = cb.submit([3, 4, 5], 20, top_k=1, min_length=20)
    cb.step()
    b = cb.submit(list(range(2, 32)), 4, top_k=1)  # four chunk ticks
    emitted_a, saw_b_waiting = 1, False
    for _ in range(12):
        uids = [u for u, _, _ in cb.step()]
        emitted_a += a in uids
        saw_b_waiting |= b not in uids
    assert emitted_a >= 12 and saw_b_waiting
    assert cb.chunk_ticks == 1 + 4  # a's prompt takes one chunk, b's four


def test_streaming_tokens_and_text(models):
    from test_api import CharTokenizer

    _, te = _engines(models)
    tok = CharTokenizer()
    cb = ContinuousBatcher(te, max_slots=2, max_seq_len=32, prompt_bucket=8,
                           pipeline_ticks=True)
    got, text = [], []
    u1 = cb.submit([3, 4, 5], 6, top_k=1, on_token=got.append)
    u2 = cb.submit([9, 8, 7], 6, top_k=1, on_text=text.append, tokenizer=tok)
    done = cb.run(max_ticks=100)
    assert got == done[u1].output_ids[3:]
    gen = [t for t in done[u2].output_ids[3:] if t != te.config.end_id]
    assert "".join(text) == tok.decode(gen)


def test_priority_orders_admission(models):
    _, te = _engines(models)
    cb = ContinuousBatcher(te, max_slots=1, max_seq_len=32, prompt_bucket=8)
    first = cb.submit([3, 4, 5], 2, top_k=1, min_length=2)
    cb.step()
    bulk = [cb.submit([9, 8], 3, top_k=1, min_length=3) for _ in range(3)]
    urgent = cb.submit([11, 12], 2, top_k=1, min_length=2, priority=-1)
    order = [first]
    for _ in range(100):
        for uid, _t, _d in cb.step():
            if uid not in order:
                order.append(uid)
        if not cb.pending and not cb.running:
            break
    assert order == [first, urgent] + bulk


def test_lazy_preemption_respects_priority_and_aging(models):
    _, te = _engines(models)
    cb = ContinuousBatcher(te, max_slots=2, max_seq_len=32, prompt_bucket=8,
                           paged=dict(num_pages=6, page_size=8, lazy=True))
    hi = cb.submit(PROMPTS[0], 20, top_k=1, priority=0)
    lo = cb.submit(PROMPTS[1], 20, top_k=1, priority=5)
    done = cb.run(max_ticks=400)
    assert done[hi].preemptions == 0 and done[lo].preemptions >= 1
    small = ContinuousBatcher(te, max_slots=2, max_seq_len=32, prompt_bucket=8,
                              paged=dict(num_pages=3, page_size=8, lazy=True))
    with pytest.raises(ValueError, match="pages"):
        small.submit(PROMPTS[0], 25, top_k=1)  # needs more pages than the pool has
    cb2 = ContinuousBatcher(te, max_slots=2, max_seq_len=64, prompt_bucket=8,
                            paged=dict(num_pages=9, page_size=8, lazy=True))
    lo2 = cb2.submit(PROMPTS[0], 24, top_k=1, priority=3)
    his = [cb2.submit(PROMPTS[1 + i % 2], 16, top_k=1, priority=0) for i in range(6)]
    done2 = cb2.run(max_ticks=2000)
    assert done2[lo2].done and all(done2[u].done for u in his)
    assert done2[lo2].preemptions <= 4  # aging: the gap of 3 classes, plus one


def test_make_request_validates_widths(models):
    _, te = _engines(models)
    cb = ContinuousBatcher(te, max_slots=2, max_seq_len=32, prompt_bucket=8,
                           stop_words_width=4, bad_words_width=4, optional_last_width=2)
    bad = [
        dict(prompt=[3], output_len=4, top_k=65),  # above the sampling cap
        dict(prompt=[3] * 30, output_len=4),  # longer than max_seq_len
        dict(prompt=[3], output_len=4, stop_words=[[1, 2, 3], [4, 5]]),
        dict(prompt=[3], output_len=4, bad_words=[[1, 2, 3, 4, 5]]),
        dict(prompt=[3], output_len=4, optional_last_tokens=[1, 2, 3]),
        dict(prompt=[3], output_len=4, prompt_task_id=0),
    ]
    for kw in bad:
        with pytest.raises(ValueError):
            cb.make_request(**kw)
    assert not cb.pending  # nothing reached the queue
