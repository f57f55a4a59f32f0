"""The port's beam pool (fastertransformer4codefuse_tpu_torch/engine/
beam_pool.py, ``BatchingServer(beam_width > 1)``, the pooled handler's beam
route) against the JAX ``BeamPool`` and the static beams, on the cases of
tests/test_beam_pool.py; and the sampling pools at one row per slot.
Weights are made by the JAX package (int8, non-trivial norms and biases) and
carried over with ``from_jax_params``.

Tolerances: beams identical to the static path's and to the JAX pool's,
token for token; scores within 1e-5 relative of the static path's on an
fp32 cache (the same fp32 math; the pool prefills by chunks) and within
1e-4 of the JAX pool's. On an int8 cache a chunked prefill may round a KV
code differently from a whole-prompt prefill, so there the pool is held to
the JAX pool, which prefills by the same chunks."""
import json

import numpy as np
import pytest
import torch

from fastertransformer4codefuse_tpu.api.handler import CodeFuseHandler as JaxHandler
from fastertransformer4codefuse_tpu.api.trie import VocabTrie as JaxTrie
from fastertransformer4codefuse_tpu.engine.beam_pool import BeamPool as JaxBeamPool
from fastertransformer4codefuse_tpu_torch.api.handler import CodeFuseHandler
from fastertransformer4codefuse_tpu_torch.api.trie import VocabTrie
from fastertransformer4codefuse_tpu_torch.engine.batcher import ContinuousBatcher
from fastertransformer4codefuse_tpu_torch.engine.beam_pool import BeamPool
from fastertransformer4codefuse_tpu_torch.engine.server import BatchingServer, MultiPoolServer
from test_api import CharTokenizer
from test_torch_beam import _engines, _models

torch.set_num_threads(2)

PROMPTS = [[3, 4, 5], [9, 8, 7, 6, 5], [11, 12], [20, 21, 22, 23]]
OUT_LENS = [5, 4, 6, 3]
KWS = [dict(), dict(beam_search_diversity_rate=0.4), dict(len_penalty=0.8),
       dict(temperature=0.8, repetition_penalty=1.2)]
POOL = dict(max_slots=2, max_seq_len=32, prompt_bucket=8)


@pytest.fixture(scope="module")
def models():
    return _models()


def static_beams(eng, prompt, out_len, bw, **kw):
    o = eng.generate([prompt], output_len=out_len, beam_width=bw, **kw)
    beams = [[int(x) for x in o.output_ids[0, j, : o.sequence_lengths[0, j]]] for j in range(bw)]
    return beams, [float(c) for c in o.cum_log_probs[0]]


def _run(pool, reqs, max_ticks=300):
    uids = [pool.submit(p, n, **kw) for p, n, kw in reqs]
    done = pool.run(max_ticks=max_ticks)
    assert all(done[u].done for u in uids)
    return [done[u] for u in uids]


@pytest.mark.parametrize("pipeline", [False, True])
def test_beam_pool_matches_static_beams_and_jax_pool(models, pipeline):
    """tests/test_beam_pool.py's four requests (plain, diversity, length
    penalty, temperature + repetition penalty) in a 2-slot pool of width 2."""
    jeng, teng = _engines(models, kv="fp32")
    reqs = list(zip(PROMPTS, OUT_LENS, KWS))
    got = _run(BeamPool(teng, beam_width=2, pipeline_ticks=pipeline, **POOL), reqs)
    jgot = _run(JaxBeamPool(jeng, beam_width=2, pipeline_ticks=pipeline, **POOL), reqs)
    for r, j, (p, n, kw) in zip(got, jgot, reqs):
        beams, cums = static_beams(teng, p, n, 2, **kw)
        assert r.beam_output_ids == beams == j.beam_output_ids
        np.testing.assert_allclose(r.beam_cum_log_probs, cums, rtol=1e-5)
        np.testing.assert_allclose(r.beam_cum_log_probs, j.beam_cum_log_probs, rtol=1e-4)
        assert r.output_ids == beams[0] and r.cum_log_prob == r.beam_cum_log_probs[0]


def test_beam_pool_matches_jax_pool_on_int8_kv(models):
    jeng, teng = _engines(models, kv="int8")
    reqs = list(zip(PROMPTS, OUT_LENS, KWS))
    got = _run(BeamPool(teng, beam_width=3, **POOL), reqs)
    jgot = _run(JaxBeamPool(jeng, beam_width=3, **POOL), reqs)
    for r, j in zip(got, jgot):
        assert r.beam_output_ids == j.beam_output_ids
        np.testing.assert_allclose(r.beam_cum_log_probs, j.beam_cum_log_probs, rtol=1e-4)


def test_beam_pool_beam4(models):
    _, teng = _engines(models, kv="fp32")
    reqs = [(p, n, {}) for p, n in zip(PROMPTS[:2], OUT_LENS[:2])]
    got = _run(BeamPool(teng, beam_width=4, **POOL), reqs)
    for r, (p, n, _) in zip(got, reqs):
        assert r.beam_output_ids == static_beams(teng, p, n, 4)[0]


def test_beam_pool_stop_words_match_static(models):
    _, teng = _engines(models, kv="fp32")
    probe, _ = static_beams(teng, PROMPTS[0], 6, 2)
    stop_tok = probe[0][len(PROMPTS[0]) + 2]
    ref, _ = static_beams(teng, PROMPTS[0], 6, 2,
                          stop_words_list=np.array([[[stop_tok], [1]]], np.int32))
    (r,) = _run(BeamPool(teng, beam_width=2, **POOL), [(PROMPTS[0], 6,
                                                         dict(stop_words=[[stop_tok]]))])
    assert r.beam_output_ids == ref


def test_beam_pool_midflight_interleave(models):
    """A short beam request admitted mid-flight finishes before a long one;
    both equal their static beams."""
    _, teng = _engines(models, kv="fp32")
    ref_long = static_beams(teng, [9, 8, 7, 6, 5], 12, 2)[0]
    ref_short = static_beams(teng, [3, 4], 2, 2)[0]
    pool = BeamPool(teng, beam_width=2, **POOL)
    long_uid = pool.submit([9, 8, 7, 6, 5], 12)
    for _ in range(3):
        pool.step()
    short_uid = pool.submit([3, 4], 2)
    order = []
    for _ in range(200):
        order += [uid for uid, _t, fin in pool.step() if fin]
        if len(order) == 2:
            break
    assert order == [short_uid, long_uid]
    assert pool.requests[short_uid].beam_output_ids == ref_short
    assert pool.requests[long_uid].beam_output_ids == ref_long


def test_rows_per_slot(models):
    """Sampling pools keep one row per slot; a beam pool holds beam_width
    rows per slot in every state tensor and its decode tick."""
    _, teng = _engines(models)
    b = ContinuousBatcher(teng, **POOL)
    assert b.rows == b.max_slots == 2
    assert b._state["tokens"].shape == (2, 32) and b._state["cache"]["k"].shape[1] == 2
    bp = BeamPool(teng, beam_width=3, **POOL)
    assert bp.rows == 6 and bp.max_slots == 2
    for name in ("tokens", "beam_indir"):
        assert bp._state[name].shape == (6, 32)
    assert bp._state["cache"]["k"].shape[1] == 6 and bp._state["cum_lp"].shape == (6,)
    bp.submit([3, 4, 5], 2)
    bp._admit_pending()
    tok, lp, done, ready, tokens, lens, cum = bp._dispatch_tick()
    assert tok.shape == done.shape == ready.shape == (2,) and tokens.shape == (6, 32)


def test_beam_pool_refusals(models):
    _, teng = _engines(models)
    with pytest.raises(ValueError, match="beam pools are dense"):
        BatchingServer(teng, beam_width=2, paged=dict(num_pages=9, page_size=8), **POOL)
    pool = BeamPool(teng, beam_width=2, **POOL)
    with pytest.raises(ValueError, match="do not stream text"):
        pool.submit([3, 4], 2, on_text=print, tokenizer=CharTokenizer())
    with pytest.raises(ValueError, match="beam_width 1"):
        BeamPool(teng, beam_width=1, **POOL)
    _, t4 = _engines(models, kv="int4")
    with pytest.raises(ValueError, match="pair bytes"):
        BatchingServer(t4, beam_width=2, **POOL)


def test_multi_pool_routes_beams_by_width(models):
    _, teng = _engines(models, kv="fp32")
    srv = MultiPoolServer(teng, [dict(POOL), dict(POOL, beam_width=2)])
    try:
        assert srv.routable_pool(20, beam_width=3) is None
        assert srv.routable_pool(20, beam_width=2).beam_width == 2
        assert not hasattr(srv.routable_pool(20), "beam_width")
        uid = srv.submit([3, 4, 5], 5, beam_width=2)
        assert srv._route[uid].batcher.beam_width == 2
        assert srv.wait(uid, timeout=120).beam_output_ids == static_beams(teng, [3, 4, 5], 5, 2)[0]
        with pytest.raises(ValueError, match="fits no pool"):
            srv.submit([3, 4, 5], 5, beam_width=4)
    finally:
        srv.close()


def test_handler_routes_beams_to_the_beam_class(models):
    """A handler with a sampling class and a width-2 beam class serves a
    beam request from the beam class (its tick counter moves, the sampling
    class's does not) with the static path's and the JAX pooled handler's
    response; streamed beams and beams with per-step log-probs take the
    static path."""
    jeng, teng = _engines(models, kv="fp32")
    tok = CharTokenizer(("vo", "void"))
    classes = [dict(max_slots=2, max_seq_len=64, prompt_bucket=8),
               dict(max_slots=2, max_seq_len=64, prompt_bucket=8, beam_width=2)]
    static = CodeFuseHandler(engine=teng, tokenizer=tok, trie=VocabTrie(tok.get_vocab()),
                             warmup=False)
    pooled = CodeFuseHandler(engine=teng, tokenizer=tok, trie=VocabTrie(tok.get_vocab()),
                             warmup=False, pool=classes)
    jpooled = JaxHandler(engine=jeng, tokenizer=tok, trie=JaxTrie(tok.get_vocab()),
                         warmup=False, pool=classes)
    request = {"prompts": [{"prompt": "quick sort\n", "last_token": "", "stop_words": [],
                            "len_penalty": 0.6},
                           {"prompt": "def f", "len_penalty": 0.0, "last_token": "vo",
                            "stop_words": []}],
               "out_seq_length": 6, "beam_width": 2}
    try:
        samp, beam = (s.batcher for s in pooled.server.servers)
        assert beam.beam_width == 2 and not hasattr(samp, "beam_width")
        res = {}
        for name, h in (("static", static), ("pooled", pooled), ("jax", jpooled)):
            code, err, r = h.predict(request, name)
            assert code == 0, err
            res[name] = json.loads(r["res"])
        assert beam.decode_ticks > 0 and samp.decode_ticks == 0
        for name in ("static", "jax"):
            assert res["pooled"]["generated_code"] == res[name]["generated_code"], name
            assert res["pooled"]["length"] == res[name]["length"], name
            np.testing.assert_allclose(res["pooled"]["cum_log_prob"], res[name]["cum_log_prob"],
                                       rtol=1e-4)
        ticks = beam.decode_ticks
        for extra in (dict(stream=True), dict(output_log_probs=True)):
            code, err, r = pooled.predict(dict(request, **extra), "static-route")
            assert code == 0, err
            assert json.loads(r["res"])["generated_code"] == res["static"]["generated_code"]
        assert beam.decode_ticks == ticks
    finally:
        pooled.close()
        jpooled.server.close()
