"""The port's speculative pool (fastertransformer4codefuse_tpu_torch/engine/
spec_pool.py) and the entry points that serve it (``BatchingServer(
speculative=True)``, ``MultiPoolServer`` routing, the handler's speculative
routes and the CLI's ``--speculative_pool``) against the JAX package, on the
tiny fp32 models of tests/test_spec_pool.py (weights made by the JAX package
and copied with ``from_jax_params``) and on its cases.

Tolerances: tokens identical to the JAX pool's and to the port's one-shot
greedy; log-probs within 1e-3 (fp32 log-softmax); handler responses equal
but for the latency. The routing fault of the JAX ``MultiPoolServer``
(ordinary requests reach a speculative class and fail there; speculative
requests reach only the largest class) is pinned as not copied."""
import dataclasses
import io
import json
import sys

import numpy as np
import pytest
import torch

import jax

from fastertransformer4codefuse_tpu import GptNeoXConfig as JaxConfig
from fastertransformer4codefuse_tpu import GptNeoXEngine as JaxEngine
from fastertransformer4codefuse_tpu import RuntimeConfig as JaxRuntime
from fastertransformer4codefuse_tpu import init_params as jax_init_params
from fastertransformer4codefuse_tpu.api import cli as jcli
from fastertransformer4codefuse_tpu.api.handler import CodeFuseHandler as JaxHandler
from fastertransformer4codefuse_tpu.engine.spec_pool import SpecPool as JaxSpecPool
from fastertransformer4codefuse_tpu_torch import (
    GptNeoXConfig,
    GptNeoXEngine,
    RuntimeConfig,
    from_jax_params,
)
from fastertransformer4codefuse_tpu_torch.api import cli
from fastertransformer4codefuse_tpu_torch.api.handler import CodeFuseHandler
from fastertransformer4codefuse_tpu_torch.engine.batcher import ContinuousBatcher
from fastertransformer4codefuse_tpu_torch.engine.server import BatchingServer, MultiPoolServer
from fastertransformer4codefuse_tpu_torch.engine.spec_pool import SpecPool
from test_api import CharTokenizer
from test_torch_cli import QUANT, REQUESTS, _blocks, ckpt, tokenizers  # noqa: F401

torch.set_num_threads(2)

PROMPTS = [
    [7, 8, 9, 10, 7, 8, 9, 10, 7, 8, 9, 10, 7, 8],
    [3, 4, 5],
    [11, 12, 11, 12, 11, 12, 11],
    [9, 2, 9, 2, 9],
]


def _engines(seed):
    jcfg = JaxConfig.tiny(head_num=4, size_per_head=8, vocab_size=64)
    jp = jax_init_params(jcfg, rng=jax.random.PRNGKey(seed), dtype="fp32")
    kw = dict(dtype="fp32", seq_bucket=8)
    cfg = GptNeoXConfig(**dataclasses.asdict(jcfg))
    return (JaxEngine(jcfg, jp, JaxRuntime(**kw)),
            GptNeoXEngine(cfg, from_jax_params(jp, device="cpu"), RuntimeConfig(**kw)))


@pytest.fixture(scope="module")
def engines():
    return {seed: _engines(seed) for seed in (1, 2, 3)}


def _greedy(eng, prompt, n):
    ref = eng.generate([prompt], output_len=n, top_k=1)
    m = int(ref.sequence_lengths[0, 0])
    return [int(x) for x in ref.output_ids[0, 0, :m]]


def _pool_outputs(cls, eng, prompts, out, **kw):
    pool = cls(eng, **kw)
    uids = [pool.submit(p, out) for p in prompts]
    done = pool.run()
    return [done[u].output_ids for u in uids], pool


@pytest.mark.parametrize("pipeline", [False, True])
def test_spec_pool_matches_jax_and_greedy(engines, pipeline):
    """tests/test_spec_pool.py::test_spec_pool_matches_plain_greedy and
    ::test_spec_pool_pipelined_ticks_match: every request's output equals the
    JAX pool's and the engine's one-shot greedy (end-id truncation
    included), with ticks read at once or one tick late."""
    jeng, teng = engines[2]
    kw = dict(k=6, ngram=3, max_slots=2 if pipeline else 4, max_seq_len=64, prompt_bucket=8,
              pipeline_ticks=pipeline)
    got, pool = _pool_outputs(SpecPool, teng, PROMPTS, 14, **kw)
    want, _ = _pool_outputs(JaxSpecPool, jeng, PROMPTS, 14, **kw)
    assert got == want
    for p, g in zip(PROMPTS, got):
        assert g == _greedy(teng, p, 14), p
    assert pool.decode_ticks > 0 and not pool.running and not pool._inflight


def test_spec_pool_multi_token_ticks_and_interleave(engines):
    """A repetitive workload commits several tokens a tick for some slot,
    and a request that joins mid-flight still equals greedy."""
    jeng, teng = engines[3]
    pool = SpecPool(teng, k=8, ngram=3, max_slots=2, max_seq_len=64, prompt_bucket=8)
    u0 = pool.submit(PROMPTS[0], 20)
    for _ in range(4):
        pool.step()
    u1 = pool.submit(PROMPTS[2], 20)
    burst = []
    for _ in range(200):
        burst.append(len(pool.step()))
        if not pool.pending and not pool.running:
            break
    for uid, p in ((u0, PROMPTS[0]), (u1, PROMPTS[2])):
        assert pool.requests[uid].output_ids == _greedy(teng, p, 20)
    assert max(burst) > 2, burst


def test_spec_pool_streams_and_log_probs(engines):
    """on_token streams the commits in order; cum_log_prob and the per-step
    log-probs equal the JAX pool's, and cum_log_prob the engine's greedy
    log-prob sum, within 1e-3."""
    jeng, teng = engines[1]
    kw = dict(k=6, ngram=3, max_slots=2, max_seq_len=64, prompt_bucket=8,
              return_log_probs=True)
    prompt = PROMPTS[0]
    runs = {}
    for name, cls, eng in (("torch", SpecPool, teng), ("jax", JaxSpecPool, jeng)):
        stream = []
        pool = cls(eng, **kw)
        uid = pool.submit(prompt, 12, on_token=stream.append)
        runs[name] = (pool.run()[uid], stream)
    (r, stream), (jr, _) = runs["torch"], runs["jax"]
    assert r.output_ids == jr.output_ids == _greedy(teng, prompt, 12)
    assert stream == r.output_ids[len(prompt):]
    np.testing.assert_allclose(r.step_log_probs, jr.step_log_probs, atol=1e-3)
    ref = teng.generate([prompt], output_len=12, top_k=1, return_cum_log_probs=True)
    np.testing.assert_allclose(r.cum_log_prob, float(ref.cum_log_probs[0, 0]), atol=1e-3)
    np.testing.assert_allclose(r.cum_log_prob, jr.cum_log_prob, atol=1e-3)


def test_spec_pool_rejects_what_it_does_not_serve(engines):
    _, teng = engines[1]
    pool = SpecPool(teng, k=4, max_slots=2, max_seq_len=64, prompt_bucket=8)
    for kw in (dict(top_k=4), dict(temperature=0.7), dict(stop_words=[[5]]),
               dict(bad_words=[[6]]), dict(optional_last_tokens=[3])):
        with pytest.raises(ValueError):
            pool.make_request([1, 2, 3], 8, **kw)
    with pytest.raises(ValueError, match="draft margin"):
        pool.make_request([1, 2, 3], 60)
    pool.make_request([1, 2, 3], 8, random_seed=5)  # greedy: the seed is dropped
    with pytest.raises(ValueError, match="dense"):
        SpecPool(teng, k=4, max_slots=2, max_seq_len=64, prompt_bucket=8,
                 paged=dict(num_pages=9, page_size=8))
    with pytest.raises(ValueError, match="dense"):
        BatchingServer(teng, speculative=True, max_slots=2, max_seq_len=64, prompt_bucket=8,
                       paged=dict(num_pages=9, page_size=8))


def test_batching_server_serves_a_spec_pool_from_threads(engines):
    """BatchingServer(speculative=True) builds a SpecPool and answers
    concurrent greedy requests as the engine does; it refuses a request
    flagged for another kind of pool."""
    import threading

    _, teng = engines[2]
    srv = BatchingServer(teng, speculative=True, spec_k=5, spec_ngram=2, max_slots=2,
                         max_seq_len=64, prompt_bucket=8, pipeline_ticks=True)
    try:
        assert isinstance(srv.batcher, SpecPool) and (srv.batcher.k, srv.batcher.ngram) == (5, 2)
        out = {}

        def client(i, p):
            out[i] = srv.generate(p, 12).output_ids

        threads = [threading.Thread(target=client, args=(i, p)) for i, p in enumerate(PROMPTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        for i, p in enumerate(PROMPTS):
            assert out[i] == _greedy(teng, p, 12)
        with pytest.raises(ValueError, match="non-speculative request"):
            srv.submit(PROMPTS[1], 4, speculative=False)
    finally:
        srv.close()


def test_multi_pool_routes_by_kind_not_as_the_jax_server_does(engines):
    """Pinned: JAX engine/server.py:217 sends an ordinary (sampled) request
    into a speculative class, where it fails, and speculative requests reach
    only the largest class. Here an ordinary request never reaches a
    SpecPool, and a speculative one takes the smallest speculative class
    that fits it within its draft margin."""
    jeng, teng = engines[2]
    classes = [dict(speculative=True, spec_k=4, max_slots=2, max_seq_len=32, prompt_bucket=8),
               dict(max_slots=2, max_seq_len=64, prompt_bucket=8),
               dict(speculative=True, spec_k=4, max_slots=2, max_seq_len=64, prompt_bucket=8)]
    # the JAX fault, shown: a sampled request routes to the speculative class
    jsrv = __import__("fastertransformer4codefuse_tpu.engine.server",
                      fromlist=["MultiPoolServer"]).MultiPoolServer(jeng, classes)
    try:
        with pytest.raises(ValueError, match="greedy-only"):
            jsrv.submit([3, 4, 5], 6, top_k=4)
    finally:
        jsrv.close()
    srv = MultiPoolServer(teng, classes)
    try:
        kinds = [(s.batcher.max_seq_len, s.batcher.speculative) for s in srv.servers]
        assert sorted(kinds) == [(32, True), (64, False), (64, True)]
        u = srv.submit([3, 4, 5], 6, top_k=4, random_seed=1)
        assert not srv._route[u].batcher.speculative
        r = srv.wait(u, timeout=120)
        assert r.done and r.output_ids[:3] == [3, 4, 5]
        short = srv.submit(PROMPTS[1], 20, speculative=True)  # 23 <= 32 - (4 + 2)
        long_ = srv.submit(PROMPTS[0], 20, speculative=True)  # 34: the 64 class
        assert srv._route[short].batcher.max_seq_len == 32 and srv._route[short].batcher.speculative
        assert srv._route[long_].batcher.max_seq_len == 64 and srv._route[long_].batcher.speculative
        assert srv.wait(short, timeout=120).output_ids == _greedy(teng, PROMPTS[1], 20)
        assert srv.wait(long_, timeout=120).output_ids == _greedy(teng, PROMPTS[0], 20)
        greedy = srv.submit(PROMPTS[1], 20, top_k=1)  # ordinary greedy: the sampling class
        assert not srv._route[greedy].batcher.speculative
        srv.wait(greedy, timeout=120)
        assert srv.routable_pool(60, speculative=True) is None  # past every draft margin
        assert srv.routable_pool(58, speculative=True).max_seq_len == 64
    finally:
        srv.close()


SPEC_REQS = [
    {"prompts": [{"prompt": "abcabcabcab", "top_k": 1}], "out_seq_length": 10,
     "speculative": True},
    {"prompts": [{"prompt": "def f(a): a a a", "top_k": 1}, {"prompt": "xyz", "top_k": 1}],
     "out_seq_length": 8, "speculative": True},
    # greedy with a repetition penalty, which the speculative loop does not
    # apply: the ordinary routes answer it (the JAX handler's speculative
    # loop takes it and drops the penalty)
    {"prompts": [{"prompt": "aaaaaaaa", "top_k": 1, "repetition_penalty": 3.0}],
     "out_seq_length": 6, "speculative": True},
]
PENALIZED = SPEC_REQS[2]


def _tiny_handlers(pool=None):
    tok = CharTokenizer(("vo", "void"))
    jcfg = JaxConfig.tiny(head_num=4, size_per_head=8, vocab_size=64, end_id=1)
    jp = jax_init_params(jcfg, rng=jax.random.PRNGKey(4), dtype="fp32")
    kw = dict(dtype="fp32", seq_bucket=8)
    cfg = GptNeoXConfig(**dataclasses.asdict(jcfg))
    jh = JaxHandler(engine=JaxEngine(jcfg, jp, JaxRuntime(**kw)), tokenizer=tok, warmup=False,
                    pool=pool)
    th = CodeFuseHandler(engine=GptNeoXEngine(cfg, from_jax_params(jp, device="cpu"),
                                              RuntimeConfig(**kw)),
                         tokenizer=tok, warmup=False, pool=pool)
    return jh, th


def _compare(jh, th, req, jreq=None):
    """The port's response to ``req`` against the JAX handler's to ``jreq``
    (default ``req``): the same keys, equal values but for the latency and
    the drawn default seed, log-probs within 1e-3."""
    (jc, jm, jr), (tc, tm_, tr) = jh.predict(jreq or req, "j"), th.predict(req, "t")
    assert jc == 0 and tc == 0, (jm, tm_)
    jr, tr = json.loads(jr["res"]), json.loads(tr["res"])
    assert sorted(jr) == sorted(tr)
    for key in jr:
        if key in ("latency", "random_seed", "cum_log_prob", "speculative"):
            continue
        assert tr[key] == jr[key], key
    np.testing.assert_allclose(tr["cum_log_prob"], jr["cum_log_prob"], atol=1e-3)
    if "speculative" in jr:
        np.testing.assert_allclose([tr["speculative"][k] for k in sorted(jr["speculative"])],
                                   [jr["speculative"][k] for k in sorted(jr["speculative"])])
    return tr


@pytest.mark.parametrize("req", SPEC_REQS[:2], ids=["one", "two"])
def test_handler_speculative_response_matches_jax(req):
    """The static speculative route (no pool): the same response keys as the
    JAX handler's, "speculative" statistics included, and the same values."""
    jh, th = _tiny_handlers()
    tr = _compare(jh, th, req)
    assert "speculative" in tr


def test_handler_keeps_a_penalized_request_off_the_speculative_loop():
    """Pinned: the JAX handler's speculative loop takes a greedy request with
    a repetition penalty and drops the penalty. The port answers it on the
    ordinary route, as the JAX handler does without the flag; the JAX
    speculative answer parts from it."""
    jh, th = _tiny_handlers()
    tr = _compare(jh, th, PENALIZED, dict(PENALIZED, speculative=False))
    assert "speculative" not in tr
    jr = json.loads(jh.predict(PENALIZED, "j")[2]["res"])
    assert "speculative" in jr and jr["generated_code"] != tr["generated_code"]


def test_pooled_handler_routes_speculative_requests_as_jax_does():
    """A handler over a speculative pool: eligible speculative requests ride
    the pool (the pooled response, as JAX's), the rest the static routes."""
    pool = dict(speculative=True, spec_k=4, max_slots=2, max_seq_len=48, prompt_bucket=8)
    jh, th = _tiny_handlers(pool)
    try:
        for req in SPEC_REQS + [dict(SPEC_REQS[0], speculative=False)]:
            before = th.server.batcher.decode_ticks
            jreq = dict(req, speculative=False) if req is PENALIZED else None
            tr = _compare(jh, th, req, jreq)
            pooled = req["speculative"] and req is not PENALIZED
            assert (th.server.batcher.decode_ticks > before) == pooled
            assert "speculative" not in tr or not pooled
    finally:
        th.close()
        jh.server.close()


def test_handler_multi_pool_with_a_spec_class():
    """The handler over a sampling and a speculative class: a sampled
    request takes the sampling class (the JAX MultiPoolServer's routing fault would
    send it to the speculative class), a speculative one the speculative
    class, each answered as the static path answers it."""
    pool = [dict(speculative=True, spec_k=4, max_slots=2, max_seq_len=48, prompt_bucket=8),
            dict(max_slots=2, max_seq_len=48, prompt_bucket=8)]
    _, static = _tiny_handlers()
    _, th = _tiny_handlers(pool)
    try:
        spec_srv, samp_srv = sorted(th.server.servers, key=lambda s: not s.batcher.speculative)
        sampled = {"prompts": [{"prompt": "int main", "top_k": 3, "random_seed": 7}],
                   "out_seq_length": 6}
        code, msg, _ = th.predict(sampled, "t")
        assert code == 0, msg
        assert samp_srv.batcher.decode_ticks > 0 and spec_srv.batcher.decode_ticks == 0
        req = SPEC_REQS[0]
        code, msg, res = th.predict(req, "t")
        assert code == 0, msg
        assert spec_srv.batcher.decode_ticks > 0
        want = json.loads(static.predict(dict(req, speculative=False), "s")[2]["res"])
        assert json.loads(res["res"])["generated_code"] == want["generated_code"]
    finally:
        th.close()


def test_cli_speculative_pool_answers_as_the_jax_cli(ckpt, tokenizers, capsys,  # noqa: F811
                                                     monkeypatch):
    """``--serve --speculative_pool``: requests flagged speculative ride the
    pool, the rest the static path; the printed responses equal the JAX
    CLI's. With pages it refuses, as the JAX CLI does."""
    args = ["--ckpt_path", ckpt, "--tokenizer_path", "tok", "--dtype", "fp32", "--serve",
            "--pool_slots", "2", "--pool_seq_len", "64", "--prompt_bucket", "8",
            "--speculative_pool", "--spec_k", "4", *QUANT[0]]
    # flagged: plain greedy (the pool), with stop words (the static path);
    # unflagged (the static path). REQUESTS[2]'s repetition penalty stays
    # unflagged: the JAX speculative loop would drop it.
    reqs = [dict(r, speculative=True) for r in REQUESTS[:2]] + [REQUESTS[2], REQUESTS[0]]
    lines = "".join(json.dumps(r) + "\n" for r in reqs)
    monkeypatch.setattr(sys, "stdin", io.StringIO(lines))
    jcli.main(args)
    ref = capsys.readouterr().out
    monkeypatch.setattr(sys, "stdin", io.StringIO(lines))
    cli.main(args + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert _blocks(got) == _blocks(ref) and len(_blocks(got)) == len(reqs)
    with pytest.raises(ValueError, match="dense"):
        cli.main(args + ["--device", "cpu", "--paged_pages", "17", "--page_size", "8"])


def test_base_pool_is_not_speculative(engines):
    _, teng = engines[1]
    assert ContinuousBatcher.speculative is False and SpecPool.speculative is True
    srv = BatchingServer(teng, max_slots=2, max_seq_len=32, prompt_bucket=8)
    try:
        assert srv.routable_pool(10) is srv.batcher
        assert srv.routable_pool(10, speculative=True) is None
        with pytest.raises(ValueError, match="speculative request"):
            srv.submit([3, 4], 4, speculative=True)
    finally:
        srv.close()
