"""The port's pooled serving front ends (fastertransformer4codefuse_tpu_torch/
engine/server.py, api/handler.py with ``pool=``, api/http_server.py) on a
tiny fp32 model with int8 weights, on the cases of tests/test_batcher.py and
the pool tests of tests/test_api.py; and the default device of the port's
constructors.

Tolerances: greedy pooled responses equal the static path's (whose tokens
tests/test_torch_gptneox.py holds to the JAX package) text for text;
cumulative log-probs within 1e-3 (the pool and the static path sum the same
fp32 log-probs in another order of ops)."""
import http.client
import json
import threading

import numpy as np
import pytest
import torch

from fastertransformer4codefuse_tpu_torch import (
    GptNeoXConfig,
    GptNeoXEngine,
    RuntimeConfig,
    init_params,
)
from fastertransformer4codefuse_tpu_torch.api.handler import CodeFuseHandler
from fastertransformer4codefuse_tpu_torch.api.http_server import make_server
from fastertransformer4codefuse_tpu_torch.api.trie import VocabTrie
from fastertransformer4codefuse_tpu_torch.core.device import resolve_device
from fastertransformer4codefuse_tpu_torch.engine import kv_cache as kvc
from fastertransformer4codefuse_tpu_torch.engine import paged_kv
from fastertransformer4codefuse_tpu_torch.engine.batcher import ContinuousBatcher
from fastertransformer4codefuse_tpu_torch.engine.beam_pool import BeamPool
from fastertransformer4codefuse_tpu_torch.engine.server import BatchingServer, MultiPoolServer
from fastertransformer4codefuse_tpu_torch.engine.spec_pool import SpecPool
from test_api import CharTokenizer

torch.set_num_threads(2)

CFG = GptNeoXConfig.tiny(vocab_size=64, end_id=1)


@pytest.fixture(scope="module")
def engine():
    p = init_params(CFG, seed=0, dtype="fp32", int8_mode=1, quantize_embeddings=True,
                    device="cpu")
    return GptNeoXEngine(CFG, p, RuntimeConfig(dtype="fp32", int8_mode=1,
                                               kv_cache_dtype="int8", seq_bucket=8))


def _greedy(engine, prompt, n, **kw):
    o = engine.generate([prompt], output_len=n, top_k=1, return_cum_log_probs=True, **kw)
    m = int(o.sequence_lengths[0, 0])
    return [int(x) for x in o.output_ids[0, 0, :m]], float(o.cum_log_probs[0, 0])


def test_batching_server_interleaves_across_threads(engine):
    """A short request submitted after a long one finishes first, from
    another thread; both equal the one-shot engine."""
    long_p, long_n, short_p, short_n = [3, 4, 5], 40, [9, 8, 7], 3
    refs = {"long": _greedy(engine, long_p, long_n, min_length=long_n),
            "short": _greedy(engine, short_p, short_n, min_length=short_n)}
    srv = BatchingServer(engine, max_slots=2, max_seq_len=64, prompt_bucket=8,
                         return_log_probs=True, pipeline_ticks=True)
    try:
        order = []
        started = threading.Event()

        def run(name, p, n):
            uid = srv.submit(p, n, top_k=1, min_length=n)
            if name == "long":
                started.set()
            order.append((name, srv.wait(uid, timeout=120)))

        t_long = threading.Thread(target=run, args=("long", long_p, long_n))
        t_long.start()
        started.wait(10)
        t_short = threading.Thread(target=run, args=("short", short_p, short_n))
        t_short.start()
        t_long.join(120)
        t_short.join(120)
        assert [n for n, _ in order] == ["short", "long"]
        for name, r in order:
            ids, cum = refs[name]
            assert r.output_ids == ids, name
            np.testing.assert_allclose(r.cum_log_prob, cum, atol=1e-3)
            np.testing.assert_allclose(sum(r.step_log_probs), r.cum_log_prob, atol=1e-5)
    finally:
        srv.close()


def test_batching_server_rejects_oversize_and_survives(engine):
    srv = BatchingServer(engine, max_slots=2, max_seq_len=16, prompt_bucket=8)
    try:
        with pytest.raises(ValueError):
            srv.submit(list(range(2, 20)), 8, top_k=1)
        with pytest.raises(ValueError):
            srv.submit([3, 4], 4, top_k=100)  # above the pool's sampling cap
        r = srv.generate([3, 4, 5], 4, top_k=1)  # the pool is still healthy
        assert r.done and r.output_ids == _greedy(engine, [3, 4, 5], 4)[0]
    finally:
        srv.close()


def test_batching_server_reports_a_dead_driver(engine):
    srv = BatchingServer(engine, max_slots=2, max_seq_len=16, prompt_bucket=8)
    try:
        def boom():
            raise RuntimeError("tick failed")

        srv.batcher._dispatch_tick = boom
        uid = srv.submit([3, 4, 5], 4, top_k=1)
        with pytest.raises(RuntimeError, match="driver died"):
            srv.wait(uid, timeout=60)
        with pytest.raises(RuntimeError, match="driver died"):
            srv.submit([3], 2)
    finally:
        srv.close()


def test_multi_pool_server_routes_by_length(engine):
    srv = MultiPoolServer(engine, [dict(max_slots=2, max_seq_len=16, prompt_bucket=8),
                                   dict(max_slots=2, max_seq_len=64, prompt_bucket=8,
                                        paged=dict(num_pages=12, page_size=16))])
    try:
        reqs = [([3, 4, 5], 4), ([9, 8, 7], 40), ([11, 12], 6)]
        uids = [srv.submit(p, n, top_k=1) for p, n in reqs]
        assert srv._route[uids[0]].batcher.max_seq_len == 16
        assert srv._route[uids[1]].batcher.max_seq_len == 64
        for uid, (p, n) in zip(uids, reqs):
            assert srv.wait(uid, timeout=120).output_ids == _greedy(engine, p, n)[0]
        with pytest.raises(ValueError):
            srv.submit(list(range(2, 40)), 40, top_k=1)  # fits no class
        assert srv.routable_pool(20, beam_width=2) is None
    finally:
        srv.close()


def test_unported_pool_kinds_raise_naming_their_item(engine):
    """``beam_width > 1`` builds a beam pool and ``speculative=True`` a
    speculative pool, each on dense slabs only (paged, either raises
    ValueError). A prompt-learning pool refuses what the JAX pool refuses: a
    task on a pool without a table, an unknown task, a table on pages, a
    packed cache. Packed int4 KV is served on pages only: a dense pool refuses
    it (pair bytes), as do odd buckets or page sizes."""
    srv = BatchingServer(engine, beam_width=2, max_slots=2, max_seq_len=16, prompt_bucket=8)
    try:
        assert isinstance(srv.batcher, BeamPool) and srv.batcher.beam_width == 2
    finally:
        srv.close()
    with pytest.raises(ValueError, match="beam pools are dense"):
        BatchingServer(engine, beam_width=2, max_slots=2, max_seq_len=16, prompt_bucket=8,
                       paged=dict(num_pages=4, page_size=8))
    srv = BatchingServer(engine, speculative=True, max_slots=2, max_seq_len=16, prompt_bucket=8)
    try:
        assert isinstance(srv.batcher, SpecPool) and srv.batcher.speculative
    finally:
        srv.close()
    with pytest.raises(ValueError, match="dense"):
        BatchingServer(engine, speculative=True, max_slots=2, max_seq_len=16, prompt_bucket=8,
                       paged=dict(num_pages=4, page_size=8))
    cfg = engine.config
    table = {0: (np.zeros((cfg.layer_num, 2, cfg.kv_heads, 4, cfg.size_per_head)), 4)}
    pool = ContinuousBatcher(engine, max_slots=2, max_seq_len=16, prompt_bucket=8,
                             prompt_table=table)
    assert pool.prompt_width == 8
    cases = [
        (lambda: ContinuousBatcher(engine, max_slots=2, max_seq_len=16, prompt_bucket=8)
         .submit([3], 2, prompt_task_id=0), "prompt_table"),
        (lambda: pool.submit([3], 2, prompt_task_id=5), "unknown prompt task"),
        (lambda: ContinuousBatcher(engine, max_slots=2, max_seq_len=16, prompt_bucket=8,
                                   prompt_table=table, paged=dict(num_pages=4, page_size=8)),
         "paged pools"),
        (lambda: ContinuousBatcher(
            GptNeoXEngine(CFG, engine.params, RuntimeConfig(dtype="fp32", int8_mode=1,
                                                            kv_cache_dtype="int4")),
            max_slots=2, max_seq_len=16, prompt_bucket=8, prompt_table=table),
         "unpacked KV cache"),
    ]
    for build, msg in cases:
        with pytest.raises(ValueError, match=msg):
            build()
    for kind in ("int4", "int8k_int4v"):
        eng4 = GptNeoXEngine(CFG, engine.params, RuntimeConfig(dtype="fp32", int8_mode=1,
                                                               kv_cache_dtype=kind))
        with pytest.raises(ValueError, match="pair bytes"):
            ContinuousBatcher(eng4, max_slots=2, max_seq_len=16, prompt_bucket=8)
        with pytest.raises(ValueError, match="even"):
            ContinuousBatcher(eng4, max_slots=2, max_seq_len=15, prompt_bucket=5,
                              paged=dict(num_pages=4, page_size=5))
        b = ContinuousBatcher(eng4, max_slots=2, max_seq_len=16, prompt_bucket=8,
                              paged=dict(num_pages=4, page_size=8))
        assert paged_kv.packed4(b._state["cache"], "pv")
    h = CodeFuseHandler(engine=engine, tokenizer=CharTokenizer(), warmup=False,
                        pool=dict(beam_width=2, max_slots=2, max_seq_len=16, prompt_bucket=8))
    try:
        assert isinstance(h.server.batcher, BeamPool)
    finally:
        h.close()


def _handlers(engine, **pool_kw):
    tok = CharTokenizer(("vo", "void"))
    trie = VocabTrie(tok.get_vocab())
    pool = dict(max_slots=2, max_seq_len=64, prompt_bucket=8)
    pool.update(pool_kw)
    static = CodeFuseHandler(engine=engine, tokenizer=tok, trie=trie, warmup=False)
    pooled = CodeFuseHandler(engine=engine, tokenizer=tok, trie=trie, warmup=False, pool=pool)
    return static, pooled


@pytest.mark.parametrize("paged", [None, dict(num_pages=20, page_size=8)])
def test_handler_pooled_matches_static_path(engine, paged):
    """Stop words, trie last-token constraints and repetition penalty, streamed
    and not: the pool answers as the static path does, and the streamed text
    equals the response."""
    static, pooled = _handlers(engine, paged=paged)
    try:
        streamed = []
        pooled.on_stream_text = lambda b, j, s: streamed.append((b, s))
        request = {
            "prompts": [
                {"prompt": "quick sort\n", "last_token": "vo", "top_k": 1,
                 "repetition_penalty": 1.1, "stop_words": ["zz"]},
                {"prompt": "hello", "top_k": 1, "last_token": "", "stop_words": []},
            ],
            "out_seq_length": 6,
            "output_log_probs": True,
        }
        rs = json.loads(static.predict(request, "static")[2]["res"])
        for stream in (False, True):
            code, err, res = pooled.predict(dict(request, stream=stream), "pooled")
            assert code == 0, err
            rp = json.loads(res["res"])
            assert set(rp) == set(rs)
            assert rp["generated_code"] == rs["generated_code"]
            assert rp["length"] == rs["length"]
            np.testing.assert_allclose(rp["cum_log_prob"], rs["cum_log_prob"], atol=1e-3)
            np.testing.assert_allclose(rp["output_log_probs"], rs["output_log_probs"], atol=1e-3)
        assert "".join(s for b, s in streamed if b == 0) == rp["generated_code"][0][0]
        assert "".join(s for b, s in streamed if b == 1) == rp["generated_code"][1][0]
        if paged:
            b = pooled.server.batcher
            assert b.allocator.free_pages == b.allocator.n_pages - 1
    finally:
        pooled.close()


def test_handler_paged_pool_serves_threads_like_the_static_path(engine):
    static, pooled = _handlers(engine, paged=dict(num_pages=20, page_size=8))
    try:
        reqs = [{"prompts": [{"prompt": p, "top_k": 1}], "out_seq_length": n}
                for p, n in (("quick sort\n", 6), ("hello", 5), ("ab", 8))]
        want = [json.loads(static.predict(r, "s")[2]["res"])["generated_code"] for r in reqs]
        got = {}

        def call(i, rq):
            code, err, res = pooled.predict(rq, f"p{i}")
            assert code == 0, err
            got[i] = json.loads(res["res"])["generated_code"]

        ts = [threading.Thread(target=call, args=(i, r)) for i, r in enumerate(reqs)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        assert [got[i] for i in range(len(reqs))] == want
    finally:
        pooled.close()


def test_handler_multi_pool_classes_and_fallback(engine):
    """pool=[classA, classB] routes by length; requests no class can serve
    (too long, pure top-p, beam search without a beam class) take the static
    path."""
    static, pooled = _handlers(engine)
    tok = pooled.tokenizer
    multi = CodeFuseHandler(engine=engine, tokenizer=tok, trie=pooled.trie, warmup=True,
                            pool=[dict(max_slots=2, max_seq_len=16, prompt_bucket=8),
                                  dict(max_slots=2, max_seq_len=64, prompt_bucket=8)])
    try:
        for prompt, n in (("hi", 4), ("hello there", 40)):
            req = {"prompts": [{"prompt": prompt, "top_k": 1}], "out_seq_length": n}
            cs, es, rs = static.predict(req, "s")
            cp, ep, rp = multi.predict(req, "p")
            assert cs == 0 and cp == 0, (es, ep)
            assert json.loads(rs["res"])["generated_code"] == json.loads(rp["res"])["generated_code"]
        long_req = {"prompts": [{"prompt": "hello", "top_k": 1}], "out_seq_length": 100}
        assert not pooled._pool_routable(
            {"beam_width": 1, "output_len": 100, "top_k": [1]}, [tok.encode("hello")])
        code, err, res = pooled.predict(long_req, "fb")
        assert code == 0, err
        assert json.loads(res["res"]) ["length"][0][0] <= 100
        nucleus = {"prompts": [{"prompt": "hello", "top_k": 0, "top_p": 0.9}],
                   "out_seq_length": 4}
        code, err, _ = pooled.predict(nucleus, "fb2")
        assert code == 0, err
        # no beam class: a beam request takes the static path
        beam_req = {"prompts": [{"prompt": "hello", "top_k": 1}], "out_seq_length": 4,
                    "beam_width": 2}
        assert not pooled._pool_routable(
            {"beam_width": 2, "output_len": 4, "top_k": [1], "output_log_probs": False},
            [tok.encode("hello")])
        code, err, res = pooled.predict(beam_req, "fb3")
        cs, es, rs = static.predict(beam_req, "s3")
        assert code == 0 and cs == 0, (err, es)
        got, want = json.loads(res["res"]), json.loads(rs["res"])
        assert len(got["generated_code"][0]) == 2
        for key in ("generated_code", "length", "cum_log_prob"):
            assert got[key] == want[key], key
    finally:
        pooled.close()
        multi.close()


def test_http_server_end_to_end(engine):
    """POST /predict over the pooled handler on localhost: concurrent requests
    share the pool and carry the reference schema; /healthz answers; unknown
    paths 404, unreadable bodies 400, handler errors 500."""
    _, handler = _handlers(engine)
    srv = make_server(handler, "127.0.0.1", 0)
    port = srv.server_address[1]
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()

    def call(method, path, body=None):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        try:
            data = body if isinstance(body, (bytes, type(None))) else json.dumps(body).encode()
            conn.request(method, path, body=data, headers={"Content-Type": "application/json"})
            r = conn.getresponse()
            return r.status, json.loads(r.read())
        finally:
            conn.close()

    try:
        assert call("GET", "/healthz") == (200, "ok")
        assert call("GET", "/nope")[0] == 404
        results = {}

        def run(name, prompt, n):
            results[name] = call("POST", "/predict", {
                "prompts": [{"prompt": prompt, "top_k": 1, "min_length": n}],
                "out_seq_length": n})

        ts = [threading.Thread(target=run, args=a) for a in (("long", "abcdef", 30),
                                                               ("short", "xy", 2))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(120)
        for name, n in (("long", 30), ("short", 2)):
            status, body = results[name]
            assert status == 200, body
            assert body["res"]["length"][0][0] == n
        assert call("POST", "/predict", b"{not json")[0] == 400
        status, body = call("POST", "/predict", {"prompts": [{}]})
        assert status == 500 and "error" in body
    finally:
        srv.shutdown()
        srv.server_close()
        handler.close()


def test_constructors_default_to_the_card(monkeypatch):
    """Fault pinned (ROADMAP queue 3): init_params and from_jax_params built on
    the CPU when no device was named. They, init_cache and init_paged_cache now
    build on CUDA by default and raise where there is none; the engine and
    the pool follow the device of the params they are given."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from fastertransformer4codefuse_tpu_torch import from_jax_params

    import transformers

    from fastertransformer4codefuse_tpu_torch.engine.t5_engine import T5Engine
    from fastertransformer4codefuse_tpu_torch.models import registry, t5, vit

    torch.manual_seed(0)
    hf_t5 = transformers.T5ForConditionalGeneration(transformers.T5Config(
        vocab_size=32, d_model=16, d_kv=4, d_ff=32, num_layers=1, num_heads=4)).eval()
    hf_vit = transformers.ViTModel(transformers.ViTConfig(
        hidden_size=16, num_hidden_layers=1, num_attention_heads=4, intermediate_size=32,
        image_size=8, patch_size=4)).eval()
    t5cfg = t5.config_from_hf_t5(hf_t5.config)
    vitcfg = vit.config_from_hf_vit(hf_vit.config)
    for build in (
        lambda: init_params(CFG, seed=0),
        lambda: from_jax_params({"final_ln_w": np.ones(4, np.float32)}),
        lambda: kvc.init_cache(CFG, 1, 8, torch.int8),
        lambda: paged_kv.init_paged_cache(CFG, 1, 8, 2, 8, torch.int8),
        lambda: t5.params_from_hf_t5_state_dict(t5cfg, hf_t5.state_dict()),
        lambda: registry.get("vit").params_from_hf(vitcfg, hf_vit.state_dict()),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    # T5Engine and a family's encode run on the device of the params given
    tp = t5.params_from_hf_t5_state_dict(t5cfg, hf_t5.state_dict(), device="cpu")
    assert T5Engine(t5cfg, tp).device == torch.device("cpu")
    assert T5Engine(t5cfg, tp).generate([[3, 4, 5]], 2).output_ids.shape[:2] == (1, 1)
    vp = registry.get("vit").params_from_hf(vitcfg, hf_vit.state_dict(), device="cpu")
    h, _ = registry.get("vit").encode(vitcfg, vp, np.zeros((1, 3, 8, 8), np.float32))
    assert h.device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None) == torch.device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    p = init_params(CFG, seed=0, dtype="fp32", device="cpu")
    eng = GptNeoXEngine(CFG, p, RuntimeConfig(dtype="fp32"))
    assert eng.device == torch.device("cpu")
    cb = ContinuousBatcher(eng, max_slots=1, max_seq_len=16, prompt_bucket=8,
                           paged=dict(num_pages=3, page_size=8))
    assert cb._state["cache"]["pk"].device == torch.device("cpu")
