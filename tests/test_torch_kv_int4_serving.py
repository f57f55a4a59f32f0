"""Serving on packed int4 KV caches (``kv_cache_dtype="int4"`` and
``"int8k_int4v"``): the port's engine, paged pools and pooled handler against
the JAX package, on a tiny fp32 model with int8 weights and embeddings made
by the JAX package (``from_jax_params``), on the cases of
tests/test_engine_kv.py and tests/test_paged_batcher.py.

Tolerances: greedy tokens identical to the JAX engine's and the JAX pool's;
cumulative log-probs within 1e-4 of the JAX engine's (fp32, summation order
only); pooled handler responses equal the static path's text for text."""
import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fastertransformer4codefuse_tpu import GptNeoXConfig as JaxConfig
from fastertransformer4codefuse_tpu import GptNeoXEngine as JaxEngine
from fastertransformer4codefuse_tpu import RuntimeConfig as JaxRuntime
from fastertransformer4codefuse_tpu import init_params as jax_init_params
from fastertransformer4codefuse_tpu.engine.batcher import ContinuousBatcher as JaxBatcher
from fastertransformer4codefuse_tpu_torch import (
    GptNeoXConfig,
    GptNeoXEngine,
    RuntimeConfig,
    from_jax_params,
)
from fastertransformer4codefuse_tpu_torch.api.handler import CodeFuseHandler
from fastertransformer4codefuse_tpu_torch.api.trie import VocabTrie
from fastertransformer4codefuse_tpu_torch.engine import paged_kv
from fastertransformer4codefuse_tpu_torch.engine.batcher import ContinuousBatcher
from test_api import CharTokenizer

torch.set_num_threads(2)

KINDS = ["int4", "int8k_int4v"]
PROMPTS = [[3, 4, 5], [9, 8, 7, 6, 5], [11, 12], [20, 21, 22, 23],
           [30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40]]


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


def _engines(models, kv, bucket=8):
    jcfg, jp, cfg, tp = models
    kw = dict(dtype="fp32", int8_mode=1, kv_cache_dtype=kv, seq_bucket=bucket)
    return JaxEngine(jcfg, jp, JaxRuntime(**kw)), GptNeoXEngine(cfg, tp, RuntimeConfig(**kw))


@pytest.mark.parametrize("kind", KINDS)
def test_engine_greedy_matches_jax(models, kind):
    """Ragged rows, an odd total length made even, greedy tokens and their
    log-probs: the same as the JAX engine with the same KV kind."""
    je, te = _engines(models, kind, bucket=4)
    prompts = [[3, 4, 5, 17, 2, 9], [9, 8, 7]]
    want = je.generate(prompts, output_len=7, top_k=1, return_cum_log_probs=True)
    got = te.generate(prompts, output_len=7, top_k=1, return_cum_log_probs=True)
    assert got.output_ids.shape == want.output_ids.shape  # 8 + 7, padded to 16
    np.testing.assert_array_equal(got.output_ids, want.output_ids)
    np.testing.assert_array_equal(got.sequence_lengths, want.sequence_lengths)
    np.testing.assert_allclose(got.cum_log_probs, want.cum_log_probs, rtol=1e-4, atol=1e-4)


def test_engine_refuses_an_odd_prefill_width(models):
    _, te = _engines(models, "int4", bucket=5)
    with pytest.raises(ValueError, match="even prefill width"):
        te.generate([[3, 4, 5]], output_len=2, top_k=1)


def _run_pool(cls, engine, paged, reqs):
    cb = cls(engine, max_slots=2, max_seq_len=32, prompt_bucket=8, paged=paged)
    uids = [cb.submit(**r) for r in reqs]
    done = cb.run(max_ticks=600)
    assert all(done[u].done for u in uids)
    return [done[u].output_ids for u in uids], cb


@pytest.mark.parametrize("kind", KINDS)
def test_paged_pool_matches_oneshot_and_jax_pool(models, kind):
    """Packed pages: the pool's greedy tokens equal the one-shot engine's
    with the same KV kind and the JAX pool's, and every page comes back."""
    je, te = _engines(models, kind)
    lens = [5, 4, 6]
    reqs = [dict(prompt=p, output_len=n, top_k=1) for p, n in zip(PROMPTS, lens)]
    refs = []
    for r in reqs:
        o = te.generate([r["prompt"]], output_len=r["output_len"], top_k=1)
        refs.append([int(x) for x in o.output_ids[0, 0, :int(o.sequence_lengths[0, 0])]])
    pg = dict(num_pages=10, page_size=8)
    want, _ = _run_pool(JaxBatcher, je, pg, reqs)
    got, cb = _run_pool(ContinuousBatcher, te, pg, reqs)
    assert got == refs == want
    assert cb.allocator.free_pages == 9
    assert paged_kv.packed4(cb._state["cache"], "pv")


def test_lazy_packed_pool_preempts_like_jax(models):
    """A lazy pool on int4 pages runs short of pages, preempts and
    recomputes: the tokens still equal the JAX lazy pool's."""
    je, te = _engines(models, "int4")
    reqs = [dict(prompt=p, output_len=n, top_k=1) for p, n in zip(PROMPTS, [20, 20, 6, 3, 9])]
    pg = dict(num_pages=6, page_size=8, lazy=True)
    want, jcb = _run_pool(JaxBatcher, je, pg, reqs)
    got, tcb = _run_pool(ContinuousBatcher, te, pg, reqs)
    assert got == want
    assert tcb.preemptions == jcb.preemptions >= 1
    assert tcb.allocator.free_pages == tcb.allocator.n_pages - 1


def test_handler_static_equals_pooled_on_int4_kv(models):
    """The handler serves through the engine's RuntimeConfig: on an int4-KV
    engine the paged pool answers as the static path does."""
    _, te = _engines(models, "int4")
    tok = CharTokenizer(("vo", "void"))
    trie = VocabTrie(tok.get_vocab())
    static = CodeFuseHandler(engine=te, tokenizer=tok, trie=trie, warmup=False)
    pooled = CodeFuseHandler(engine=te, tokenizer=tok, trie=trie, warmup=False,
                             pool=dict(max_slots=2, max_seq_len=32, prompt_bucket=8,
                                       paged=dict(num_pages=9, page_size=8)))
    try:
        request = {"prompts": [{"prompt": "quick sort\n", "top_k": 1},
                               {"prompt": "hello", "top_k": 1}], "out_seq_length": 6}
        rs = json.loads(static.predict(request, "static")[2]["res"])
        code, err, res = pooled.predict(request, "pooled")
        assert code == 0, err
        rp = json.loads(res["res"])
        assert rp["generated_code"] == rs["generated_code"] and rp["length"] == rs["length"]
        b = pooled.server.batcher
        assert b.decode_ticks > 0 and b.allocator.free_pages == b.allocator.n_pages - 1
    finally:
        pooled.close()
