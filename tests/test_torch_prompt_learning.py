"""Prompt learning in the port's static engine (fastertransformer4codefuse_tpu_torch/
engine/engine.py set_prompt_learning_table, kv_cache.write_prefix,
gptneox.prefill_chunk(embeds=), sampling/beam.py) against the JAX engine, on
the cases of tests/test_prompt_learning.py (all but the pp = 2 case, which
waits for the port's pipeline parallelism): prefix prompts built by
prefilling real tokens, ragged prefix batches, soft prompts (real tokens'
embeddings, ragged lengths, random embeddings), an int8 KV cache, and beams.
The same JAX-made fp32 weights go to both (``from_jax_params``).

Tolerance: greedy and beam tokens identical to the JAX engine's, and equal to
the run on the concatenated prompt where the JAX test asks that; cumulative
log-probs within 1e-4 (fp32, summation order only).

A fault of the JAX static engine is not copied: it checks and writes a prefix
table of ``head_num`` heads, so every GQA/MQA config fails there, while its
pool takes ``kv_heads``. The port's static engine takes ``kv_heads``, and on
a one-KV-head config its prefix tokens equal the JAX pool's."""
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
from fastertransformer4codefuse_tpu.models import gptneox as jm
from fastertransformer4codefuse_tpu_torch import (
    GptNeoXConfig,
    GptNeoXEngine,
    RuntimeConfig,
    from_jax_params,
)
from fastertransformer4codefuse_tpu_torch.engine import kv_cache as kvc

torch.set_num_threads(2)


def _engines(jcfg, jp, **rt):
    cfg = GptNeoXConfig(**{f.name: getattr(jcfg, f.name) for f in
                           __import__("dataclasses").fields(GptNeoXConfig)})
    je = JaxEngine(jcfg, jp, JaxRuntime(dtype="fp32", seq_bucket=8, **rt))
    te = GptNeoXEngine(cfg, from_jax_params(jp, device="cpu"),
                       RuntimeConfig(dtype="fp32", seq_bucket=8, **rt))
    return je, te


@pytest.fixture(scope="module")
def setup():
    jcfg = JaxConfig.tiny(vocab_size=96)
    jp = jax_init_params(jcfg, dtype="fp32")
    je, te = _engines(jcfg, jp)
    return jcfg, jp, je, te


def _prefix_kv(cfg, params, prompt_ids):
    """[L, 2, nKV, P, dh]: the K/V of ``prompt_ids`` prefilled by the JAX model."""
    p = len(prompt_ids)
    cache = jm.init_kv_cache(cfg, 1, p, jnp.float32)
    _, cache = jm.prefill(cfg, params, jnp.asarray([prompt_ids], jnp.int32),
                          jnp.asarray([p], jnp.int32), cache)
    return np.stack([np.asarray(cache["k"][:, 0]), np.asarray(cache["v"][:, 0])], axis=1)


def _both(je, te, *a, **kw):
    return je.generate(*a, **kw), te.generate(*a, **kw)


def _same(a, b, lp_tol=1e-4):
    np.testing.assert_array_equal(b.output_ids, np.asarray(a.output_ids))
    np.testing.assert_array_equal(b.sequence_lengths, np.asarray(a.sequence_lengths))
    np.testing.assert_allclose(b.cum_log_probs, np.asarray(a.cum_log_probs), atol=lp_tol)


def test_prefix_prompt_matches_concatenated_and_jax(setup):
    cfg, jp, je, te = setup
    prompt, tail = [11, 7, 42, 13, 5], [21, 22, 23]
    full = te.generate([prompt + tail], output_len=6, top_k=1).output_ids[0, 0]
    table = {3: (_prefix_kv(cfg, jp, prompt), len(prompt))}
    je.set_prompt_learning_table(table)
    te.set_prompt_learning_table(table)
    a, b = _both(je, te, [tail], output_len=6, top_k=1, prompt_learning_task_name_ids=[3],
                 return_cum_log_probs=True)
    _same(a, b)
    want = full[len(prompt):]
    assert b.output_ids[0, 0, : len(want)].tolist() == want.tolist()


def test_prefix_prompt_ragged_batch(setup):
    cfg, jp, je, te = setup
    p_a, p_b, t_a, t_b = [11, 7, 42, 13, 5], [31, 9], [21, 22, 23], [44, 45]
    table = {0: (_prefix_kv(cfg, jp, p_a), len(p_a)), 1: (_prefix_kv(cfg, jp, p_b), len(p_b))}
    je.set_prompt_learning_table(table)
    te.set_prompt_learning_table(table)
    a, b = _both(je, te, [t_a, t_b], output_len=5, top_k=1,
                 prompt_learning_task_name_ids=[0, 1], return_cum_log_probs=True)
    _same(a, b)
    for p, t, row in ((p_a, t_a, 0), (p_b, t_b, 1)):
        full = te.generate([p + t], output_len=5, top_k=1).output_ids[0, 0][len(p):]
        assert b.output_ids[row, 0, : len(full)].tolist() == full.tolist()


def test_soft_prompt_matches_concatenated_and_jax(setup):
    cfg, jp, je, te = setup
    prompt, tail = [11, 7, 42, 13], [21, 22, 23]
    emb = np.asarray(jp["embed"])[np.asarray(prompt)][None]
    a, b = _both(je, te, [tail], output_len=6, top_k=1, request_prompt_embedding=emb,
                 request_prompt_lengths=[len(prompt)], return_cum_log_probs=True)
    _same(a, b)
    full = te.generate([prompt + tail], output_len=6, top_k=1).output_ids[0, 0][len(prompt):]
    assert b.output_ids[0, 0, : len(full)].tolist() == full.tolist()


def test_soft_prompt_ragged_lengths(setup):
    cfg, jp, je, te = setup
    p_a, p_b, t_a, t_b = [11, 7, 42, 13, 5, 6], [31, 9, 17], [21, 22], [44, 45, 46]
    E = np.asarray(jp["embed"])
    emb = np.zeros((2, 6, cfg.hidden_size), np.float32)
    emb[0, : len(p_a)] = E[np.asarray(p_a)]
    emb[1, : len(p_b)] = E[np.asarray(p_b)]
    a, b = _both(je, te, [t_a, t_b], output_len=4, top_k=1, request_prompt_embedding=emb,
                 request_prompt_lengths=[len(p_a), len(p_b)], return_cum_log_probs=True)
    _same(a, b)


def test_prompt_with_int8_kv_cache(setup):
    """The prefix quantized per vector into an int8 cache: the JAX engine's
    tokens and scores, and the first tokens of the concatenated run."""
    cfg, jp, _, _ = setup
    je, te = _engines(cfg, jp, kv_cache_dtype="int8")
    prompt, tail = [11, 7, 42, 13, 5], [21, 22, 23]
    table = {3: (_prefix_kv(cfg, jp, prompt), len(prompt))}
    je.set_prompt_learning_table(table)
    te.set_prompt_learning_table(table)
    a, b = _both(je, te, [tail], output_len=4, top_k=1, prompt_learning_task_name_ids=[3],
                 return_cum_log_probs=True)
    _same(a, b)
    soft = np.asarray(jp["embed"])[np.asarray(prompt)][None]
    a, b = _both(je, te, [tail], output_len=4, top_k=1, request_prompt_embedding=soft,
                 request_prompt_lengths=[5], return_cum_log_probs=True)
    _same(a, b)
    full = te.generate([prompt + tail], output_len=4, top_k=1).output_ids[0, 0][len(prompt):]
    assert b.output_ids[0, 0, :2].tolist() == full[:2].tolist()


@pytest.mark.parametrize("kv", [None, "int8"])
def test_prefix_prompt_beam_matches_concatenated_and_jax(setup, kv):
    """Every beam under a prefix prompt: the JAX engine's beams, and (fp32
    cache) the beams of the concatenated sequence; the prompt's cache slots
    are never re-pointed by the beam indirection."""
    cfg, jp, je, te = setup
    if kv:
        je, te = _engines(cfg, jp, kv_cache_dtype=kv)
    full = [3, 7, 11, 2, 9, 14, 5, 1]
    prompt, rest = full[:4], full[4:]
    table = {3: (_prefix_kv(cfg, jp, prompt), len(prompt))}
    je.set_prompt_learning_table(table)
    te.set_prompt_learning_table(table)
    a, b = _both(je, te, [rest], output_len=5, beam_width=2, prompt_learning_task_name_ids=[3])
    _same(a, b)
    if kv is None:
        want = te.generate([full], output_len=5, beam_width=2)
        for j in range(2):
            exp = want.output_ids[0, j, len(full):]
            assert b.output_ids[0, j, len(rest): len(rest) + len(exp)].tolist() == exp.tolist()
        np.testing.assert_allclose(b.cum_log_probs, want.cum_log_probs, rtol=1e-4, atol=1e-4)


def test_soft_prompt_beam_matches_jax(setup):
    cfg, jp, je, te = setup
    emb = np.random.RandomState(0).randn(2, 3, cfg.hidden_size).astype(np.float32)
    a, b = _both(je, te, [[4, 8], [5, 9, 10]], output_len=3, beam_width=2,
                 request_prompt_embedding=emb, request_prompt_lengths=[3, 2])
    _same(a, b)
    assert b.output_ids.shape[:2] == (2, 2) and (b.output_ids < cfg.vocab_size).all()


def test_gqa_prefix_prompt_is_served_and_equals_the_jax_pool():
    """One KV head (MQA): the JAX static engine refuses a [L, 2, kv_heads, P,
    dh] table (its assert checks head_num) and fails writing a [L, 2,
    head_num, P, dh] one; its pool takes kv_heads. The port's static engine
    serves the kv_heads table, token for token the JAX pool's output."""
    jcfg = JaxConfig.tiny(vocab_size=64, kv_head_num=1, qkv_layout="concat")
    jp = jax_init_params(jcfg, dtype="fp32")
    je, te = _engines(jcfg, jp)
    rng = np.random.RandomState(0)
    kv = rng.randn(jcfg.layer_num, 2, jcfg.kv_heads, 5, jcfg.size_per_head).astype(
        np.float32) * 0.3
    table = {0: (kv, 5)}
    with pytest.raises(AssertionError):
        je.set_prompt_learning_table(table)
    wide = np.repeat(kv, jcfg.head_num, axis=2)
    je.set_prompt_learning_table({0: (wide, 5)})
    with pytest.raises(Exception):
        je.generate([[3, 4, 5]], output_len=2, top_k=1, prompt_learning_task_name_ids=[0])

    te.set_prompt_learning_table(table)
    got = te.generate([[3, 4, 5]], output_len=6, top_k=1, prompt_learning_task_name_ids=[0])
    pool = JaxBatcher(je, max_slots=2, max_seq_len=32, prompt_bucket=8, prompt_table=table)
    uid = pool.submit([3, 4, 5], 6, top_k=1, prompt_task_id=0)
    want = pool.run(max_ticks=100)[uid].output_ids
    n = int(got.sequence_lengths[0, 0])
    assert got.output_ids[0, 0, :n].tolist() == want


def test_write_prefix_refuses_packed_caches_and_checks_tables(setup):
    cfg, jp, _, te = setup
    tcfg = te.config
    packed = kvc.init_cache(tcfg, 1, 16, "int4", "cpu")
    k = torch.zeros(tcfg.layer_num, 1, tcfg.kv_heads, 8, tcfg.size_per_head)
    with pytest.raises(ValueError, match="unpacked KV cache"):
        kvc.write_prefix(packed, k, k)
    with pytest.raises(ValueError, match="expected"):
        te.set_prompt_learning_table({0: (np.zeros((tcfg.layer_num, 2, 3, 4, 16)), 4)})
    _, t4 = _engines(cfg, jp, kv_cache_dtype="int4")
    t4.set_prompt_learning_table({0: (_prefix_kv(cfg, jp, [1, 2, 3]), 3)})
    with pytest.raises(ValueError, match="unpacked KV cache"):
        t4.generate([[5, 6]], output_len=2, top_k=1, prompt_learning_task_name_ids=[0])
    with pytest.raises(ValueError, match="exclusive"):
        te.generate([[5, 6]], output_len=2, prompt_learning_task_name_ids=[0],
                    request_prompt_embedding=np.zeros((1, 2, tcfg.hidden_size), np.float32))
