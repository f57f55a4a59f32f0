"""The port's prompt-lookup speculative decoding
(fastertransformer4codefuse_tpu_torch/engine/speculative.py) against the JAX
package's engine/speculative.py, on the tiny fp32 models of
tests/test_speculative.py (weights made by the JAX package and copied with
``from_jax_params``), and on the cases of that file.

Tolerances: tokens identical to the JAX function's, and SpecStats' counts
equal; cum_log_prob within 1e-3 (fp32 log-softmax of logits that agree to
summation order); the matchers identical."""
import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

from fastertransformer4codefuse_tpu import GptNeoXConfig as JaxConfig
from fastertransformer4codefuse_tpu import GptNeoXEngine as JaxEngine
from fastertransformer4codefuse_tpu import RuntimeConfig as JaxRuntime
from fastertransformer4codefuse_tpu import init_params as jax_init_params
from fastertransformer4codefuse_tpu.engine import speculative as jspec
from fastertransformer4codefuse_tpu_torch import (
    GptNeoXConfig,
    GptNeoXEngine,
    RuntimeConfig,
    from_jax_params,
)
from fastertransformer4codefuse_tpu_torch.engine import speculative as spec

torch.set_num_threads(2)

REPEAT = [7, 8, 9, 10, 7, 8, 9, 10, 7, 8, 9, 10, 7, 8]


def _engines(seed, **quant):
    jcfg = JaxConfig.tiny(head_num=4, size_per_head=8, vocab_size=64)
    jp = jax_init_params(jcfg, rng=jax.random.PRNGKey(seed), dtype="fp32", **quant)
    kw = dict(dtype="fp32", seq_bucket=8)
    if quant:
        kw.update(int8_mode=1, kv_cache_dtype="int8")
    cfg = GptNeoXConfig(**dataclasses.asdict(jcfg))
    return (JaxEngine(jcfg, jp, JaxRuntime(**kw)),
            GptNeoXEngine(cfg, from_jax_params(jp, device="cpu"), RuntimeConfig(**kw)))


@pytest.fixture(scope="module")
def engines():
    return {seed: _engines(seed) for seed in (0, 1, 2, 3)}


def _greedy(eng, prompt, n):
    ref = eng.generate([prompt], output_len=n, top_k=1)
    m = int(ref.sequence_lengths[0, 0])
    return [int(x) for x in ref.output_ids[0, 0, :m]]


def _same_stats(got, want):
    for f in ("iterations", "drafted", "accepted", "emitted"):
        assert getattr(got, f) == getattr(want, f), (f, got, want)
    np.testing.assert_allclose(got.cum_log_prob, want.cum_log_prob, atol=1e-3)


def test_propose_ngram_cases():
    """tests/test_speculative.py::test_propose_ngram on the port."""
    toks = np.asarray([5, 6, 7, 9, 5, 6, 7, 8, 1, 5, 6, 7], np.int32)
    np.testing.assert_array_equal(spec.propose_ngram(toks, 3, 3), [8, 1, 5])
    assert len(spec.propose_ngram(np.asarray([1, 2, 3, 4], np.int32), 3, 4)) == 0
    toks2 = np.asarray([5, 6, 1, 5, 6, 2, 5, 6], np.int32)
    np.testing.assert_array_equal(spec.propose_ngram(toks2, 2, 2), [2, 5])


@settings(max_examples=60, deadline=None)
@given(
    data=st.lists(st.integers(0, 4), min_size=4, max_size=40),
    n=st.integers(1, 4),
    k=st.integers(1, 6),
    fill=st.integers(0, 4),
)
def test_matchers_match_jax(data, n, k, fill):
    """On drawn buffers of a small alphabet (so matches are common): the
    host reference equals JAX's, the device matcher equals JAX's draft and
    hit flag for every prefix length at once (rows of one batch), and where
    it hits, its draft starts with the host reference's continuation."""
    toks = np.asarray(data, np.int32)
    np.testing.assert_array_equal(spec.propose_ngram(toks, n, k),
                                  jspec.propose_ngram(toks, n, k))
    S = len(toks) + k + 2
    buf = np.full((S,), fill, np.int32)
    buf[: len(toks)] = toks
    lens = np.arange(1, len(toks) + 1, dtype=np.int32)
    d, h = spec.propose_device(torch.from_numpy(np.tile(buf, (len(lens), 1))),
                               torch.from_numpy(lens), n, k)
    for i, l in enumerate(lens):
        jd, jh = jspec._propose_device(jnp.asarray(buf), jnp.int32(l), n, k)
        np.testing.assert_array_equal(d[i].numpy(), np.asarray(jd))
        assert bool(h[i]) == bool(jh)
        if bool(h[i]):
            host = spec.propose_ngram(buf[:l], n, k)
            np.testing.assert_array_equal(d[i].numpy()[: len(host)], host)


@pytest.mark.parametrize("k", [2, 4, 8])
@pytest.mark.parametrize("seed,prompt,out", [(0, REPEAT, 16), (3, [3, 4, 5], 24),
                                             (1, [3, 4, 5, 6], 30)])
def test_speculative_generate_matches_jax(engines, k, seed, prompt, out):
    """Token for token the JAX function's (and so the engine's greedy),
    SpecStats equal, cum_log_prob within 1e-3; seed 1 ends in an end id."""
    jeng, teng = engines[seed]
    want, wstats = jspec.speculative_generate(jeng, prompt, out, k=k, ngram=3)
    got, stats = spec.speculative_generate(teng, prompt, out, k=k, ngram=3)
    assert got == want
    _same_stats(stats, wstats)
    assert got == _greedy(teng, prompt, out)


def test_speculative_accepts_on_a_cycle(engines):
    """tests/test_speculative.py::test_speculative_accepts_on_repetitive_
    continuation: a tiny random model settles into a cycle, and the drafts
    then commit several tokens a step."""
    jeng, teng = engines[3]
    got, stats = spec.speculative_generate(teng, [3, 4, 5], 24, k=8, ngram=3)
    assert got == _greedy(teng, [3, 4, 5], 24)
    assert len(got) == 3 + 24 and stats.accepted > 0 and stats.tokens_per_step > 1.0


def test_end_id_truncates(engines):
    """The first committed end id ends the output, in both forms, where the
    engine's greedy ends; the budget may stop a row short of its draft."""
    jeng, teng = engines[1]
    prompt = [3, 4, 5, 6]
    want = _greedy(teng, prompt, 30)
    assert want[-1] == teng.config.end_id and len(want) < len(prompt) + 30
    got, stats = spec.speculative_generate(teng, prompt, 30, k=6)
    assert got == want and stats.emitted == len(want) - len(prompt)
    outs, _ = spec.speculative_generate_batched(teng, [prompt, REPEAT], 30, k=6)
    assert outs[0] == want
    got, stats = spec.speculative_generate(teng, REPEAT, 3, k=8)  # budget below k + 1
    assert got == _greedy(teng, REPEAT, 3) and stats.emitted == 3


PROMPTS = [REPEAT, [3, 4, 5], [11, 12, 11, 12, 11, 12, 11]]


@pytest.mark.parametrize("k", [3, 6])
def test_batched_matches_per_row_and_jax(engines, k):
    """Each row equals the B = 1 form on its prompt alone and the JAX
    batched form; the stats equal JAX's batched stats."""
    jeng, teng = engines[2]
    outs, stats = spec.speculative_generate_batched(teng, PROMPTS, 14, k=k, ngram=3)
    jouts, jstats = jspec.speculative_generate_batched(jeng, PROMPTS, 14, k=k, ngram=3)
    assert outs == jouts
    for p, got, st_, jst in zip(PROMPTS, outs, stats, jstats):
        _same_stats(st_, jst)
        alone, _ = spec.speculative_generate(teng, p, 14, k=k, ngram=3)
        assert got == alone and st_.emitted == len(got) - len(p)


def test_batched_matches_greedy_with_end_ids(engines):
    """tests/test_speculative.py::test_batched_matches_plain_greedy_and_eos."""
    jeng, teng = engines[1]
    prompts = [[3, 4, 5, 6], [9, 2, 9, 2, 9]]
    outs, stats = spec.speculative_generate_batched(teng, prompts, 20, k=6, ngram=3)
    jouts, jstats = jspec.speculative_generate_batched(jeng, prompts, 20, k=6, ngram=3)
    assert outs == jouts
    for b, p in enumerate(prompts):
        assert outs[b] == _greedy(teng, p, 20)
        _same_stats(stats[b], jstats[b])


def test_int8_weights_and_cache_match_jax():
    """The served quantization (int8 weights and embeddings, int8 KV cache):
    the same tokens as the JAX function, in both forms."""
    jeng, teng = _engines(2, int8_mode=1, quantize_embeddings=True)
    want, wstats = jspec.speculative_generate(jeng, REPEAT, 12, k=4)
    got, stats = spec.speculative_generate(teng, REPEAT, 12, k=4)
    assert got == want
    _same_stats(stats, wstats)
    outs, _ = spec.speculative_generate_batched(teng, PROMPTS, 12, k=4)
    assert outs == jspec.speculative_generate_batched(jeng, PROMPTS, 12, k=4)[0]


def test_packed_kv_cache_is_refused(engines):
    _, teng = engines[0]
    eng4 = GptNeoXEngine(teng.config, teng.params, RuntimeConfig(dtype="fp32",
                                                                 kv_cache_dtype="int4"))
    with pytest.raises(ValueError, match="unpacked KV cache"):
        spec.speculative_generate(eng4, REPEAT, 4)
