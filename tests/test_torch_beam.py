"""The port's beam search (fastertransformer4codefuse_tpu_torch/sampling/
beam.py, engine.generate(beam_width > 1), K11's plain version in
ops/flash_decode.py and kv_cache.attend_decode(beam=...)) against the JAX
package on tiny fp32 models with int8 weights and embeddings made by the JAX
package (``from_jax_params``), on the cases of tests/test_beam.py and
tests/test_flash_decode.py.

Tolerances: K11's plain version within 2e-4 of the JAX all-pairs attention
(fp32, summation order only) and 3e-2 of the JAX Pallas kernel in interpret
mode (bf16 probabilities, as tests/test_flash_decode.py holds it); beam
tokens and lengths identical to the JAX engine's, cumulative and per-step
log-probs within 1e-4 (fp32 log-softmax in another order of ops); each
hypothesis' score within 1e-3 of its teacher-forced rescoring (as
tests/test_beam.py); tie order exactly JAX's."""
import dataclasses
import types

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
from fastertransformer4codefuse_tpu.ops.flash_decode import (
    flash_decode_beam_stacked as jax_flash_decode_beam,
)
from fastertransformer4codefuse_tpu_torch import (
    GptNeoXConfig,
    GptNeoXEngine,
    RuntimeConfig,
    from_jax_params,
)
from fastertransformer4codefuse_tpu_torch.engine import kv_cache as kvc
from fastertransformer4codefuse_tpu_torch.engine import paged_kv
from fastertransformer4codefuse_tpu_torch.models import gptneox as tm
from fastertransformer4codefuse_tpu_torch.ops.flash_decode import (
    flash_decode_beam_plain,
    pack_seq_pairs,
)
from fastertransformer4codefuse_tpu_torch.sampling.beam import NEG_INF, sort_outputs, top_k_stable

torch.set_num_threads(2)

PROMPTS = [[5, 9, 3, 17, 2], [11, 4, 60]]


def _models(**overrides):
    """JAX-made int8 weights with non-trivial norms and biases, in both
    packages."""
    jcfg = JaxConfig.tiny(head_num=4, size_per_head=8, vocab_size=64, **overrides)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0), dtype="fp32", int8_mode=1,
                         quantize_embeddings=True)
    rng = np.random.default_rng(1)
    layers = dict(jp["layers"])
    for k, v in layers.items():
        if k.endswith("_b"):
            layers[k] = jnp.asarray(rng.standard_normal(v.shape) * 0.1, jnp.float32)
        elif k.startswith("ln"):
            layers[k] = jnp.asarray(1 + rng.standard_normal(v.shape) * 0.1, jnp.float32)
    jp = dict(jp, layers=layers)
    cfg = GptNeoXConfig(**dataclasses.asdict(jcfg))
    return jcfg, jp, cfg, from_jax_params(jp, device="cpu")


@pytest.fixture(scope="module")
def mha():
    return _models()


@pytest.fixture(scope="module")
def gqa():
    return _models(kv_head_num=2, qkv_layout="concat")


def _engines(models, kv="int8"):
    jcfg, jp, cfg, tp = models
    kw = dict(dtype="fp32", int8_mode=1, kv_cache_dtype=kv, seq_bucket=8)
    return JaxEngine(jcfg, jp, JaxRuntime(**kw)), GptNeoXEngine(cfg, tp, RuntimeConfig(**kw))


def _assert_same_beams(to, jo):
    np.testing.assert_array_equal(to.output_ids, jo.output_ids)
    np.testing.assert_array_equal(to.sequence_lengths, jo.sequence_lengths)
    np.testing.assert_allclose(to.cum_log_probs, jo.cum_log_probs, rtol=1e-4, atol=1e-4)
    if jo.output_log_probs is not None:
        np.testing.assert_allclose(to.output_log_probs, jo.output_log_probs, rtol=1e-4,
                                   atol=1e-4)


# ------------------------------------------------------------ K11 plain ----
def _bf16_exact(x):
    """float32 values that bf16 holds exactly (both packages store them)."""
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16).float().numpy()


def _beam_cache(rng, kind, L, BB, nKV, S, dh):
    """(JAX cache, port cache) of one ``kind`` from the same numpy values."""
    if kind == "fp32":
        c = {n: rng.standard_normal((L, BB, nKV, S, dh)).astype(np.float32) for n in "kv"}
        return ({n: jnp.asarray(a) for n, a in c.items()},
                {n: torch.from_numpy(a) for n, a in c.items()})
    qmax = {"k": 7 if kind == "int4" else 127, "v": 127 if kind == "int8" else 7}
    codes = {n: rng.integers(-q, q + 1, (L, BB, nKV, S, dh)) for n, q in qmax.items()}
    scales = {n + "_s": _bf16_exact(rng.uniform(0.01, 0.1, (L, BB, nKV, S))) for n in "kv"}
    packed = {"int8": (), "int4": ("k", "v"), "int8k_int4v": ("v",)}[kind]
    jc, tc = {}, {}
    for n, a in codes.items():
        t = torch.from_numpy(a.astype(np.int8))
        name = n + "4" if n in packed else n
        t = pack_seq_pairs(t) if n in packed else t
        jc[name], tc[name] = jnp.asarray(t.numpy()), t
    for n, a in scales.items():
        jc[n], tc[n] = jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)
    return jc, tc


@pytest.mark.parametrize("kind", ["fp32", "int8", "int4", "int8k_int4v"])
@pytest.mark.parametrize("nKV", [4, 2])  # MHA and GQA
def test_k11_plain_matches_jax_attend_decode_beam(kind, nKV):
    """K11's plain version (the physical gather, then K4's plain math) ==
    the JAX all-pairs one-hot formulation, through kv_cache.attend_decode."""
    rng = np.random.default_rng(0)
    L, B, bw, nH, S, dh = 2, 2, 3, 4, 16, 8
    BB = B * bw
    q = rng.standard_normal((BB, nH, dh)).astype(np.float32)
    pos = rng.integers(4, S, (BB,)).astype(np.int32)
    indir = rng.integers(0, bw, (BB, S)).astype(np.int32)
    jc, tc = _beam_cache(rng, kind, L, BB, nKV, S, dh)
    valid = jnp.asarray(np.arange(S)[None, :] <= pos[:, None])
    want = jkvc.attend_decode_beam(jc, jnp.int32(1), jnp.asarray(q), valid, 0.3,
                                   jnp.asarray(indir), bw)
    got = kvc.attend_decode(tc, 1, torch.from_numpy(q), 0.3, torch.from_numpy(pos),
                            beam=(bw, torch.from_numpy(indir)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


def test_k11_plain_matches_jax_kernel_in_interpret_mode():
    """tests/test_flash_decode.py's odd-width bf16 case: the Pallas beam
    kernel in interpret mode against K11's plain version."""
    rng = np.random.default_rng(1)
    L, B, bw, nH, dh, S = 2, 1, 3, 4, 128, 384
    BB = B * bw
    k = _bf16_exact(rng.standard_normal((L, BB, nH, S, dh)))
    v = _bf16_exact(rng.standard_normal((L, BB, nH, S, dh)))
    q = _bf16_exact(rng.standard_normal((BB, nH, dh)))
    pos = rng.integers(S // 4, S - 1, (BB,)).astype(np.int32)
    indir = rng.integers(0, bw, (BB, S)).astype(np.int32)
    bf = jnp.bfloat16
    want = jax_flash_decode_beam(
        jnp.asarray(q, bf), jnp.asarray(k, bf), None, jnp.asarray(v, bf), None, jnp.int32(1),
        jnp.asarray(pos), jnp.asarray(indir), bw, sm_scale=0.11, interpret=True)
    t = {n: torch.from_numpy(a).to(torch.bfloat16) for n, a in (("q", q), ("k", k), ("v", v))}
    got = flash_decode_beam_plain(t["q"], t["k"], None, t["v"], None, 1, torch.from_numpy(pos),
                                  torch.from_numpy(indir), bw, 0.11)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=3e-2,
                               atol=3e-2)


def test_paged_cache_refuses_beams(mha):
    cfg = mha[2]
    cache = paged_kv.init_paged_cache(cfg, 2, 16, 5, 8, torch.int8, "cpu")
    q = torch.zeros(2, cfg.head_num, cfg.size_per_head)
    with pytest.raises(ValueError, match="paged pools do not support beam search"):
        kvc.attend_decode(cache, 0, q, 0.3, torch.zeros(2, dtype=torch.int32),
                          beam=(2, torch.zeros(2, 16, dtype=torch.int32)))


# ------------------------------------------------------------ tie order ----
def test_selection_ties_follow_jax_order():
    """jax.lax.top_k and jnp.argsort take the lower index among equal values;
    the port's top_k_stable and the final sort (a stable sort of -score) do
    the same on inputs made mostly of ties."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 4, (32, 50)).astype(np.float32)
    x[:, ::7] = NEG_INF
    for k in (1, 3, 8, 16):
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        tv, ti = top_k_stable(torch.from_numpy(x), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    B, bw = 16, 4
    cum = rng.integers(-3, 0, (B * bw,)).astype(np.float32)
    s = types.SimpleNamespace(
        tokens=torch.arange(B * bw, dtype=torch.int32)[:, None], seq_lens=torch.full((B * bw,), 9),
        cum_log_probs=torch.from_numpy(cum), step_log_probs=None)
    inputs = {"input_lengths": torch.full((B * bw,), 4), "len_penalty": torch.zeros(B * bw)}
    rows = sort_outputs(inputs, s, B, bw)[0][:, 0].numpy()
    order = np.asarray(jnp.argsort(-jnp.asarray(cum).reshape(B, bw), axis=1))
    np.testing.assert_array_equal(rows, (np.arange(B)[:, None] * bw + order).reshape(-1))


# ---------------------------------------------------------------- engine ----
OLT = np.array([[40, 9, -1], [7, 33, 2]], np.int32)
BAD = np.array([[[12, 30], [1, 2]], [[12, -1], [1, -1]]], np.int32)
ENGINE_CASES = {
    "bw2": (2, {}),
    "bw3 diversity, len_penalty, output_log_probs": (
        3, dict(beam_search_diversity_rate=0.4, len_penalty=[0.6, 1.2], output_log_probs=True)),
    "bw4 temperature, repetition penalty, min_length": (
        4, dict(temperature=0.8, repetition_penalty=1.3, min_length=5)),
    "bw3 optional_last_tokens, bad words": (
        3, dict(optional_last_tokens=OLT, bad_words_list=BAD, len_penalty=0.8)),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_beam_generate_matches_jax(mha, case):
    bw, kw = ENGINE_CASES[case]
    jeng, teng = _engines(mha)
    jo = jeng.generate(PROMPTS, output_len=8, beam_width=bw, **kw)
    to = teng.generate(PROMPTS, output_len=8, beam_width=bw, **kw)
    assert to.output_ids.shape[:2] == (2, bw)
    _assert_same_beams(to, jo)


@pytest.mark.parametrize("models,kv,bw", [("mha", "int4", 2), ("mha", "int4", 3),
                                          ("gqa", "int8", 3)])
def test_beam_generate_matches_jax_on_int4_kv_and_gqa(request, models, kv, bw):
    jeng, teng = _engines(request.getfixturevalue(models), kv=kv)
    kw = dict(output_len=7, beam_width=bw, len_penalty=0.5, output_log_probs=True)
    _assert_same_beams(teng.generate(PROMPTS, **kw), jeng.generate(PROMPTS, **kw))


def _stop_on_a_first_pick(jeng, prompt, bw, out_len):
    """A stop word on one beam's first generated token, so that beams finish
    at different steps (tests/test_beam.py)."""
    g = jeng.generate([prompt], output_len=out_len, beam_width=bw)
    first = sorted({int(t) for t in g.output_ids[0, :, len(prompt)]})[0]
    return np.array([[[first], [1]]], np.int32)


def test_beam_stop_words_and_stream_match_jax(mha):
    """Stop words end beams at different steps; the streamed callback's
    messages (every beam's newest token and index) equal JAX's, and the
    streamed run's outputs equal the one-shot run's."""
    jeng, teng = _engines(mha)
    prompt, bw = PROMPTS[0], 3
    sw = _stop_on_a_first_pick(jeng, prompt, bw, 8)
    kw = dict(output_len=8, beam_width=bw, stop_words_list=sw)
    jo = jeng.generate([prompt], **kw)
    assert len(set(jo.sequence_lengths[0].tolist())) > 1, "every beam stopped at one step"
    _assert_same_beams(teng.generate([prompt], **kw), jo)
    msgs = {"jax": [], "torch": []}
    js = jeng.generate([prompt], callback=msgs["jax"].append, **kw)
    ts = teng.generate([prompt], callback=msgs["torch"].append, **kw)
    assert msgs["torch"] == msgs["jax"] and len(msgs["jax"]) >= 2
    assert all(len(m["last_tokens"][0]) == bw for m in msgs["torch"])
    _assert_same_beams(ts, js)
    _assert_same_beams(ts, jo)


@pytest.mark.parametrize("case", ["stop on a first pick", "stop at different steps"])
def test_beam_scores_match_teacher_forced_rescoring(mha, case):
    """Every returned hypothesis' score equals the sum of its token
    log-probs under the model, with beams finishing at different steps
    (tests/test_beam.py). The second case's beams stop after 1, 2, 3 and 12
    tokens and are reordered meanwhile: a finished beam that wrote its KV at
    its frozen position instead of slot S - 1 would clobber a slot that a
    live beam reads through the indirection, and break the equality."""
    jeng, _ = _engines(mha, kv="fp32")
    _, _, cfg, tp = mha
    teng = GptNeoXEngine(cfg, tp, RuntimeConfig(dtype="fp32", int8_mode=1, seq_bucket=4))
    if case == "stop on a first pick":
        prompt, bw, out_len = [3, 4, 5, 6], 3, 8
        sw = _stop_on_a_first_pick(jeng, prompt, bw, out_len)
    else:
        prompt, bw, out_len = [43, 51, 3, 52, 31], 4, 12
        sw = np.array([[[46], [1]]], np.int32)
    out = teng.generate([prompt], output_len=out_len, beam_width=bw, stop_words_list=sw)
    assert len(set(out.sequence_lengths[0].tolist())) > 1
    for j in range(bw):
        seq = [int(x) for x in out.output_ids[0, j, : out.sequence_lengths[0, j]]]
        T = len(seq)
        cache = kvc.init_cache(cfg, 1, T, torch.float32, "cpu")
        hidden, _ = tm.prefill(cfg, tp, torch.tensor([seq]), torch.tensor([T], dtype=torch.int32),
                               cache)
        lp = torch.log_softmax(tm.lm_logits(cfg, tp, hidden)[0], dim=-1)
        want = sum(float(lp[t - 1, seq[t]]) for t in range(len(prompt), T))
        assert abs(float(out.cum_log_probs[0, j]) - want) < 1e-3, (j, seq)


def test_static_handler_beams_match_jax(mha):
    """A beam request on the static path of the handler (no pool), streamed
    and not: the port's response and its per-(batch, beam) streamed text
    equal the JAX handler's."""
    import json

    from fastertransformer4codefuse_tpu.api.handler import CodeFuseHandler as JaxHandler
    from fastertransformer4codefuse_tpu.api.trie import VocabTrie as JaxTrie
    from fastertransformer4codefuse_tpu_torch.api.handler import CodeFuseHandler
    from fastertransformer4codefuse_tpu_torch.api.trie import VocabTrie
    from test_api import CharTokenizer

    jeng, teng = _engines(mha)
    tok = CharTokenizer(("vo", "void"))
    streams = {"jax": [], "torch": []}
    jh = JaxHandler(engine=jeng, tokenizer=tok, trie=JaxTrie(tok.get_vocab()), warmup=False,
                    on_stream_text=lambda b, j, s: streams["jax"].append((b, j, s)))
    th = CodeFuseHandler(engine=teng, tokenizer=tok, trie=VocabTrie(tok.get_vocab()),
                         warmup=False,
                         on_stream_text=lambda b, j, s: streams["torch"].append((b, j, s)))
    req = {"prompts": [{"prompt": "def fib(n):", "len_penalty": 0.6, "last_token": "",
                        "random_seed": 3},
                       {"prompt": "int main", "beam_search_diversity_rate": 0.3,
                        "last_token": "vo", "random_seed": 4}],
           "out_seq_length": 8, "beam_width": 3}
    for stream in (False, True):
        (jcode, jmsg, jres), (tcode, tmsg, tres) = (h.predict(dict(req, stream=stream), "r")
                                                    for h in (jh, th))
        assert jcode == 0 and tcode == 0, (jmsg, tmsg)
        jr, tr = json.loads(jres["res"]), json.loads(tres["res"])
        assert len(tr["generated_code"][0]) == 3
        for key in ("generated_code", "length", "random_seed"):
            assert tr[key] == jr[key], key
        np.testing.assert_allclose(tr["cum_log_prob"], jr["cum_log_prob"], rtol=1e-4, atol=1e-4)
    assert streams["torch"] == streams["jax"] and streams["torch"]
