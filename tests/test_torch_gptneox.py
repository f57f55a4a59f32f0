"""The ported slice end to end against the JAX package, on
``GptNeoXConfig.tiny()`` with weight-only int8 weights and embeddings, an int8
KV cache, fp32, both residual modes. Weights are made once by the JAX package
and carried over with ``from_jax_params``.

Tolerances: logits within 1e-4 of max |logits| (fp32, summation order only);
greedy tokens and handler texts identical; sampled paths compared through the
processed logits and the top-k/top-p filtered distribution, with the JAX
package's Gumbel noise fed to both (jax.random and torch draw different
numbers from one seed)."""
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
from fastertransformer4codefuse_tpu.api.handler import CodeFuseHandler as JaxHandler
from fastertransformer4codefuse_tpu.api.trie import VocabTrie as JaxTrie
from fastertransformer4codefuse_tpu.models import gptneox as jm
from fastertransformer4codefuse_tpu.sampling import processors as jproc
from fastertransformer4codefuse_tpu.sampling import sample as jsample
from fastertransformer4codefuse_tpu_torch import (
    GptNeoXConfig,
    GptNeoXEngine,
    RuntimeConfig,
    from_jax_params,
)
from fastertransformer4codefuse_tpu_torch.api.handler import CodeFuseHandler
from fastertransformer4codefuse_tpu_torch.api.trie import VocabTrie
from fastertransformer4codefuse_tpu_torch.engine import kv_cache as kvc
from fastertransformer4codefuse_tpu_torch.models import gptneox as tm
from fastertransformer4codefuse_tpu_torch.sampling import processors as tproc
from fastertransformer4codefuse_tpu_torch.sampling import sample as tsample
from test_api import CharTokenizer

torch.set_num_threads(2)

# (parallel residual, activation): K13 + K3 decode (tanh and exact gelu), serial K1 GEMMs
MODES = [(True, "gelu-tanh"), (True, "gelu"), (False, "gelu")]


def _models(gptj, act, vocab=128, **quant):
    """JAX-made weights (``quant``: weight_bits, group_size) in both packages."""
    jcfg = JaxConfig.tiny(vocab_size=vocab, use_gptj_residual=gptj, activation=act)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0), dtype="fp32", int8_mode=1,
                         quantize_embeddings=True, **quant)
    rng = np.random.default_rng(1)
    layers = dict(jp["layers"])
    for k, v in layers.items():  # non-trivial norms and biases
        if k.endswith("_b"):
            layers[k] = jnp.asarray(rng.standard_normal(v.shape) * 0.1, jnp.float32)
        elif k.startswith("ln"):
            layers[k] = jnp.asarray(1 + rng.standard_normal(v.shape) * 0.1, jnp.float32)
    jp = dict(jp, layers=layers)
    cfg = GptNeoXConfig(**dataclasses.asdict(jcfg))
    return jcfg, jp, cfg, from_jax_params(jp, device="cpu")


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_config_matches_jax(tmp_path):
    for name in ("codefuse_13b", "tiny"):
        assert dataclasses.asdict(getattr(GptNeoXConfig, name)()) == dataclasses.asdict(
            getattr(JaxConfig, name)()
        )
    cfg = GptNeoXConfig.tiny(rotary_style="gptj", activation="gelu-tanh")
    cfg.to_ini(str(tmp_path))
    assert GptNeoXConfig.from_ini(str(tmp_path)) == cfg
    assert dataclasses.asdict(JaxConfig.from_ini(str(tmp_path))) == dataclasses.asdict(cfg)


@pytest.mark.parametrize("style", ["neox", "gptj"])
def test_norms_and_rotary_match_jax(style):
    from fastertransformer4codefuse_tpu.ops import layernorm as jln
    from fastertransformer4codefuse_tpu.ops import rotary as jrot
    from fastertransformer4codefuse_tpu_torch.ops import layernorm as tln
    from fastertransformer4codefuse_tpu_torch.ops import rotary as trot

    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    w, b = (rng.standard_normal(16).astype(np.float32) for _ in range(2))
    J, T_ = jnp.asarray, torch.from_numpy
    np.testing.assert_allclose(tln.layernorm(T_(x), T_(w), T_(b)).numpy(),
                               np.asarray(jln.layernorm(J(x), J(w), J(b))), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tln.rmsnorm(T_(x), T_(w)).numpy(),
                               np.asarray(jln.rmsnorm(J(x), J(w))), rtol=1e-5, atol=1e-5)
    jc, js = jrot.make_rotary_tables(5, 8, 10000.0)
    tc, ts = trot.make_rotary_tables(5, 8, 10000.0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        trot.apply_rotary(T_(x), tc, ts, 8, style).numpy(),
        np.asarray(jrot.apply_rotary(J(x), jc, js, 8, style)), rtol=1e-5, atol=1e-5,
    )


@pytest.mark.parametrize("gptj,act", MODES)
def test_prefill_and_decode_logits_match_jax(gptj, act):
    jcfg, jp, cfg, tp = _models(gptj, act)
    B, S, Smax, steps = 2, 8, 24, 8
    rng = np.random.default_rng(2)
    ids = rng.integers(2, jcfg.vocab_size, (B, S)).astype(np.int32)
    lens = np.array([S, 5], np.int32)
    feed = rng.integers(2, jcfg.vocab_size, (steps, B)).astype(np.int32)

    @jax.jit
    def jprefill(p, ids, lens, c):
        h, c = jm.prefill(jcfg, p, ids, lens, c)
        return jm.lm_logits(jcfg, p, jm.last_token_hidden(h, lens)), c

    @jax.jit
    def jdecode(p, tok, pos, c):
        h, c = jm.decode_step(jcfg, p, tok, pos, c)
        return jm.lm_logits(jcfg, p, h), c

    jc = jm.init_kv_cache(jcfg, B, Smax, jnp.int8)
    jl, jc = jprefill(jp, jnp.asarray(ids), jnp.asarray(lens), jc)
    tc = kvc.init_cache(cfg, B, Smax, torch.int8, "cpu")
    h, tc = tm.prefill(cfg, tp, torch.from_numpy(ids), torch.from_numpy(lens), tc)
    tl = tm.lm_logits(cfg, tp, tm.last_token_hidden(h, torch.from_numpy(lens)))
    assert tl.dtype == torch.float32 and tl.shape == (B, jcfg.vocab_size)
    assert _rel(tl, jl) < 1e-4
    for t in range(steps):
        pos = lens + t
        jl, jc = jdecode(jp, jnp.asarray(feed[t]), jnp.asarray(pos), jc)
        h, tc = tm.decode_step(cfg, tp, torch.from_numpy(feed[t]), torch.from_numpy(pos), tc)
        assert _rel(tm.lm_logits(cfg, tp, h), jl) < 1e-4, t


def _engines(gptj, act, vocab=128, end_id=1, **quant):
    jcfg, jp, cfg, tp = _models(gptj, act, vocab, **quant)
    jcfg = dataclasses.replace(jcfg, end_id=end_id)
    cfg = dataclasses.replace(cfg, end_id=end_id)
    kw = dict(dtype="fp32", int8_mode=1, kv_cache_dtype="int8", seq_bucket=8)
    return JaxEngine(jcfg, jp, JaxRuntime(**kw)), GptNeoXEngine(cfg, tp, RuntimeConfig(**kw))


@pytest.mark.parametrize("gptj,act", [MODES[0], MODES[2]])
def test_greedy_generate_matches_jax(gptj, act):
    jeng, teng = _engines(gptj, act, end_id=127)
    prompts = [[5, 9, 3, 17, 2], [11, 4, 90]]
    kw = dict(output_len=8, top_k=1, return_cum_log_probs=True, output_log_probs=True)
    jo = jeng.generate(prompts, **kw)
    to = teng.generate(prompts, **kw)
    np.testing.assert_array_equal(to.output_ids, jo.output_ids)
    np.testing.assert_array_equal(to.sequence_lengths, jo.sequence_lengths)
    np.testing.assert_allclose(to.cum_log_probs, jo.cum_log_probs, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(to.output_log_probs, jo.output_log_probs, rtol=1e-4, atol=1e-4)
    assert teng.decode_forwards == 7


def test_processors_match_jax():
    rng = np.random.default_rng(5)
    B, V, T = 3, 64, 12
    logits = (rng.standard_normal((B, V)) * 3).astype(np.float32)
    buf = rng.integers(0, V, (B, T)).astype(np.int32)
    lens = np.array([12, 7, 3], np.int32)
    valid = np.arange(T)[None, :] < lens[:, None]
    words = np.full((B, 2, 4), -1, np.int32)
    words[:, 0] = 0
    words[0, 0, :3], words[0, 1, :2] = [buf[0, 10], buf[0, 11], 9], [2, 3]  # "x y" ends row 0
    words[1, 0, :2], words[1, 1, :1] = [buf[1, 5], buf[1, 6]], [2]  # bad word prefix matches
    words[2, 0, :1], words[2, 1, :1] = [7], [1]
    olt = np.array([[3, 5, -1], [-1, -1, -1], [60, -1, -1]], np.int32)
    J, T_ = jnp.asarray, torch.from_numpy
    cases = [
        (jproc.apply_temperature(J(logits), J(np.array([0.7, 1.0, 0.0], np.float32))),
         tproc.apply_temperature(T_(logits), T_(np.array([0.7, 1.0, 0.0], np.float32)))),
        (jproc.apply_repetition_penalty(J(logits), J(buf), J(valid), J(np.array([1.3, 1.0, 0.8], np.float32))),
         tproc.apply_repetition_penalty(T_(logits), T_(buf), T_(valid), T_(np.array([1.3, 1.0, 0.8], np.float32)))),
        (jproc.apply_presence_penalty(J(logits), J(buf), J(valid), J(np.array([0.5, 0.0, 1.0], np.float32))),
         tproc.apply_presence_penalty(T_(logits), T_(buf), T_(valid), T_(np.array([0.5, 0.0, 1.0], np.float32)))),
        (jproc.apply_min_length(J(logits), J(np.array([0, 4, 9])), J(np.array([2, 2, 2])), 1),
         tproc.apply_min_length(T_(logits), T_(np.array([0, 4, 9])), T_(np.array([2, 2, 2])), 1)),
        (jproc.apply_optional_last_tokens(J(logits), J(olt), 1, True),
         tproc.apply_optional_last_tokens(T_(logits), T_(olt), 1, True)),
        (jproc.ban_bad_words(J(logits), J(buf), J(lens), J(words), 1),
         tproc.ban_bad_words(T_(logits), T_(buf), T_(lens), T_(words), 1)),
    ]
    for i, (j, t) in enumerate(cases):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=str(i))
    stop = jproc.stop_words_criterion(J(buf), J(lens), J(words), 1)
    np.testing.assert_array_equal(
        tproc.stop_words_criterion(T_(buf), T_(lens), T_(words), 1).numpy(), np.asarray(stop)
    )
    assert bool(stop[0])


@pytest.mark.parametrize("capped", [False, True])
def test_top_k_top_p_sampling_matches_jax_with_shared_noise(capped):
    rng = np.random.default_rng(6)
    B, V, draws = 4, 96, 24
    logits = (rng.standard_normal((B, V)) * 2).astype(np.float32)
    top_k = np.array([40, 1, 7, 64], np.int32)
    top_p = np.array([0.9, 0.0, 0.5, 0.95], np.float32)
    n = min(64, V) if capped else V
    for d in range(draws):
        keys = jax.random.split(jax.random.PRNGKey(d), B)
        noise = jax.vmap(lambda k: jax.random.gumbel(k, (n,), jnp.float32))(keys)
        args = (jnp.asarray(logits), jnp.asarray(top_k), jnp.asarray(top_p))
        targs = (torch.from_numpy(logits), torch.from_numpy(top_k), torch.from_numpy(top_p))
        gumbel = torch.from_numpy(np.array(noise))
        if capped:
            ref = jsample.sample_top_k_top_p_capped(keys, *args, cap=64)
            got = tsample.sample_top_k_top_p_capped(*targs, gumbel, cap=64)
        else:
            ref = jsample.sample_top_k_top_p(keys, *args)
            got = tsample.sample_top_k_top_p(*targs, gumbel)
        np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
        np.testing.assert_allclose(got.log_probs.numpy(), np.asarray(ref.log_probs), atol=1e-5)
    # the filtered distribution itself: row 1 (top_k 1) keeps only the argmax
    masked = tsample.top_k_top_p_filter(*targs)
    kept = (masked > -1e30).sum(dim=1).tolist()
    assert kept[1] == 1 and kept[0] <= 40 and kept[2] <= 7


def _handlers():
    tok = CharTokenizer(("vo", "void"))
    jeng, teng = _engines(True, "gelu-tanh", vocab=64)
    streams = {"jax": [], "torch": []}
    jh = JaxHandler(engine=jeng, tokenizer=tok, trie=JaxTrie(tok.get_vocab()), warmup=False,
                    on_stream_text=lambda b, j, s: streams["jax"].append((b, s)))
    th = CodeFuseHandler(engine=teng, tokenizer=tok, trie=VocabTrie(tok.get_vocab()),
                         warmup=False,
                         on_stream_text=lambda b, j, s: streams["torch"].append((b, s)))
    return jh, th, streams


def test_handler_static_path_matches_jax():
    import json

    jh, th, streams = _handlers()
    req = {
        "prompts": [
            {"prompt": "def fib(n):", "top_k": 1, "random_seed": 3, "last_token": ""},
            {"prompt": "int main", "top_k": 1, "random_seed": 4, "last_token": "vo"},
        ],
        "out_seq_length": 10,
    }
    for stream in (False, True):
        r = dict(req, stream=stream)
        jcode, jmsg, jres = jh.predict(r, "j")
        tcode, tmsg, tres = th.predict(r, "t")
        assert jcode == 0 and tcode == 0, (jmsg, tmsg)
        jr, tr = json.loads(jres["res"]), json.loads(tres["res"])
        for key in ("generated_code", "length", "random_seed"):
            assert tr[key] == jr[key], key
        np.testing.assert_allclose(tr["cum_log_prob"], jr["cum_log_prob"], rtol=1e-4, atol=1e-4)
    assert streams["torch"] == streams["jax"]
    assert "".join(s for b, s in streams["torch"] if b == 0) == tr["generated_code"][0][0]


def test_handler_reports_unported_requests():
    import json

    jh, th, _ = _handlers()
    # a speculative request is served now, as the JAX handler serves it: a
    # sampled one (top_k 50) on the ordinary route, a greedy one by the
    # speculative loop, whose response adds its statistics
    for top_k, spec in ((50, False), (1, True)):
        req = {"prompts": [{"prompt": "def fib(n):", "top_k": top_k, "random_seed": 2}],
               "out_seq_length": 6, "speculative": True}
        (tcode, tmsg, tres), (jcode, jmsg, jres) = th.predict(req, "t"), jh.predict(req, "j")
        assert tcode == 0 and jcode == 0, (tmsg, jmsg)
        tr, jr = json.loads(tres["res"]), json.loads(jres["res"])
        assert ("speculative" in tr) == ("speculative" in jr) == spec
        if top_k == 1:
            assert tr["generated_code"] == jr["generated_code"]
            assert tr["speculative"] == jr["speculative"]
    # an unported request still reports its failure in the handler's contract
    code, msg, res = th.predict({"prompts": [{"prompt": 3}], "out_seq_length": 2}, "t")
    assert code == 1 and "TypeError" in msg and res == {"res": ""}
    # a handler with a beam pool builds and serves beams, as the JAX one does
    pool = dict(beam_width=2, max_slots=2, max_seq_len=64, prompt_bucket=8)
    req = {"prompts": [{"prompt": "def fib(n):", "len_penalty": 0.6}], "out_seq_length": 6,
           "beam_width": 2}
    tp = CodeFuseHandler(engine=th.engine, tokenizer=th.tokenizer, warmup=False, pool=pool)
    jp = JaxHandler(engine=jh.engine, tokenizer=jh.tokenizer, warmup=False, pool=pool)
    try:
        (tcode, tmsg, tres), (jcode, jmsg, jres) = tp.predict(req, "t"), jp.predict(req, "j")
        assert tcode == 0 and jcode == 0, (tmsg, jmsg)
        tr, jr = json.loads(tres["res"]), json.loads(jres["res"])
        assert tp.server.batcher.decode_ticks > 0
        assert tr["generated_code"] == jr["generated_code"] and tr["length"] == jr["length"]
        np.testing.assert_allclose(tr["cum_log_prob"], jr["cum_log_prob"], rtol=1e-4, atol=1e-4)
    finally:
        tp.close()
        jp.server.close()
