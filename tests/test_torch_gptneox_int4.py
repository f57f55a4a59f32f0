"""The int4-weight slice end to end against the JAX package, on
``GptNeoXConfig.tiny()``: JAX ``init_params(int8_mode=1, weight_bits=4,
group_size=G, quantize_embeddings=True)`` (int4 layers, int8 embeddings, the
transposed int4 LM head) carried over with ``from_jax_params``, an int8 KV
cache, fp32. G = 0 is per-channel W4A16, G = 16 group-wise.

Tolerances: logits within 1e-4 of max |logits| (fp32, summation order only);
greedy tokens and handler texts identical. The routing is asserted on the
plain path: int4 decode, per-channel or group-wise, runs K13 (qkv + up) and
K3 (proj + down) a layer; prefill runs K13 and the proj and down K6 (K7)
GEMMs a layer; both heads run K8."""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fastertransformer4codefuse_tpu.api.handler import CodeFuseHandler as JaxHandler
from fastertransformer4codefuse_tpu.api.trie import VocabTrie as JaxTrie
from fastertransformer4codefuse_tpu.models import gptneox as jm
from fastertransformer4codefuse_tpu_torch.api.handler import CodeFuseHandler
from fastertransformer4codefuse_tpu_torch.api.trie import VocabTrie
from fastertransformer4codefuse_tpu_torch.engine import kv_cache as kvc
from fastertransformer4codefuse_tpu_torch.models import gptneox as tm
from fastertransformer4codefuse_tpu_torch.ops import quant_matmul_w4
from test_api import CharTokenizer
from test_torch_gptneox import _engines, _models, _rel

torch.set_num_threads(2)

GROUPS = [0, 16]


@pytest.fixture
def routes(monkeypatch):
    """Counts of each kernel wrapper's calls on the plain path."""
    counts = {}

    def counted(mod, name):
        fn = getattr(mod, name)

        def wrapper(*a, **kw):
            counts[name] = counts.get(name, 0) + 1
            return fn(*a, **kw)

        monkeypatch.setattr(mod, name, wrapper)

    for name in ("quant_matmul_w4", "quant_matmul_w4_group", "quant_matmul_w4_head"):
        counted(quant_matmul_w4, name)
    for name in ("fused_qkv_up", "fused_proj_down"):
        counted(tm, name)
    return counts


@pytest.mark.parametrize("G", GROUPS)
def test_int4_prefill_and_decode_logits_match_jax(G, routes):
    jcfg, jp, cfg, tp = _models(True, "gelu-tanh", weight_bits=4, group_size=G)
    assert tp["layers"]["up_w"].bits == 4 and tp["layers"]["up_w"].group_size == G
    B, S, Smax, steps = 2, 8, 16, 4
    rng = np.random.default_rng(4 + G)
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
    L = cfg.layer_num
    # K13 runs QKV and up; proj and down are K6 (K7) GEMMs
    prefill_calls = {"fused_qkv_up": L, "quant_matmul_w4_group" if G else "quant_matmul_w4": 2 * L,
                     "quant_matmul_w4_head": 1}
    assert routes == prefill_calls
    routes.clear()
    for t in range(steps):
        pos = lens + t
        jl, jc = jdecode(jp, jnp.asarray(feed[t]), jnp.asarray(pos), jc)
        h, tc = tm.decode_step(cfg, tp, torch.from_numpy(feed[t]), torch.from_numpy(pos), tc)
        assert _rel(tm.lm_logits(cfg, tp, h), jl) < 1e-4, t
    # K13 runs qkv and up, K3 proj and down, per-channel and group-wise alike
    assert routes == {"fused_qkv_up": L * steps, "fused_proj_down": L * steps,
                      "quant_matmul_w4_head": steps}


def test_int4_k3_route_with_exact_gelu(routes):
    """Exact-erf gelu takes the fused route too: K13 (its up epilogue has
    erf), then K3."""
    jcfg, jp, cfg, tp = _models(True, "gelu", weight_bits=4)
    B, S = 2, 6
    ids = np.random.default_rng(9).integers(2, jcfg.vocab_size, (B, S)).astype(np.int32)
    lens = np.array([S, 4], np.int32)
    jc = jm.init_kv_cache(jcfg, B, S + 1, jnp.int8)
    _, jc = jm.prefill(jcfg, jp, jnp.asarray(ids), jnp.asarray(lens), jc)
    jh, _ = jm.decode_step(jcfg, jp, jnp.asarray(ids[:, 0]), jnp.asarray(lens), jc)
    tc = kvc.init_cache(cfg, B, S + 1, torch.int8, "cpu")
    _, tc = tm.prefill(cfg, tp, torch.from_numpy(ids), torch.from_numpy(lens), tc)
    routes.clear()
    th, _ = tm.decode_step(cfg, tp, torch.from_numpy(ids[:, 0]), torch.from_numpy(lens), tc)
    assert _rel(tm.lm_logits(cfg, tp, th), jm.lm_logits(jcfg, jp, jh)) < 1e-4
    L = cfg.layer_num
    assert routes == {"fused_qkv_up": L, "fused_proj_down": L, "quant_matmul_w4_head": 1}


@pytest.mark.parametrize("G", GROUPS)
def test_int4_greedy_generate_matches_jax(G):
    jeng, teng = _engines(True, "gelu-tanh", end_id=127, weight_bits=4, group_size=G)
    prompts = [[5, 9, 3, 17, 2], [11, 4, 90]]
    kw = dict(output_len=6, top_k=1, return_cum_log_probs=True)
    jo = jeng.generate(prompts, **kw)
    to = teng.generate(prompts, **kw)
    np.testing.assert_array_equal(to.output_ids, jo.output_ids)
    np.testing.assert_array_equal(to.sequence_lengths, jo.sequence_lengths)
    np.testing.assert_allclose(to.cum_log_probs, jo.cum_log_probs, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("G", GROUPS)
def test_int4_handler_request_matches_jax(G):
    tok = CharTokenizer(("vo", "void"))
    jeng, teng = _engines(True, "gelu-tanh", vocab=64, weight_bits=4, group_size=G)
    jh = JaxHandler(engine=jeng, tokenizer=tok, trie=JaxTrie(tok.get_vocab()), warmup=False)
    th = CodeFuseHandler(engine=teng, tokenizer=tok, trie=VocabTrie(tok.get_vocab()),
                         warmup=False)
    req = {"prompts": [{"prompt": "def fib(n):", "top_k": 1, "random_seed": 3},
                       {"prompt": "int main", "top_k": 1, "random_seed": 4}],
           "out_seq_length": 8}
    (jcode, jmsg, jres), (tcode, tmsg, tres) = jh.predict(req, "j"), th.predict(req, "t")
    assert jcode == 0 and tcode == 0, (jmsg, tmsg)
    jr, tr = json.loads(jres["res"]), json.loads(tres["res"])
    for key in ("generated_code", "length", "random_seed"):
        assert tr[key] == jr[key], key
    np.testing.assert_allclose(tr["cum_log_prob"], jr["cum_log_prob"], rtol=1e-4, atol=1e-4)
