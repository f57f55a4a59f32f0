"""LLaMA in the port (``registry.get("llama")``, ckpt/convert_llama.py; RMSNorm,
SwiGLU, bias-free layers, concat QKV, GQA) on the cases of tests/test_llama.py:
logits and greedy tokens against HF, int8 with ``gate_w`` quantized, the ini
round trip and the registry; and against the JAX package on the same HF
weights: fp32 logits within atol=2e-4, rtol=1e-4, greedy tokens equal token
for token on the static engine and a paged pool (int8 and int4 g16 weights
too), ``from_jax_params`` carrying ``gate_w``, and prompt-lookup speculative
decoding equal to the JAX ``speculative_generate``."""
import numpy as np
import pytest
import torch
import transformers

from fastertransformer4codefuse_tpu import GptNeoXEngine as JaxEngine
from fastertransformer4codefuse_tpu import RuntimeConfig as JaxRuntime
from fastertransformer4codefuse_tpu.ckpt.quantize import quantize_params as jax_quantize
from fastertransformer4codefuse_tpu.engine.speculative import (
    speculative_generate as jax_speculative_generate,
)
from fastertransformer4codefuse_tpu_torch import GptNeoXEngine, RuntimeConfig, from_jax_params
from fastertransformer4codefuse_tpu_torch.ckpt.quantize import quantize_params
from fastertransformer4codefuse_tpu_torch.engine.speculative import speculative_generate
from fastertransformer4codefuse_tpu_torch.models.params import QuantizedTensor

import torch_family_util as fu

torch.set_num_threads(2)


def make_hf_llama(seed=0, kv_heads=4):
    torch.manual_seed(seed)
    cfg = transformers.LlamaConfig(
        vocab_size=96, hidden_size=64, intermediate_size=176, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=kv_heads, max_position_embeddings=128,
        rms_norm_eps=1e-6, bos_token_id=0, eos_token_id=95, attn_implementation="eager",
    )
    return transformers.LlamaForCausalLM(cfg).eval()


@pytest.fixture(scope="module")
def gqa():
    return fu.convert("llama", make_hf_llama(seed=3, kv_heads=2))


@pytest.mark.parametrize("kv_heads", [4, 2])  # MHA and grouped-query
def test_llama_logits_parity(kv_heads):
    f = fu.convert("llama", make_hf_llama(kv_heads=kv_heads))
    assert f.cfg.norm == "rmsnorm" and f.cfg.gated_ffn and not f.cfg.use_bias
    assert f.cfg.kv_heads == kv_heads and f.cfg.qkv_layout == "concat"
    cache = fu.check_logits(f, hf_atol=3e-4)
    assert cache["k"].shape[2] == kv_heads


@pytest.mark.parametrize("kv_heads", [4, 2])
def test_llama_greedy_parity(kv_heads):
    fu.check_greedy_vs_hf(fu.convert("llama", make_hf_llama(seed=1, kv_heads=kv_heads)))


def test_llama_matches_jax_static_and_paged(gqa):
    fu.check_tokens_vs_jax(gqa)


def test_llama_from_jax_params_carries_gate_w(gqa):
    assert "gate_w" in gqa.params["layers"]
    fu.check_from_jax_params(gqa)


@pytest.mark.parametrize("bits,G", [(8, 0), (4, 16)])
def test_llama_quantized_matches_jax(gqa, bits, G):
    """Weight-only quantization covers the gated-FFN slots (gate_w included):
    the port's quantizer gives the JAX quantizer's payloads, and the engines'
    greedy tokens agree (int8 through K1's plain version, int4 g16 K7's)."""
    qp = quantize_params(gqa.params, weight_bits=bits, group_size=G)
    jqp = jax_quantize(gqa.jparams, weight_bits=bits, group_size=G)
    gate = qp["layers"]["gate_w"]
    assert isinstance(gate, QuantizedTensor) and (gate.bits, gate.group_size) == (bits, G)
    np.testing.assert_array_equal(gate.q.numpy(), np.asarray(jqp["layers"]["gate_w"].q))
    rt = dict(dtype="fp32", int8_mode=1, seq_bucket=4)
    te = GptNeoXEngine(gqa.cfg, from_jax_params(jqp, device="cpu"), RuntimeConfig(**rt))
    je = JaxEngine(gqa.jcfg, jqp, JaxRuntime(**rt))
    out = fu.static_tokens(te)
    assert out == fu.static_tokens(je)
    assert len(out[1]) >= len(fu.PROMPTS[1]) + 4


def test_llama_speculative_matches_jax(gqa):
    """Prompt-lookup speculative decoding on a GQA LLaMA: the tokens of the
    JAX ``speculative_generate`` on the same weights."""
    te, je = fu.engines(gqa)
    prompt = [5, 6, 7, 8, 5, 6, 7, 8, 5, 6, 7]
    got, stats = speculative_generate(te, prompt, 12, k=4, ngram=2)
    want, jstats = jax_speculative_generate(je, prompt, 12, k=4, ngram=2)
    assert list(map(int, got)) == list(map(int, want))
    assert (stats.iterations, stats.accepted) == (jstats.iterations, jstats.accepted)


def test_llama_config_ini_roundtrip(tmp_path):
    fu.check_ini_roundtrip(fu.convert("llama", make_hf_llama(kv_heads=2)).cfg, tmp_path)


def test_llama_registry():
    assert fu.check_registry("llama", make_hf_llama()).norm == "rmsnorm"


@pytest.mark.parametrize("over", [dict(gated_ffn=True, activation="silu"),
                                  dict(moe_experts=4, gated_ffn=True, activation="silu")])
def test_gated_and_moe_parallel_layers_stay_off_k13(over):
    """K13's second segment is act(x @ up): a gated or MoE FFN never takes
    the K13 + K3 route, even under the parallel residual with the four big
    kernels quantized alike; such a model's int8 tokens are the JAX
    engine's."""
    import dataclasses

    from fastertransformer4codefuse_tpu import GptNeoXConfig as JaxConfig
    from fastertransformer4codefuse_tpu import init_params as jax_init_params
    from fastertransformer4codefuse_tpu_torch import GptNeoXConfig
    from fastertransformer4codefuse_tpu_torch.models import gptneox as tm
    from fastertransformer4codefuse_tpu_torch.models.params import layer_slice

    jcfg = JaxConfig.tiny(vocab_size=64, **over)
    jqp = jax_quantize(jax_init_params(jcfg, dtype="fp32"))
    cfg = GptNeoXConfig(**{f.name: getattr(jcfg, f.name)
                           for f in dataclasses.fields(GptNeoXConfig)})
    tp = from_jax_params(jqp, device="cpu")
    assert cfg.use_gptj_residual and not tm._fused_ok(cfg, layer_slice(tp["layers"], 0))
    rt = dict(dtype="fp32", int8_mode=1, seq_bucket=4)
    te = GptNeoXEngine(cfg, tp, RuntimeConfig(**rt))
    assert fu.static_tokens(te) == fu.static_tokens(JaxEngine(jcfg, jqp, JaxRuntime(**rt)))
