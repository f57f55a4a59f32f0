"""Qwen2 in the port (``registry.get("qwen2")``, ckpt/convert_qwen2.py: the
LLaMA recipe with q/k/v biases and ``rotary_base`` from ``rope_theta``) on
the cases of tests/test_qwen2.py: logits and greedy tokens against HF, int8
with the QKV bias in the epilogue, the ini round trip, the registry; and
against the JAX package on the same HF weights (fp32 logits within
atol=2e-4, rtol=1e-4; greedy tokens equal on the static engine and a paged
pool, bf16 and int8 KV; int8 weights; ``from_jax_params``)."""
import numpy as np
import pytest
import torch
import transformers

from fastertransformer4codefuse_tpu import GptNeoXEngine as JaxEngine
from fastertransformer4codefuse_tpu import RuntimeConfig as JaxRuntime
from fastertransformer4codefuse_tpu.ckpt.quantize import quantize_params as jax_quantize
from fastertransformer4codefuse_tpu_torch import GptNeoXEngine, RuntimeConfig, from_jax_params
from fastertransformer4codefuse_tpu_torch.ckpt.quantize import quantize_params
from fastertransformer4codefuse_tpu_torch.models.params import QuantizedTensor

import torch_family_util as fu

torch.set_num_threads(2)


def make_hf_qwen2(seed=0, kv_heads=2):
    torch.manual_seed(seed)
    cfg = transformers.Qwen2Config(
        vocab_size=96, hidden_size=64, intermediate_size=176, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=kv_heads, max_position_embeddings=128,
        rms_norm_eps=1e-6, rope_theta=1000000.0, bos_token_id=0, eos_token_id=95,
        tie_word_embeddings=False, attn_implementation="eager",
    )
    return transformers.Qwen2ForCausalLM(cfg).eval()


@pytest.fixture(scope="module")
def qwen():
    return fu.convert("qwen2", make_hf_qwen2(seed=3))


@pytest.mark.parametrize("kv_heads", [4, 2])  # MHA and grouped-query
def test_qwen2_logits_parity(kv_heads):
    f = fu.convert("qwen2", make_hf_qwen2(kv_heads=kv_heads))
    assert f.cfg.qkv_bias and not f.cfg.use_bias and f.cfg.rotary_base == 1e6
    assert "qkv_b" in f.params["layers"] and "up_b" not in f.params["layers"]
    fu.check_logits(f, hf_atol=3e-4)


def test_qwen2_greedy_parity():
    fu.check_greedy_vs_hf(fu.convert("qwen2", make_hf_qwen2(seed=1)))


@pytest.mark.parametrize("kv", [None, "int8"])
def test_qwen2_matches_jax_static_and_paged(qwen, kv):
    fu.check_tokens_vs_jax(qwen, kv_cache_dtype=kv)


def test_qwen2_from_jax_params(qwen):
    fu.check_from_jax_params(qwen)


def test_qwen2_int8_runs(qwen):
    """Weight-only int8 with the QKV bias applied in the kernel's epilogue
    (the biases stay float): the JAX int8 engine's tokens."""
    qp = quantize_params(qwen.params)
    assert isinstance(qp["layers"]["qkv_w"], QuantizedTensor)
    assert not isinstance(qp["layers"]["qkv_b"], QuantizedTensor)
    jqp = jax_quantize(qwen.jparams)
    rt = dict(dtype="fp32", int8_mode=1, seq_bucket=4)
    out = fu.static_tokens(GptNeoXEngine(qwen.cfg, from_jax_params(jqp, device="cpu"),
                                         RuntimeConfig(**rt)))
    assert out == fu.static_tokens(JaxEngine(qwen.jcfg, jqp, JaxRuntime(**rt)))
    assert len(out[1]) >= len(fu.PROMPTS[1]) + 4


def test_qwen2_config_ini_roundtrip(tmp_path):
    back = fu.check_ini_roundtrip(fu.convert("qwen2", make_hf_qwen2()).cfg, tmp_path)
    assert back.qkv_bias and not back.use_bias


def test_qwen2_registry():
    assert fu.check_registry("qwen2", make_hf_qwen2()).qkv_bias
