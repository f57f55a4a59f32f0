"""StarCoder (GPTBigCode) in the port (``registry.get("starcoder")``,
ckpt/convert_starcoder.py: multi-query attention, learned positions,
nn.Linear kernels transposed, tanh-gelu) on the cases of
tests/test_starcoder.py: logits and greedy tokens against HF, the int8-KV
paged pool against the static engine, the ini round trip, the registry; and
against the JAX package on the same HF weights (fp32 logits within
atol=2e-4, rtol=1e-4; greedy tokens equal on the static engine and a paged
pool, bf16 and int8 KV; ``from_jax_params`` carrying ``pos_embed``)."""
import pytest
import torch
import transformers

from fastertransformer4codefuse_tpu_torch.engine.batcher import ContinuousBatcher

import torch_family_util as fu

torch.set_num_threads(2)


def make_hf_starcoder(seed=0, multi_query=True):
    torch.manual_seed(seed)
    cfg = transformers.GPTBigCodeConfig(
        vocab_size=96, n_positions=64, n_embd=64, n_layer=2, n_head=4,
        multi_query=multi_query, bos_token_id=0, eos_token_id=95, attn_implementation="eager",
    )
    return transformers.GPTBigCodeForCausalLM(cfg).eval()


@pytest.fixture(scope="module")
def star():
    return fu.convert("starcoder", make_hf_starcoder(seed=3))


def test_starcoder_logits_parity():
    f = fu.convert("starcoder", make_hf_starcoder())
    assert f.cfg.kv_heads == 1 and f.cfg.position_embedding == "learned"
    assert f.params["layers"]["qkv_w"].shape[-1] == (4 + 2) * 16  # q | k | v, MQA
    cache = fu.check_logits(f, hf_atol=5e-4)
    assert cache["k"].shape[2] == 1  # one shared KV head


def test_starcoder_greedy_parity():
    fu.check_greedy_vs_hf(fu.convert("starcoder", make_hf_starcoder(seed=1)))


def test_starcoder_int8_kv_paged_pool(star):
    """MQA and learned positions through the paged pool on an int8 KV cache:
    each request's tokens are its static greedy run's."""
    te, _ = fu.engines(star, kv_cache_dtype="int8")
    refs = [fu.static_tokens(te, [p], 4)[0] for p in ([3, 4, 5, 6, 7], [20, 21, 22])]
    cb = ContinuousBatcher(te, max_slots=2, max_seq_len=32, prompt_bucket=4,
                           paged=dict(num_pages=10, page_size=8))
    assert fu.pool_tokens(cb, [[3, 4, 5, 6, 7], [20, 21, 22]], 4) == refs


@pytest.mark.parametrize("kv", [None, "int8"])
def test_starcoder_matches_jax_static_and_paged(star, kv):
    fu.check_tokens_vs_jax(star, kv_cache_dtype=kv)


def test_starcoder_from_jax_params(star):
    assert star.params["pos_embed"].shape == (64, 64)
    fu.check_from_jax_params(star)


def test_starcoder_config_ini_roundtrip(tmp_path):
    back = fu.check_ini_roundtrip(fu.convert("starcoder", make_hf_starcoder()).cfg, tmp_path)
    assert back.kv_head_num == 1


def test_starcoder_registry():
    assert fu.check_registry("starcoder", make_hf_starcoder()).kv_heads == 1
