"""OPT in the port (``registry.get("opt")``, ckpt/convert_opt.py: ReLU,
learned positions with HF's two offset rows dropped, separate q/k/v fused,
pre-LN only, an untied head when present) on the cases of tests/test_opt.py:
logits and greedy tokens against HF, the registry and the ini round trip;
and against the JAX package on the same HF weights (fp32 logits within
atol=2e-4, rtol=1e-4; greedy tokens equal on the static engine and a paged
pool; ``from_jax_params``), and the configs both packages refuse."""
import pytest
import torch
import transformers

from fastertransformer4codefuse_tpu_torch.ckpt.convert_opt import config_from_hf_opt

import torch_family_util as fu

torch.set_num_threads(2)


def make_hf_opt(seed=0, **over):
    torch.manual_seed(seed)
    cfg = transformers.OPTConfig(**dict(dict(
        vocab_size=96, hidden_size=64, num_hidden_layers=2, ffn_dim=128, num_attention_heads=4,
        max_position_embeddings=64, do_layer_norm_before=True, word_embed_proj_dim=64,
        bos_token_id=0, eos_token_id=95, pad_token_id=1, attn_implementation="eager"), **over))
    return transformers.OPTForCausalLM(cfg).eval()


@pytest.fixture(scope="module")
def opt():
    return fu.convert("opt", make_hf_opt(seed=3))


def test_opt_logits_parity():
    f = fu.convert("opt", make_hf_opt())
    assert f.cfg.activation == "relu" and f.params["pos_embed"].shape[0] == 64
    fu.check_logits(f, hf_atol=3e-4)


def test_opt_greedy_parity():
    fu.check_greedy_vs_hf(fu.convert("opt", make_hf_opt(seed=1)), lo=2)


def test_opt_matches_jax_static_and_paged(opt):
    fu.check_tokens_vs_jax(opt)


def test_opt_from_jax_params(opt):
    fu.check_from_jax_params(opt)


@pytest.mark.parametrize("over", [dict(do_layer_norm_before=False),
                                  dict(word_embed_proj_dim=32)])
def test_opt_refuses_what_the_jax_converter_refuses(over):
    with pytest.raises(ValueError):
        config_from_hf_opt(make_hf_opt(**over).config)


def test_opt_registry_and_ini(tmp_path):
    cfg = fu.check_registry("opt", make_hf_opt())
    fu.check_ini_roundtrip(cfg, tmp_path)
