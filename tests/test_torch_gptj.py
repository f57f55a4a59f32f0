"""GPT-J in the port (``registry.get("gptj")``, ckpt/convert_gptj.py: the
parallel residual with one shared LayerNorm, interleaved rotary pairs over
``rotary_dim``, bias-free q/k/v, ``down_b`` = fc_out's bias, an LM-head bias)
on the cases of tests/test_gptj.py: logits and greedy tokens against HF and
the registry; and against the JAX package on the same HF weights (fp32
logits within atol=2e-4, rtol=1e-4; greedy tokens equal on the static engine
and a paged pool; int8 weights on the K13 + K3 route and unfused;
``from_jax_params``: the JAX tree's zero ``qkv_b`` aside, the same
tensors)."""
import pytest
import torch
import transformers

from fastertransformer4codefuse_tpu import GptNeoXEngine as JaxEngine
from fastertransformer4codefuse_tpu import RuntimeConfig as JaxRuntime
from fastertransformer4codefuse_tpu.ckpt.quantize import quantize_params as jax_quantize
from fastertransformer4codefuse_tpu_torch import GptNeoXEngine, RuntimeConfig, from_jax_params
from fastertransformer4codefuse_tpu_torch.models import gptneox as tm
from fastertransformer4codefuse_tpu_torch.models.params import layer_slice

import torch_family_util as fu

torch.set_num_threads(2)


def make_hf_gptj(seed=0):
    torch.manual_seed(seed)
    cfg = transformers.GPTJConfig(
        vocab_size=96, n_positions=128, n_embd=64, n_layer=2, n_head=4, rotary_dim=8,
        activation_function="gelu_new", bos_token_id=0, eos_token_id=95,
    )
    return transformers.GPTJForCausalLM(cfg).eval()


@pytest.fixture(scope="module")
def gptj():
    return fu.convert("gptj", make_hf_gptj(seed=3))


def test_gptj_logits_parity():
    f = fu.convert("gptj", make_hf_gptj())
    assert f.cfg.rotary_style == "gptj" and f.cfg.use_gptj_residual
    assert "lm_head_b" in f.params and "qkv_b" not in f.params["layers"]
    fu.check_logits(f, hf_atol=3e-4)


def test_gptj_greedy_parity():
    fu.check_greedy_vs_hf(fu.convert("gptj", make_hf_gptj(seed=1)))


def test_gptj_matches_jax_static_and_paged(gptj):
    fu.check_tokens_vs_jax(gptj)


def test_gptj_from_jax_params(gptj):
    fu.check_from_jax_params(gptj, skip=("qkv_b",))


@pytest.mark.parametrize("fused", [True, False])
def test_gptj_int8_routes_match_jax(gptj, fused):
    """int8 GPT-J: the layer takes the K13 + K3 route (no QKV bias: K13's
    first segment without one) or, with ``fused_decode=False``, the unfused
    GEMMs; either way the JAX int8 engine's tokens."""
    jqp = jax_quantize(gptj.jparams)
    tp = from_jax_params(jqp, device="cpu")
    del tp["layers"]["qkv_b"]  # the port's converter stores none
    assert tm._fused_ok(gptj.cfg, layer_slice(tp["layers"], 0))
    rt = dict(dtype="fp32", int8_mode=1, seq_bucket=4)
    te = GptNeoXEngine(gptj.cfg, tp, RuntimeConfig(fused_decode=fused, **rt))
    assert fu.static_tokens(te) == fu.static_tokens(JaxEngine(gptj.jcfg, jqp, JaxRuntime(**rt)))


def test_gptj_registry():
    assert fu.check_registry("gptj", make_hf_gptj()).rotary_style == "gptj"
