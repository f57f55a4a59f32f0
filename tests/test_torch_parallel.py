"""Tensor and data parallelism of the port (parallel/, models/gptneox.py,
engine/engine.py) against the JAX package: tests/test_parallel.py's TP cases
on gloo ranks, and every weight's slice against the JAX sharding.

One group of four gloo ranks (``torch_tp_util.run_group``) runs every engine
case of this module; a tp = 2 case runs on two copies of the mesh. Each case:
  - the greedy row's ids (and cum log-prob) equal the JAX engine's under the
    same mesh shape (the JAX test's tp = 8 vocab cases run at tp = 4 here:
    the group has four ranks);
  - the sampled row equals the port's own tp = 1 run (another generator than
    the JAX package's), its cum log-prob within the JAX test's 1e-4, and at
    the first step its kept set equals the JAX sampler's on the JAX logits;
  - every rank returns the same output.
The counted collectives of a decode step are L all-reduces under the
parallel residual, 2L in a serial layer, plus one all-gather of the logits.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fastertransformer4codefuse_tpu import GptNeoXConfig as JaxConfig
from fastertransformer4codefuse_tpu import GptNeoXEngine as JaxEngine
from fastertransformer4codefuse_tpu import RuntimeConfig as JaxRuntime
from fastertransformer4codefuse_tpu import init_params as jax_init_params
from fastertransformer4codefuse_tpu.ckpt.quantize import quantize_params
from fastertransformer4codefuse_tpu.models import gptneox as jmodel
from fastertransformer4codefuse_tpu.parallel import sharding as jsharding
from fastertransformer4codefuse_tpu_torch import GptNeoXEngine, RuntimeConfig
from fastertransformer4codefuse_tpu_torch.core.config import GptNeoXConfig
from fastertransformer4codefuse_tpu_torch.models.params import QuantizedTensor, from_jax_params
from fastertransformer4codefuse_tpu_torch.parallel import sharding
from fastertransformer4codefuse_tpu_torch.api import generate
from fastertransformer4codefuse_tpu_torch.parallel.distributed import Mesh, default_backend
from fastertransformer4codefuse_tpu_torch.sampling.sample import top_k_top_p_filter
from jax_sample_probe import jax_kept
from torch_tp_util import PROMPTS, np_tree, run_group

WORLD = 4
RUN_KW = dict(top_k=[1, 3], top_p=[0.0, 0.9], temperature=[1.0, 0.8], repetition_penalty=1.05,
              random_seed=[5, 6], return_cum_log_probs=True)


def port_cfg(jcfg):
    return GptNeoXConfig(**{f.name: getattr(jcfg, f.name)
                            for f in dataclasses.fields(GptNeoXConfig)})


def tiny(**kw):
    base = dict(head_num=8, size_per_head=8, vocab_size=128, inter_size=256)
    base.update(kw)
    return JaxConfig.tiny(**base)


LEARNED = dict(rotary_embedding_dim=0, position_embedding="learned", use_gptj_residual=False,
               qkv_layout="concat")
QWEN2 = dict(kv_head_num=4, qkv_layout="concat", use_bias=False, qkv_bias=True,
             norm="rmsnorm", gated_ffn=True, use_gptj_residual=False, activation="silu")


def models():
    """name -> (JAX config, JAX params, runtime knobs) of every engine case."""
    base = tiny()
    p = jax_init_params(base, dtype="fp32")
    v61 = tiny(vocab_size=61)
    return {
        "base": (base, p, {}),
        "int8": (base, quantize_params(p), dict(int8_mode=1)),
        "int4_g0": (base, quantize_params(p, weight_bits=4, group_size=0), dict(int8_mode=1)),
        "int4_g16": (base, quantize_params(p, weight_bits=4, group_size=16), dict(int8_mode=1)),
        "learned": (tiny(**LEARNED), jax_init_params(tiny(**LEARNED), dtype="fp32"), {}),
        "qwen2": (tiny(**QWEN2), jax_init_params(tiny(**QWEN2), dtype="fp32"), {}),
        "serial": (tiny(use_gptj_residual=False),
                   jax_init_params(tiny(use_gptj_residual=False), dtype="fp32"), {}),
        "v61": (v61, jax_init_params(v61, dtype="fp32"), {}),
        "v61_int8_head": (v61, jax_init_params(v61, dtype="fp32", int8_mode=1,
                                               quantize_embeddings=True), dict(int8_mode=1)),
        "v61_head_bias": (v61, _head_bias(jax_init_params(v61, dtype="fp32"), 61), {}),
    }


def _head_bias(p, vocab):
    """``p`` with a GPT-J style LM head bias."""
    return {**p, "lm_head_b": jnp.asarray(np.random.RandomState(3).randn(vocab)
                                          .astype(np.float32))}


# (case, model, tp, dp, generate kwargs, output length)
ENGINE_CASES = [
    ("tp2", "base", 2, 1, RUN_KW, 6),
    ("tp4", "base", 4, 1, RUN_KW, 6),
    ("tp4_int8", "int8", 4, 1, RUN_KW, 6),
    ("tp2_int4_g0", "int4_g0", 2, 1, RUN_KW, 6),
    ("tp2_int4_g16", "int4_g16", 2, 1, RUN_KW, 6),
    ("tp2_learned_positions", "learned", 2, 1, RUN_KW, 6),
    ("tp2_qwen2_style", "qwen2", 2, 1, RUN_KW, 6),
    ("dp2_tp2", "base", 2, 2, RUN_KW, 6),
    ("tp4_nondivisible_vocab", "v61", 4, 1, RUN_KW, 6),
    ("tp4_nondivisible_vocab_int8_rowwise_head", "v61_int8_head", 4, 1, dict(top_k=1), 5),
    ("tp4_nondivisible_vocab_head_bias", "v61_head_bias", 4, 1, RUN_KW, 6),
]
COUNT_CASES = [("counts_parallel_residual", "base", 4), ("counts_serial", "serial", 4)]


@pytest.fixture(scope="module")
def group():
    ms = models()
    data = {name: (port_cfg(c), np_tree(p)) for name, (c, p, _) in ms.items()}
    cases = [(name, "engine_case", dict(model=m, tp=tp, dp=dp, runtime=ms[m][2], gen=gen,
                                        out_len=n, first_logits=True))
             for name, m, tp, dp, gen, n in ENGINE_CASES]
    cases += [(name, "step_counts_case", dict(model=m, tp=tp)) for name, m, tp in COUNT_CASES]
    cases += [("pod_mesh", "pod_mesh_case", {})]
    return ms, run_group(WORLD, cases, data)


def _ok(res):
    for r in res:
        assert "error" not in r, r["error"]
    return res


def jax_run(jcfg, jparams, knobs, tp, dp, gen, out_len):
    mesh = jsharding.build_mesh(tp=tp, dp=dp)
    eng = JaxEngine(jcfg, jparams, JaxRuntime(dtype="fp32", seq_bucket=4, tensor_para_size=tp,
                                              **knobs), mesh=mesh)
    return eng.generate(PROMPTS, output_len=out_len, **gen)


@pytest.mark.parametrize("name,model,tp,dp,gen,out_len", ENGINE_CASES,
                         ids=[c[0] for c in ENGINE_CASES])
def test_engine_under_the_mesh(group, name, model, tp, dp, gen, out_len):
    ms, results = group
    res = _ok(results[name])
    jcfg, jparams, knobs = ms[model]
    for r in res[1:]:  # every rank returns the same output
        for key in ("ids", "lens", "cum"):
            np.testing.assert_array_equal(r["tp"][key], res[0]["tp"][key])
    got, own = res[0]["tp"], res[0]["tp1"]
    ref = jax_run(jcfg, jparams, knobs, tp, dp, gen, out_len)
    greedy = [b for b in range(len(PROMPTS))
              if np.atleast_1d(gen.get("top_k", 1))[b % np.size(gen.get("top_k", 1))] == 1]
    for b in greedy:  # greedy rows: the JAX engine's tokens under the same mesh
        np.testing.assert_array_equal(got["ids"][b], np.asarray(ref.output_ids)[b])
        if gen.get("return_cum_log_probs"):
            np.testing.assert_allclose(got["cum"][b], np.asarray(ref.cum_log_probs)[b],
                                       atol=1e-4)
    # every row: the port's own tp = 1 run
    np.testing.assert_array_equal(got["ids"], own["ids"])
    np.testing.assert_array_equal(got["lens"], own["lens"])
    np.testing.assert_allclose(got["cum"], own["cum"], atol=1e-4)
    # the head's vocab rows split over tp, a non-divisible vocab padded
    V = jcfg.vocab_size
    assert res[0]["head_rows"] == (-(-V // tp) * tp) // tp
    # the first step's logits and the sampled rows' kept sets against JAX
    width = -(-max(len(p) for p in PROMPTS) // 4) * 4
    ids = np.full((len(PROMPTS), width), jcfg.end_id, np.int32)
    for i, p in enumerate(PROMPTS):
        ids[i, : len(p)] = p
    lens = jnp.asarray([len(p) for p in PROMPTS], jnp.int32)
    cache = jmodel.init_kv_cache(jcfg, len(PROMPTS), width + out_len, jnp.float32)
    hidden, _ = jmodel.prefill(jcfg, jparams, jnp.asarray(ids), lens, cache)
    want = np.asarray(jmodel.lm_logits(jcfg, jparams, jmodel.last_token_hidden(hidden, lens)))
    logits = res[0]["logits"]
    np.testing.assert_allclose(logits, want, atol=1e-4, rtol=1e-4)
    if "top_p" in gen:
        k = np.asarray(gen["top_k"], np.int32)
        p = np.asarray(gen["top_p"], np.float32)
        t = np.asarray(gen["temperature"], np.float32)[:, None]
        kept = top_k_top_p_filter(torch.from_numpy(logits / t), torch.from_numpy(k),
                                  torch.from_numpy(p)) > -1e30
        np.testing.assert_array_equal(kept.numpy(), jax_kept(want / t, k, p))


@pytest.mark.parametrize("name,model,tp", COUNT_CASES, ids=[c[0] for c in COUNT_CASES])
def test_one_allreduce_per_layer_decode(group, name, model, tp):
    """The JAX test counts the psums of the compiled decode step (one a
    layer under the parallel residual); here the counted collectives of a
    prefill and of a decode step: L all-reduces under the parallel residual,
    2L in a serial layer (after proj and after down), one all-gather of the
    vocab-split logits."""
    ms, results = group
    res = _ok(results[name])
    L = ms[model][0].layer_num
    per_layer = 1 if ms[model][0].use_gptj_residual else 2
    for r in res:
        assert r["prefill"] == (per_layer * L, 1)
        assert r["decode"] == (per_layer * L, 1)
        np.testing.assert_array_equal(r["logits"], res[0]["logits"])


def test_dp_and_tp_counts_of_a_generate(group):
    """A generate call of output_len 6 stopping at no end id: one prefill
    and five decode forwards, each one all-reduce a layer and one gather."""
    ms, results = group
    for name in ("tp2", "tp4", "dp2_tp2"):
        res = _ok(results[name])
        L = ms["base"][0].layer_num
        for r in res:
            n = 1 + r["forwards"]
            assert (r["all_reduce"], r["all_gather"]) == (L * n, n), name


def test_build_pod_mesh_places_tp_innermost(group):
    """JAX build_pod_mesh: tp over the whole group by default; with tp
    given, dp is what is left, tp consecutive ranks."""
    _, results = group
    res = _ok(results["pod_mesh"])
    for r, got in enumerate(res):
        assert got["default"] == (WORLD, 1, r, 0)
        assert got["tp2"] == (2, WORLD // 2, r % 2, r // 2)


# ------------------------------------------------- the weights' slices ----

SHARD_MODELS = {
    "float": (tiny(), {}),
    "int8": (tiny(), dict(quant=dict())),
    "int4": (tiny(), dict(quant=dict(weight_bits=4, group_size=0))),
    "int4_g16": (tiny(), dict(quant=dict(weight_bits=4, group_size=16))),
    "qwen2_concat_qkv": (tiny(**QWEN2), {}),
    "mixtral_experts": (tiny(norm="rmsnorm", gated_ffn=True, use_bias=False,
                             qkv_layout="concat", kv_head_num=4, use_gptj_residual=False,
                             activation="silu", moe_experts=4, moe_top_k=2), {}),
    "gptj_head_bias_vocab61": (tiny(vocab_size=61, rotary_style="gptj"), dict(head_b=True)),
    "int8_rowwise_head_vocab61": (tiny(vocab_size=61), dict(init=dict(
        int8_mode=1, quantize_embeddings=True))),
    "int4_transposed_head": (tiny(), dict(init=dict(int8_mode=1, quantize_embeddings=True,
                                                    weight_bits=4))),
}


def _jax_params(jcfg, knobs):
    p = jax_init_params(jcfg, dtype="fp32", **knobs.get("init", {}))
    if "quant" in knobs:
        p = quantize_params(p, **knobs["quant"])
    return _head_bias(p, jcfg.vocab_size) if knobs.get("head_b") else p


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif hasattr(tree, "q") and hasattr(tree, "scale"):
        yield f"{path}.q", tree.q
        yield f"{path}.scale", tree.scale
    else:
        yield path, tree


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("model", list(SHARD_MODELS))
def test_shard_params_are_the_jax_addressable_shards(model, tp):
    """shard_params on the port's full params, rank by rank, against
    jax.device_put(x, NamedSharding(...)) of the JAX param_shardings on the
    forced CPU devices: every key, quantized scales, int4 nibbles along K,
    group-wise scales, the padded vocab and the replicated "concat" QKV."""
    jcfg, knobs = SHARD_MODELS[model]
    jp = _jax_params(jcfg, knobs)
    mesh = jsharding.build_mesh(tp=tp)
    placed = jsharding.shard_params(jcfg, jp, mesh)
    devices = list(mesh.devices.reshape(-1))
    full = from_jax_params(np_tree(jp), device="cpu")
    cfg = port_cfg(jcfg)
    for r in range(tp):
        mine = dict(_leaves(sharding.shard_params(cfg, full, Mesh(tp=tp, tp_rank=r))))
        theirs = dict(_leaves(placed))
        assert mine.keys() == theirs.keys()
        for key, arr in theirs.items():
            shard = next(s for s in arr.addressable_shards if s.device == devices[r])
            want = np.asarray(shard.data)
            got = mine[key]
            got = (got.view(torch.int16).numpy().view(want.dtype)
                   if got.dtype == torch.bfloat16 else got.numpy())
            np.testing.assert_array_equal(got, want, err_msg=f"{model} tp {tp} rank {r} {key}")


def test_mesh_and_shard_refusals():
    """What the kernels cannot take is refused at sharding time, and a mesh
    of several ranks (a pp mesh too) needs a process group; an engine whose
    ``pipeline_para_size`` asks for stages its mesh does not have is
    refused."""
    cfg = port_cfg(tiny())
    full = from_jax_params(np_tree(jax_init_params(tiny(), dtype="fp32")), device="cpu")
    with pytest.raises(ValueError, match="heads do not split"):
        sharding.shard_params(cfg, full, Mesh(tp=3))
    g16 = from_jax_params(np_tree(quantize_params(jax_init_params(tiny(), dtype="fp32"),
                                                  weight_bits=4, group_size=16)), device="cpu")
    with pytest.raises(ValueError, match="group size"):  # proj rows 64 / 8 = 8 < G
        sharding.shard_params(cfg, g16, Mesh(tp=8))
    with pytest.raises(ValueError, match="process group"):
        sharding.build_mesh(tp=2)
    with pytest.raises(ValueError, match="process group"):
        sharding.build_mesh(pp=2)
    with pytest.raises(ValueError, match="pipeline_para_size 2 needs a mesh"):
        GptNeoXEngine(cfg, full, RuntimeConfig(dtype="fp32", pipeline_para_size=2))
    assert sharding.cache_heads(port_cfg(tiny(**QWEN2)), Mesh(tp=2, tp_rank=1)) == (2, 2)
    mqa = port_cfg(tiny(kv_head_num=1, qkv_layout="concat"))
    assert sharding.cache_heads(mqa, Mesh(tp=2, tp_rank=1)) == (0, 1)  # replicated
    assert isinstance(full["lm_head"], torch.Tensor) and not isinstance(
        full["lm_head"], QuantizedTensor)


@pytest.mark.parametrize("device,cards,world,want", [
    ("cpu", 4, 2, "gloo"), ("cuda", 4, 2, "nccl"), (None, 4, 2, "nccl"),
    ("cuda", 1, 2, "gloo"), ("cuda", 0, 1, "gloo")])
def test_default_backend_follows_the_serving_device(monkeypatch, device, cards, world, want):
    """NCCL only for ranks serving on a CUDA device with a card each (None
    is the card); a CPU engine takes gloo whatever cards the host has."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert default_backend(device, world) == want


def test_tensor_parallel_cpu_engine_joins_a_gloo_group(monkeypatch):
    """``init_engine_and_tokenizer(tensor_parallel=2, device="cpu")`` on a
    host with four cards joins torchrun's group on gloo: a CPU tensor's
    all-reduce would fail under NCCL. The one-rank group then cannot hold a
    tp = 2 mesh."""
    import socket

    import torch.distributed as dist

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    for k, v in dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE="1",
                     RANK="0").items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert not dist.is_initialized()
    try:
        with pytest.raises(ValueError, match="does not divide the 1 ranks"):
            generate.init_engine_and_tokenizer("ckpt", "tok", tensor_parallel=2, device="cpu")
        assert dist.get_backend() == "gloo"
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
