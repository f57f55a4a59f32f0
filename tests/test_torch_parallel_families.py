"""The families' tensor parallelism in the port: BERT (models/bert.py:
``shard_bert_params``), T5 (models/t5.py: ``shard_t5_params``, engine/
t5_engine.py) and Mixtral's expert parallelism (ops/moe.py), against the JAX
tests test_bert.py::test_bert_tp4_matches_unsharded, test_t5_engine.py's
tp4 and tp2 int8 cases and test_mixtral.py::
test_mixtral_expert_parallel_matches_single_device.

One group of four gloo ranks runs every case. BERT's hidden states equal the
JAX encoder's within the JAX test's tolerance; T5's greedy and beam ids equal
the JAX engine's under the same mesh shape; Mixtral's greedy row equals the
JAX engine's under tp = 2, its sampled row the port's own tp = 1 run. Every
rank returns the same output.
"""
import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp

from fastertransformer4codefuse_tpu import GptNeoXConfig as JaxConfig
from fastertransformer4codefuse_tpu import GptNeoXEngine as JaxEngine
from fastertransformer4codefuse_tpu import RuntimeConfig as JaxRuntime
from fastertransformer4codefuse_tpu import init_params as jax_init_params
from fastertransformer4codefuse_tpu.engine.t5_engine import T5Engine as JaxT5Engine
from fastertransformer4codefuse_tpu.models import bert as jbert
from fastertransformer4codefuse_tpu.models import t5 as jt5
from fastertransformer4codefuse_tpu.parallel.sharding import build_mesh
from fastertransformer4codefuse_tpu_torch.models import bert, t5
from test_api import CharTokenizer
from test_bert import make_hf_bert
from test_t5_engine import ids_for, make_hf_t5
from test_torch_parallel import port_cfg
from torch_tp_util import PROMPTS, np_tree, run_group

WORLD = 4
MIXTRAL = dict(head_num=8, size_per_head=8, vocab_size=128, inter_size=64, norm="rmsnorm",
               gated_ffn=True, use_bias=False, qkv_layout="concat", kv_head_num=4,
               use_gptj_residual=False, activation="silu", moe_experts=4, moe_top_k=2)
MIX_KW = dict(top_k=[1, 3], top_p=[0.0, 0.9], random_seed=[5, 6])


def _sd(hf):
    return {k: v.detach().numpy() for k, v in hf.state_dict().items()}


@pytest.fixture(scope="module")
def cli_ckpt(tmp_path_factory):
    """A 2-layer HF GPT-NeoX as a reference-format directory with int8
    payloads (tests/test_torch_cli.py's), and the requests file."""
    import json

    import torch
    import transformers

    from fastertransformer4codefuse_tpu_torch.ckpt.convert import convert_hf_to_bin
    from fastertransformer4codefuse_tpu_torch.ckpt.quantize import quant_and_save
    from test_torch_cli import REQUESTS

    d = tmp_path_factory.mktemp("tp_cli")
    torch.manual_seed(0)
    hf = transformers.GPTNeoXForCausalLM(transformers.GPTNeoXConfig(
        vocab_size=64, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=256, rotary_pct=0.25, max_position_embeddings=128,
        use_parallel_residual=True, bos_token_id=0, eos_token_id=1, hidden_act="gelu",
    )).eval()
    path = str(d / "1-gpu")
    convert_hf_to_bin(hf, path)
    quant_and_save(path)
    req = d / "req.jsonl"
    req.write_text("".join(json.dumps(r) + "\n" for r in REQUESTS))
    return path, str(req)


CLI_ARGS = ["--tokenizer_path", "tok", "--dtype", "fp32", "--int8_mode", "1", "--device", "cpu"]


@pytest.fixture(scope="module")
def group(cli_ckpt):
    hb = make_hf_bert(seed=4)
    bcfg = bert.config_from_hf_bert(hb.config)
    rng = np.random.RandomState(6)
    ids = rng.randint(0, bcfg.vocab_size, size=(2, 9)).astype(np.int32)
    lens = np.asarray([9, 6], np.int32)
    ht3, ht9 = make_hf_t5(3), make_hf_t5(9)
    t5ids3, t5ids13 = ids_for(t5.config_from_hf_t5(ht3.config), 2, 6, seed=5), \
        ids_for(t5.config_from_hf_t5(ht9.config), 2, 6, seed=13)
    mcfg = JaxConfig.tiny(**MIXTRAL)
    mp = jax_init_params(mcfg, dtype="fp32")
    data = {
        "bert": (bcfg, _sd(hb), ids, lens, False),
        "bert_int8": (bcfg, _sd(hb), ids, lens, True),
        "t5": (t5.config_from_hf_t5(ht3.config), _sd(ht3), t5ids3, False),
        "t5_int8": (t5.config_from_hf_t5(ht9.config), _sd(ht9), t5ids13, True),
        "mixtral": (port_cfg(mcfg), np_tree(mp)),
        "cli": (cli_ckpt[0], CharTokenizer(("vo", "void")).get_vocab()),
    }
    cases = [
        ("bert_tp4", "bert_case", dict(model="bert", tp=4)),
        ("bert_int8_tp2", "bert_case", dict(model="bert_int8", tp=2)),
        ("t5_tp4_greedy", "t5_case", dict(model="t5", tp=4)),
        ("t5_tp4_beam", "t5_case", dict(model="t5", tp=4, beam_width=2)),
        ("t5_int8_tp2", "t5_case", dict(model="t5_int8", tp=2, out_len=6)),
        ("mixtral_ep_tp2", "engine_case", dict(model="mixtral", tp=2, gen=MIX_KW)),
        ("cli_tp2", "cli_case", dict(model="cli", tp=2,
                                     argv=CLI_ARGS + ["--input_file", cli_ckpt[1]])),
    ]
    refs = {"hb": hb, "ht3": ht3, "ht9": ht9, "mixtral": (mcfg, mp), "bert_in": (ids, lens),
            "t5_in": (t5ids3, t5ids13)}
    return refs, run_group(WORLD, cases, data)


def _ok(res):
    for r in res:
        assert "error" not in r, r["error"]
    return res


@pytest.mark.parametrize("name,tp,int8", [("bert_tp4", 4, False), ("bert_int8_tp2", 2, True)])
def test_bert_under_tp_matches_the_jax_encoder(group, name, tp, int8):
    refs, results = group
    res = _ok(results[name])
    ids, lens = refs["bert_in"]
    jcfg = jbert.config_from_hf_bert(refs["hb"].config)
    jp = jbert.params_from_hf_bert_state_dict(jcfg, refs["hb"].state_dict())
    if int8:
        jp = jbert.quantize_bert_params(jp)
    ref_h, ref_p = jbert.encode(jcfg, jp, jnp.asarray(ids), jnp.asarray(lens))
    for r in res:
        np.testing.assert_array_equal(r["hidden"], res[0]["hidden"])
        # the fused QKV holds this rank's heads of q, k and v
        assert r["qkv_cols"] == 3 * jcfg.hidden_size // tp
        assert r["all_reduce"] == 2 * jcfg.layer_num  # after proj and after down
    np.testing.assert_allclose(res[0]["hidden"], np.asarray(ref_h), rtol=2e-5, atol=2e-6)
    if not int8:
        np.testing.assert_allclose(res[0]["pooled"], np.asarray(ref_p), rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("name,tp,beam,hf,out_len", [
    ("t5_tp4_greedy", 4, 1, "ht3", 8), ("t5_tp4_beam", 4, 2, "ht3", 8),
    ("t5_int8_tp2", 2, 1, "ht9", 6)])
def test_t5_under_tp_matches_the_jax_engine(group, name, tp, beam, hf, out_len):
    refs, results = group
    res = _ok(results[name])
    h = refs[hf]
    jcfg = jt5.config_from_hf_t5(h.config)
    jp = jt5.params_from_hf_t5_state_dict(jcfg, h.state_dict())
    if name.startswith("t5_int8"):
        jp = jt5.quantize_t5_params(jp)
    ids = refs["t5_in"][0 if hf == "ht3" else 1]
    want = JaxT5Engine(jcfg, jp, mesh=build_mesh(tp=tp)).generate(
        [list(r) for r in ids], out_len, beam_width=beam)
    for r in res:
        np.testing.assert_array_equal(r["ids"], res[0]["ids"])
        assert r["q_cols"] == jcfg.head_num * jcfg.size_per_head // tp
    np.testing.assert_array_equal(res[0]["ids"], np.asarray(want.output_ids))
    np.testing.assert_array_equal(res[0]["ids"], res[0]["ref"])
    # two all-reduces an encoder layer (attention, FFN), three a decoder step's layer
    L, Ld = jcfg.layer_num, jcfg.dec_layer_num
    assert res[0]["all_reduce"] == 2 * L + 3 * Ld * res[0]["forwards"]


def test_mixtral_expert_parallel_matches_single_device(group):
    """E/tp whole experts a rank; the greedy row equals the JAX engine's
    under tp = 2, the sampled row the port's tp = 1 run; the combine's
    partials ride the FFN's all-reduce (two a serial layer)."""
    refs, results = group
    res = _ok(results["mixtral_ep_tp2"])
    jcfg, jp = refs["mixtral"]
    want = JaxEngine(jcfg, jp, JaxRuntime(dtype="fp32", seq_bucket=4, tensor_para_size=2),
                     mesh=build_mesh(tp=2)).generate(PROMPTS, output_len=6, **MIX_KW)
    for r in res:
        np.testing.assert_array_equal(r["tp"]["ids"], res[0]["tp"]["ids"])
    np.testing.assert_array_equal(res[0]["tp"]["ids"][0], np.asarray(want.output_ids)[0])
    np.testing.assert_array_equal(res[0]["tp"]["ids"], res[0]["tp1"]["ids"])
    n = 1 + res[0]["forwards"]
    assert (res[0]["all_reduce"], res[0]["all_gather"]) == (2 * jcfg.layer_num * n, n)


def test_cli_under_tp_prints_what_the_tp1_cli_prints(group, cli_ckpt, capsys, monkeypatch):
    """``--tensor_parallel 2`` as torchrun runs it (every rank reads the
    requests, rank 0 alone prints): the responses of the port's tp = 1 CLI
    over the same checkpoint, but for the latency and the drawn seed."""
    from fastertransformer4codefuse_tpu_torch.api import cli, generate
    from test_torch_cli import _blocks

    _, results = group
    res = _ok(results["cli_tp2"])
    monkeypatch.setattr(generate, "load_tokenizer", lambda path: CharTokenizer(("vo", "void")))
    cli.main(["--ckpt_path", cli_ckpt[0], *CLI_ARGS, "--input_file", cli_ckpt[1]])
    want = _blocks(capsys.readouterr().out)
    assert _blocks(res[0]["stdout"]) == want and len(want) == 3
    # rank 0 of the process group alone prints (ranks 2 and 3 are a second
    # copy of the mesh, serving the same requests)
    assert res[1]["stdout"] == res[2]["stdout"] == res[3]["stdout"] == ""


def test_family_engines_refuse_meshes_that_do_not_split_their_heads():
    from fastertransformer4codefuse_tpu_torch.parallel.distributed import Mesh

    hb = make_hf_bert(seed=4)
    bcfg = bert.config_from_hf_bert(hb.config)
    bp = bert.params_from_hf_bert_state_dict(bcfg, hb.state_dict(), device="cpu")
    with pytest.raises(ValueError, match="do not split"):
        bert.shard_bert_params(bcfg, bp, Mesh(tp=3))
    ht = make_hf_t5(3)
    tcfg = t5.config_from_hf_t5(ht.config)
    tp_ = t5.params_from_hf_t5_state_dict(tcfg, ht.state_dict(), device="cpu")
    with pytest.raises(ValueError, match="do not split"):
        t5.shard_t5_params(tcfg, tp_, Mesh(tp=3))
    assert dataclasses.is_dataclass(Mesh())
