"""The checkpoint-to-CLI entry point against the JAX package's, on the CPU:
``api.generate.init_engine_and_tokenizer``, ``CodeFuseHandler(ckpt_path=...)``
and ``api.cli.main`` (the JSONL loop and ``--serve`` from stdin) over one
reference-format directory and one tokenizer (tests/test_api.py's
``CharTokenizer``, patched in as ``AutoTokenizer`` is there), fp32; and the
fused decode route (K13 + K3) of int8 and int4 g128 engines against the JAX
engine, token for token, with ``fused_decode`` True and False.

Tolerance: none; printed responses equal line for line but for the latency
and the drawn default seed, greedy tokens identical."""
import dataclasses
import io
import json
import sys

import numpy as np
import pytest
import torch
import transformers

import jax

from fastertransformer4codefuse_tpu import GptNeoXConfig as JaxConfig
from fastertransformer4codefuse_tpu import GptNeoXEngine as JaxEngine
from fastertransformer4codefuse_tpu import RuntimeConfig as JaxRuntime
from fastertransformer4codefuse_tpu import init_params as jax_init_params
from fastertransformer4codefuse_tpu.api import cli as jcli
from fastertransformer4codefuse_tpu.api.handler import CodeFuseHandler as JaxHandler
from fastertransformer4codefuse_tpu_torch import GptNeoXConfig, GptNeoXEngine, RuntimeConfig
from fastertransformer4codefuse_tpu_torch import from_jax_params
from fastertransformer4codefuse_tpu_torch.api import cli, generate
from fastertransformer4codefuse_tpu_torch.api.handler import CodeFuseHandler
from fastertransformer4codefuse_tpu_torch.ckpt.convert import convert_hf_to_bin
from fastertransformer4codefuse_tpu_torch.ckpt.quantize import quant_and_save
from fastertransformer4codefuse_tpu_torch.models import gptneox as tm
from fastertransformer4codefuse_tpu_torch.models.params import QuantizedTensor
from test_api import CharTokenizer

torch.set_num_threads(2)

G = 16


@pytest.fixture
def ckpt(tmp_path):
    """A 2-layer HF GPT-NeoX (exact gelu) as a reference-format directory with
    int8 and int4 g16 payloads beside the float kernels."""
    torch.manual_seed(0)
    hf = transformers.GPTNeoXForCausalLM(transformers.GPTNeoXConfig(
        vocab_size=64, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=256, rotary_pct=0.25, max_position_embeddings=128,
        use_parallel_residual=True, bos_token_id=0, eos_token_id=1, hidden_act="gelu",
    )).eval()
    path = str(tmp_path / "1-gpu")
    convert_hf_to_bin(hf, path)
    quant_and_save(path)
    quant_and_save(path, weight_bits=4, group_size=G)
    return path


@pytest.fixture
def tokenizers(monkeypatch):
    tok = CharTokenizer(("vo", "void"))
    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained",
                        staticmethod(lambda path, **kw: tok))
    monkeypatch.setattr(generate, "load_tokenizer", lambda path: tok)
    return tok


REQUESTS = [
    {"prompts": [{"prompt": "def main", "top_k": 1}], "out_seq_length": 8},
    {"prompts": [{"prompt": "import os\n", "top_k": 1, "stop_words": ["\n\n"], "last_token": ""},
                 {"prompt": "vo", "top_k": 1, "stop_words": ["#"], "last_token": "vo"}],
     "out_seq_length": 6},
    {"prompts": [{"prompt": "class a", "top_k": 1, "repetition_penalty": 1.3}],
     "out_seq_length": 10},
]

QUANT = [
    ["--int8_mode", "1"],
    ["--int8_mode", "2", "--weight_bits", "4", "--group_size", str(G), "--kv_cache_dtype",
     "int8"],
]


def _blocks(out):
    """Printed responses keyed by request index, without the latency and the
    drawn default seed (each handler draws its own)."""
    blocks = {}
    for block in out.split("#" * 50 + "\n")[1:]:
        lines = [ln for ln in block.splitlines()
                 if not ln.startswith(("- latency", "- random_seed"))]
        blocks[int(lines[0].split()[-1])] = lines
    return blocks


@pytest.mark.parametrize("quant", QUANT, ids=["int8", "int4-g16-int8kv"])
def test_cli_prints_what_the_jax_cli_prints(ckpt, tokenizers, tmp_path, capsys, quant):
    req = tmp_path / "req.jsonl"
    req.write_text("".join(json.dumps(r) + "\n" for r in REQUESTS))
    args = ["--ckpt_path", ckpt, "--tokenizer_path", "tok", "--dtype", "fp32",
            "--input_file", str(req), *quant]
    jcli.main(args)
    ref = capsys.readouterr().out
    cli.main(args + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert _blocks(got) == _blocks(ref) and len(_blocks(got)) == len(REQUESTS)


def test_cli_serve_from_stdin_answers_as_the_jax_cli(ckpt, tokenizers, capsys, monkeypatch):
    args = ["--ckpt_path", ckpt, "--tokenizer_path", "tok", "--dtype", "fp32", "--serve",
            "--pool_slots", "2", "--pool_seq_len", "64", "--prompt_bucket", "8",
            "--paged_pages", "17", "--page_size", "8", *QUANT[1]]
    lines = "".join(json.dumps(r) + "\n" for r in REQUESTS)
    monkeypatch.setattr(sys, "stdin", io.StringIO(lines))
    jcli.main(args)
    ref = capsys.readouterr().out
    monkeypatch.setattr(sys, "stdin", io.StringIO(lines))
    cli.main(args + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert _blocks(got) == _blocks(ref) and len(_blocks(got)) == len(REQUESTS)


def test_cli_refuses_what_is_not_ported(ckpt, tokenizers):
    base = ["--ckpt_path", ckpt, "--tokenizer_path", "tok", "--device", "cpu"]
    # a speculative pool is dense: with pages it is refused, as the JAX CLI refuses it
    with pytest.raises(ValueError, match="dense"):
        cli.main(base + ["--serve", "--speculative_pool", "--paged_pages", "17"])
    # tensor parallelism runs under torchrun: without a process group it is
    # refused, the --serve loop as the JSONL loop
    with pytest.raises(ValueError, match="torchrun"):
        cli.main(base + ["--input_file", "x", "--tensor_parallel", "2"])
    with pytest.raises(ValueError, match="torchrun"):
        generate.init_engine_and_tokenizer(ckpt, "tok", tensor_parallel=2, device="cpu")
    with pytest.raises(ValueError, match="torchrun"):
        cli.main(base + ["--serve", "--tensor_parallel", "2"])
    with pytest.raises(SystemExit):
        cli.main(base)  # neither --input_file nor --serve


def test_handler_serves_int4_checkpoint(ckpt, tokenizers):
    """JAX test_api.py::test_handler_serves_int4_checkpoint on the port: the
    handler loads the .q4.bin directory with the W4 knobs (int8_mode=2: int8
    embeddings, the int4 head) and answers as the JAX handler does."""
    kw = dict(ckpt_path=ckpt, tokenizer_path="tok", int8_mode=2, dtype="fp32", weight_bits=4,
              group_size=G, kv_cache_dtype="int8", warmup=False)
    handler = CodeFuseHandler(device="cpu", **kw)
    jh = JaxHandler(**kw)
    up = handler.engine.params["layers"]["up_w"]
    assert isinstance(up, QuantizedTensor) and (up.bits, up.group_size) == (4, G)
    assert isinstance(handler.engine.params["embed"], QuantizedTensor)
    assert handler.engine.params["lm_head"].bits == 4
    assert handler.engine.runtime.kv_cache_dtype == "int8"
    assert handler.engine.device.type == "cpu"
    for i, r in enumerate(REQUESTS):
        code, err, res = handler.predict(r, f"t{i}")
        jcode, _, jres = jh.predict(r, f"t{i}")
        assert code == jcode == 0, err
        a, b = json.loads(res["res"]), json.loads(jres["res"])
        assert a["generated_code"] == b["generated_code"] and a["length"] == b["length"]


def test_init_engine_and_tokenizer_builds_on_the_card_by_default(ckpt, tokenizers):
    if torch.cuda.is_available():
        pytest.skip("this case is about a host without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate.init_engine_and_tokenizer(ckpt, "tok", int8_mode=1)
    eng, tok, trie = generate.init_engine_and_tokenizer(ckpt, "tok", int8_mode=1, end_id=5,
                                                        trie_needed=True, device="cpu")
    assert eng.config.end_id == 5 and tok is tokenizers
    assert trie.printAutoSuggestions("vo", []) == 1


# ------------------------------------------------- the fused decode route --


def _route_engines(bits, group, fused):
    """JAX-made weights (H = 128) in both packages; the port's engine with
    ``fused_decode=fused``."""
    jcfg = JaxConfig.tiny(vocab_size=96, size_per_head=32, end_id=95, activation="gelu")
    jp = jax_init_params(jcfg, jax.random.PRNGKey(3), dtype="fp32", int8_mode=1,
                         quantize_embeddings=True, weight_bits=bits, group_size=group)
    rng = np.random.default_rng(4)
    layers = {k: (jax.numpy.asarray(rng.standard_normal(v.shape) * 0.1, jax.numpy.float32)
                  if k.endswith("_b") else v) for k, v in jp["layers"].items()}
    jp = dict(jp, layers=layers)
    cfg = GptNeoXConfig(**dataclasses.asdict(jcfg))
    kw = dict(dtype="fp32", int8_mode=1, kv_cache_dtype="int8", seq_bucket=8)
    return (JaxEngine(jcfg, jp, JaxRuntime(**kw)),
            GptNeoXEngine(cfg, from_jax_params(jp, device="cpu"),
                          RuntimeConfig(fused_decode=fused, **kw)))


@pytest.mark.parametrize("bits,group", [(8, 0), (4, 128)], ids=["int8", "int4-g128"])
@pytest.mark.parametrize("fused", [True, False])
def test_fused_route_greedy_tokens_match_the_jax_engine(bits, group, fused, monkeypatch):
    jeng, teng = _route_engines(bits, group, fused)
    calls = {}
    for name in ("fused_qkv_up", "fused_proj_down"):
        fn = getattr(tm, name)
        monkeypatch.setattr(tm, name, lambda *a, _fn=fn, _n=name, **k: (
            calls.__setitem__(_n, calls.get(_n, 0) + 1), _fn(*a, **k))[1])
    prompts = [[5, 9, 3, 17, 2], [11, 4, 90]]
    kw = dict(output_len=8, top_k=1, return_cum_log_probs=True)
    jo, to = jeng.generate(prompts, **kw), teng.generate(prompts, **kw)
    np.testing.assert_array_equal(to.output_ids, jo.output_ids)
    np.testing.assert_allclose(to.cum_log_probs, jo.cum_log_probs, rtol=1e-4, atol=1e-4)
    L, n = teng.config.layer_num, teng.config.layer_num * teng.decode_forwards
    # one prefill (K13 for QKV and up) and the decode forwards (K13 + K3)
    assert n > 0 and calls == ({"fused_qkv_up": L + n, "fused_proj_down": n} if fused else {})


def test_fused_route_needs_four_kernels_quantized_alike():
    """The routing predicate: parallel residual, the summed bias, and qkv,
    up, proj and down quantized with one bit width and one group size
    (G > 0 and exact gelu admitted)."""
    cfg = GptNeoXConfig.tiny(activation="gelu")
    from fastertransformer4codefuse_tpu_torch import init_params
    from fastertransformer4codefuse_tpu_torch.models.params import layer_slice

    for bits, group in ((8, 0), (4, 0), (4, 16)):
        p = init_params(cfg, int8_mode=1, weight_bits=bits, group_size=group, device="cpu")
        assert tm._fused_ok(cfg, layer_slice(p["layers"], 0))
    lp = layer_slice(init_params(cfg, int8_mode=1, device="cpu")["layers"], 0)
    g16 = layer_slice(init_params(cfg, int8_mode=1, weight_bits=4, group_size=16,
                                  device="cpu")["layers"], 0)
    assert not tm._fused_ok(cfg, dict(lp, qkv_w=g16["qkv_w"]))  # formats differ
    assert not tm._fused_ok(cfg, {k: v for k, v in lp.items() if k != "down_b"})
    assert not tm._fused_ok(dataclasses.replace(cfg, use_gptj_residual=False), lp)
    dense = layer_slice(init_params(cfg, device="cpu")["layers"], 0)
    assert not tm._fused_ok(cfg, dense)
