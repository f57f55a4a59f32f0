"""The port's quality harness (fastertransformer4codefuse_tpu_torch/tools/
quality_eval.py and quality_table.py) against the JAX repo's
tools/quality_eval.py and tools/quality_table.py, on a tiny fp32 model with
the same weights: the prefill NLL over float, int8 and group-wise int4
weights, the decode-path NLL over bf16, int8, int8k_int4v and int4 caches,
greedy agreement, and the whole table (every row, the markdown lines) of
both tools' ``main`` on one checkpoint.

Tolerances: NLL within 1e-4 absolute (fp32 summation order over a chunk's
prefill or a decode step; quantized weights are the same codes on both
sides); agreement equal; the markdown lines identical with their numbers
masked, and each number within 1e-4 (ppl 1e-4 relative)."""
import json
import os
import re
import sys

import numpy as np
import pytest
import torch

import jax

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools"))
import quality_eval as jqe  # noqa: E402  (the JAX repo's tools)
import quality_table as jqt  # noqa: E402
import train_proxy as jtp  # noqa: E402

import jax.numpy as jnp  # noqa: E402
from fastertransformer4codefuse_tpu import GptNeoXEngine as JaxEngine  # noqa: E402
from fastertransformer4codefuse_tpu import RuntimeConfig as JaxRuntime  # noqa: E402
from fastertransformer4codefuse_tpu import init_params as jax_init_params  # noqa: E402
from fastertransformer4codefuse_tpu.ckpt.quantize import quantize_params as jax_quantize  # noqa
from fastertransformer4codefuse_tpu_torch import GptNeoXEngine, RuntimeConfig  # noqa: E402
from fastertransformer4codefuse_tpu_torch.models.params import from_jax_params  # noqa: E402
from fastertransformer4codefuse_tpu_torch.tools import quality_eval as tqe  # noqa: E402
from fastertransformer4codefuse_tpu_torch.tools import quality_table as tqt  # noqa: E402
from fastertransformer4codefuse_tpu_torch.tools import train_proxy as ttp  # noqa: E402

torch.set_num_threads(2)

WEIGHTS = {"fp32": {}, "int8": {"weight_bits": 8}, "int4 g32": {"weight_bits": 4, "group_size": 32}}


@pytest.fixture(scope="module")
def model():
    cfg = jtp.sized_config(4, 16, 2, 128)  # hidden 64, byte vocab
    jp = jax_init_params(cfg, rng=jax.random.PRNGKey(0), dtype="fp32")
    ids = np.random.RandomState(0).randint(0, 256, size=(300,))
    return cfg, ttp.sized_config(4, 16, 2, 128), jp, ids


def _pair(jp, kind):
    """(JAX params, the port's params holding the same values)."""
    if kind != "fp32":
        jp = jax_quantize(jp, **WEIGHTS[kind])
    return jp, from_jax_params(jp, device="cpu")


@pytest.mark.parametrize("kind", list(WEIGHTS))
def test_eval_nll_matches_jax(model, kind):
    cfg, tcfg, jp, ids = model
    jparams, tparams = _pair(jp, kind)
    want = jqe.eval_nll(cfg, jparams, ids, chunk=64)
    got = tqe.eval_nll(tcfg, tparams, ids, chunk=64)
    assert 0 < want < 20
    assert abs(got - want) <= 1e-4, (got, want)


@pytest.mark.parametrize("kind,kv", [("fp32", "bf16"), ("int8", "int8"),
                                     ("int4 g32", "int8k_int4v"), ("int8", "int4")])
def test_eval_decode_nll_matches_jax(model, kind, kv):
    cfg, tcfg, jp, ids = model
    jparams, tparams = _pair(jp, kind)
    jkv = {"bf16": jnp.bfloat16, "int8": jnp.int8}.get(kv, kv)
    tkv = {"bf16": torch.bfloat16, "int8": torch.int8}.get(kv, kv)
    want = jqe.eval_decode_nll(cfg, jparams, ids[:130], jkv, chunk=64, prefix=16)
    got = tqe.eval_decode_nll(tcfg, tparams, ids[:130], tkv, chunk=64, prefix=16)
    assert abs(got - want) <= 1e-4, (got, want)


def test_greedy_agreement_equals_jax(model):
    cfg, tcfg, jp, _ = model
    prompts = [[3, 4, 5], [9, 8, 7], [100, 200, 50, 25]]
    jq, tq = _pair(jp, "int4 g32")
    _, tf = _pair(jp, "fp32")
    want = jqe.greedy_agreement(
        JaxEngine(cfg, jp, JaxRuntime(dtype="fp32", seq_bucket=8)),
        JaxEngine(cfg, jq, JaxRuntime(dtype="fp32", int8_mode=1, seq_bucket=8)), prompts, 8)
    got = tqe.greedy_agreement(
        GptNeoXEngine(tcfg, tf, RuntimeConfig(dtype="fp32", seq_bucket=8)),
        GptNeoXEngine(tcfg, tq, RuntimeConfig(dtype="fp32", int8_mode=1, seq_bucket=8)),
        prompts, 8)
    assert got == want
    assert 0 < got <= 1


_NUM = re.compile(r"[-+]?\d+\.\d+")


def test_quality_table_main_matches_the_jax_tool(tmp_path, capsys):
    """Both tools' ``main`` on one checkpoint: the same rows in the same
    order, the same markdown lines, numbers within tolerance."""
    cfg = jtp.sized_config(8, 16, 2, 256)  # hidden 128: one group of 128
    jp = jax_init_params(cfg, rng=jax.random.PRNGKey(0), dtype="fp32")
    ck = str(tmp_path / "tiny.npz")
    jtp.save_params(ck, jp)
    z = dict(np.load(ck))
    z["__config__"] = np.array(json.dumps(dict(heads=8, dh=16, layers=2, inter=256)))
    np.savez(ck, **z)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    np.save(ck + ".heldout.npy", jtp.load_corpus(os.path.join(repo, "tools"))[-1100:])
    flags = ["--ckpt", ck, "--max-heldout", "1100", "--prompts", "2", "--gen-len", "4"]
    jout, tout = str(tmp_path / "jax.md"), str(tmp_path / "port.md")
    argv = sys.argv
    try:
        sys.argv = ["quality_table", *flags, "--out", jout]
        jqt.main()
    finally:
        sys.argv = argv
    tqt.main([*flags, "--out", tout, "--dtype", "fp32", "--device", "cpu"])
    capsys.readouterr()
    want = open(jout).read().splitlines()
    got = open(tout).read().splitlines()
    assert len(got) == len(want) == 12
    assert [ln.split(" | ")[0] for ln in got] == [ln.split(" | ")[0] for ln in want]
    for g, w in zip(got, want):
        assert _NUM.sub("#", g) == _NUM.sub("#", w), (g, w)
        gn, wn = (list(map(float, _NUM.findall(x))) for x in (g, w))
        if not gn:
            continue
        nll, ppl, d, agree = gn[:4]
        assert abs(nll - wn[0]) <= 1e-4 and abs(ppl - wn[1]) <= 1e-4 * wn[1], (g, w)
        assert abs(d - wn[2]) <= 2e-4 and agree == wn[3], (g, w)
        if len(gn) == 5:
            assert abs(gn[4] - wn[4]) <= 2e-4, (g, w)


def test_quality_table_refuses_fp32_on_the_card():
    with pytest.raises(SystemExit, match="fp32 activations on the card"):
        tqt.main(["--ckpt", "unused.npz", "--dtype", "fp32"])
