"""The port's debug mode (fastertransformer4codefuse_tpu_torch/utils/debug.py
and ``GptNeoXEngine.generate`` under ``RuntimeConfig.debug_enabled()``)
against the JAX package's, on the cases of tests/test_debug.py: the weight
sweep names the same paths and counts, ``checked_forward`` names the same
first non-finite stage as the JAX checkify forward for the same planted NaN
(several layers and slots, prefill and decode), the engine raises on a
poisoned model and generates the JAX engine's tokens on a clean one, and
with DEBUG off ``generate`` runs no part of the sweep. Also the stdlib logger
and the torch.profiler helpers (utils/logger.py, utils/profiling.py).

Tolerance: stage names and (path, count) pairs equal; tokens identical."""
import dataclasses
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastertransformer4codefuse_tpu import GptNeoXConfig as JaxConfig
from fastertransformer4codefuse_tpu import GptNeoXEngine as JaxEngine
from fastertransformer4codefuse_tpu import RuntimeConfig as JaxRuntime
from fastertransformer4codefuse_tpu import init_params as jax_init_params
from fastertransformer4codefuse_tpu.utils import debug as jdebug
from fastertransformer4codefuse_tpu_torch import (
    GptNeoXConfig,
    GptNeoXEngine,
    RuntimeConfig,
    from_jax_params,
)
from fastertransformer4codefuse_tpu_torch.utils import debug as tdebug

torch.set_num_threads(2)


def _poison(params, slot, layer, pos=(0, 0), value=np.nan):
    layers = dict(params["layers"])
    w = np.asarray(layers[slot], np.float32).copy()
    w[(layer,) + pos] = value
    layers[slot] = jnp.asarray(w)
    return dict(params, layers=layers)


@pytest.fixture(scope="module")
def model():
    jcfg = JaxConfig.tiny(vocab_size=64)
    cfg = GptNeoXConfig(**{f.name: getattr(jcfg, f.name)
                           for f in dataclasses.fields(GptNeoXConfig)})
    return jcfg, cfg, jax_init_params(jcfg, dtype="fp32")


def _stage(fn):
    with pytest.raises(Exception) as ei:
        fn()
    return str(ei.value)


def test_scan_params_matches_jax(model):
    jcfg, cfg, jp = model
    bad = _poison(_poison(jp, "up_w", 1), "ln2_b", 0, pos=(3,), value=np.inf)
    want = jdebug.scan_params(bad)
    assert want and any("up_w" in p for p, _ in want)
    assert tdebug.scan_params(from_jax_params(bad, device="cpu")) == want
    assert tdebug.scan_params(from_jax_params(jp, device="cpu")) == []


@pytest.mark.parametrize("slot,layer", [("up_w", 1), ("qkv_w", 0), ("proj_w", 1), ("down_w", 0)])
def test_checked_forward_names_the_jax_stage(model, slot, layer):
    """The first failing stage is the JAX function's, for a NaN planted in
    each of a layer's four kernels."""
    jcfg, cfg, jp = model
    bad = _poison(jp, slot, layer)
    ids, lens = np.array([[3, 4, 5, 6], [7, 8, 1, 1]], np.int32), np.array([4, 2], np.int32)
    want = _stage(lambda: jdebug.checked_forward(jcfg, bad, ids, lens, jnp.float32))
    with pytest.raises(tdebug.DebugCheckError) as ei:
        tdebug.checked_forward(cfg, from_jax_params(bad, device="cpu"), ids, lens,
                               torch.float32)
    got = str(ei.value)
    assert got.startswith("non-finite activation after layer") and got in want, (got, want)
    assert f"layer {layer} (prefill)" in got


def test_checked_forward_names_the_decode_stage(model):
    """A NaN only the decode step reaches: row 1's embedding when it is the
    prefill's greedy token but in no prompt."""
    jcfg, cfg, jp = model
    tp = from_jax_params(jp, device="cpu")
    ids, lens = np.array([[3, 4, 5, 6]], np.int32), np.array([4], np.int32)
    tdebug.checked_forward(cfg, tp, ids, lens, torch.float32)  # clean
    from fastertransformer4codefuse_tpu_torch.models import gptneox as tm
    logits = tm.lm_logits(cfg, tp, tm.prefill(
        cfg, tp, torch.tensor(ids), torch.tensor(lens),
        __import__("fastertransformer4codefuse_tpu_torch.engine.kv_cache",
                   fromlist=["x"]).init_cache(cfg, 1, 5, torch.float32, "cpu"))[0][:, -1])
    tok = int(torch.argmax(logits, -1)[0])
    if tok in ids:
        pytest.skip("the greedy token is in the prompt on these weights")
    emb = np.asarray(jp["embed"]).copy()
    emb[tok, 0] = np.nan
    bad = dict(jp, embed=jnp.asarray(emb))
    want = _stage(lambda: jdebug.checked_forward(jcfg, bad, ids, lens, jnp.float32))
    with pytest.raises(tdebug.DebugCheckError) as ei:
        tdebug.checked_forward(cfg, from_jax_params(bad, device="cpu"), ids, lens,
                               torch.float32)
    assert "layer 0 (decode)" in str(ei.value) and str(ei.value) in want


def test_engine_debug_mode_catches_and_clean_passes(model):
    jcfg, cfg, jp = model
    rt = dict(dtype="fp32", seq_bucket=4, debug_level="DEBUG")
    je = JaxEngine(jcfg, jp, JaxRuntime(**rt))
    te = GptNeoXEngine(cfg, from_jax_params(jp, device="cpu"), RuntimeConfig(**rt))
    a = je.generate([[3, 4, 5]], output_len=3, top_k=1)
    b = te.generate([[3, 4, 5]], output_len=3, top_k=1)
    np.testing.assert_array_equal(b.output_ids, np.asarray(a.output_ids))
    bad = GptNeoXEngine(cfg, from_jax_params(_poison(jp, "qkv_w", 0), device="cpu"),
                        RuntimeConfig(**rt))
    with pytest.raises(tdebug.DebugCheckError, match="non-finite weights: layers.qkv_w"):
        bad.generate([[3, 4, 5]], output_len=3, top_k=1)
    with pytest.raises(tdebug.DebugCheckError):
        bad.generate([[3, 4, 5]], output_len=3, beam_width=2)


def test_debug_off_is_default_and_runs_nothing(model, monkeypatch):
    jcfg, cfg, jp = model
    monkeypatch.delenv("FT_DEBUG_LEVEL", raising=False)
    assert not RuntimeConfig().debug_enabled()
    assert RuntimeConfig(debug_level="DEBUG").debug_enabled()
    assert RuntimeConfig(debug_level="debug").debug_enabled()
    monkeypatch.setenv("FT_DEBUG_LEVEL", "DEBUG")
    assert RuntimeConfig().debug_enabled() == JaxRuntime().debug_enabled()
    assert not RuntimeConfig(debug_level="INFO").debug_enabled()
    monkeypatch.delenv("FT_DEBUG_LEVEL")
    calls = []
    monkeypatch.setattr(tdebug, "debug_verify", lambda *a: calls.append(a))
    te = GptNeoXEngine(cfg, from_jax_params(jp, device="cpu"),
                       RuntimeConfig(dtype="fp32", seq_bucket=4))
    te.generate([[3, 4, 5]], output_len=3, top_k=1)
    assert not calls
    te.runtime = RuntimeConfig(dtype="fp32", seq_bucket=4, debug_level="DEBUG")
    te.generate([[3, 4, 5]], output_len=3, top_k=1)
    assert len(calls) == 1


def test_logger_follows_the_environment(monkeypatch):
    from fastertransformer4codefuse_tpu.utils import logger as jlog
    from fastertransformer4codefuse_tpu_torch.utils import logger as tlog

    for env in ({"FT_LOG_LEVEL": "WARNING"},
                {"FT_LOG_LEVEL": "trace"},
                {"FT_LOG_LEVEL": "DEBUG", "FT_LOG_FIRST_RANK_ONLY": "ON", "RANK": "1"},
                {}):
        levels = []
        for mod, name in ((jlog, "ftcf_test_jax"), (tlog, "ftcf_test_torch")):
            for k in ("FT_LOG_LEVEL", "FT_LOG_FIRST_RANK_ONLY", "RANK"):
                monkeypatch.delenv(k, raising=False)
            for k, v in env.items():
                monkeypatch.setenv(k, v)
            monkeypatch.setattr(mod, "_configured", False)
            lg = mod.get_logger(f"{name}_{len(levels)}_{sorted(env.items())}")
            levels.append(lg.level)
            lg.handlers.clear()
        if "RANK" in env:  # the JAX logger reads jax.process_index() (0 here)
            assert levels[1] == logging.ERROR
        else:
            assert levels[0] == levels[1]


def test_profiling_helpers_on_the_cpu(tmp_path):
    from fastertransformer4codefuse_tpu_torch.utils import profiling

    with profiling.trace(str(tmp_path), cuda=False) as prof:
        with profiling.annotate("matmul"):
            torch.randn(64, 64) @ torch.randn(64, 64)
    assert list(tmp_path.glob("trace_*.json"))
    names = [e.key for e in prof.key_averages()]
    assert "matmul" in names
    assert profiling.summarize_trace(prof) == []  # no device activity on the CPU
