"""The port's T5 quality row (fastertransformer4codefuse_tpu_torch/tools/
t5_quality_row.py) against the JAX repo's tools/t5_quality_row.py: one
training step's loss and gradients through the served decoder step
(``models.t5.decode_step`` under autograd against ``jax.value_and_grad`` of
the JAX tool's ``batch_loss``, a ``lax.scan`` of the JAX step), from the same
weights and windows; the int8 row's NLL; the tool's ``main`` on the CPU.

Tolerances: the loss within 1e-5 relative, each gradient within 1e-5 of its
leaf's max |grad| (fp32 summation order through 4 + 4 layers and T steps);
the int8 NLL within 1e-4 (the same int8 codes)."""
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import fastertransformer4codefuse_tpu.utils.compile_cache as _compile_cache

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools"))
_enable = _compile_cache.enable
_compile_cache.enable = lambda *a, **k: None  # the JAX tool turns on a disk cache at import
try:
    import t5_quality_row as jt5  # noqa: E402  (the JAX repo's tool)
finally:
    _compile_cache.enable = _enable

from fastertransformer4codefuse_tpu.models import t5 as jt5m  # noqa: E402
from fastertransformer4codefuse_tpu_torch.models.params import from_jax_params  # noqa: E402
from fastertransformer4codefuse_tpu_torch.tools import t5_quality_row as tt5  # noqa: E402
from fastertransformer4codefuse_tpu_torch.tools.train_proxy import flatten  # noqa: E402

torch.set_num_threads(2)


def _tiny(mod):
    c = mod.proxy_config()
    return type(c)(**{**c.__dict__, "layer_num": 2, "dec_layer_num": 2, "d_model": 64,
                      "head_num": 2, "size_per_head": 32, "inter_size": 128})


@pytest.fixture(scope="module")
def case():
    jcfg, tcfg = _tiny(jt5), _tiny(tt5)
    jp = jt5.init_t5_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    win = rng.integers(2, tt5.VOCAB, size=(3, 24)).astype(np.int32)
    return jcfg, tcfg, jp, win


def test_one_training_step_matches_the_jax_batch_loss(case):
    jcfg, tcfg, jp, win = case
    ctx = 12
    want_loss, want_g = jax.value_and_grad(
        lambda p: jt5.batch_loss(jcfg, p, jnp.asarray(win[:, :ctx]), jnp.asarray(win[:, ctx:])))(jp)
    params = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    for _, t in flatten(params):
        t.requires_grad_()
    w = torch.from_numpy(win.astype(np.int64))
    loss = tt5.batch_loss(tcfg, params, w[:, :ctx], w[:, ctx:])
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    want = dict((k, np.asarray(v)) for k, v in flatten(jax.tree.map(np.asarray, want_g)))
    got = {k: t.grad.numpy() for k, t in flatten(params)}
    assert got.keys() == want.keys()
    for k in want:
        top = np.abs(want[k]).max()
        assert top > 0, k
        assert np.abs(got[k] - want[k]).max() <= 1e-5 * top, k


def test_int8_row_nll_matches_jax(case):
    jcfg, tcfg, jp, win = case
    ctx = 12
    held = win.reshape(-1)
    jq = jt5m.quantize_t5_params(jp)
    tq = from_jax_params(jax.tree.map(lambda x: x, jq), device="cpu")
    want = []
    for p in (jp, jq):
        tot, cnt = 0.0, 0
        for s in range(0, len(held) - 2 * ctx, 2 * ctx):
            seg = held[s: s + 2 * ctx]
            tot += float(jt5.batch_loss(jcfg, p, jnp.asarray(seg[None, :ctx]),
                                        jnp.asarray(seg[None, ctx:]))) * ctx
            cnt += ctx
        want.append(tot / cnt)
    got = [tt5.eval_nll(tcfg, from_jax_params(jax.tree.map(np.asarray, jp), device="cpu"),
                        held, ctx),
           tt5.eval_nll(tcfg, tq, held, ctx)]
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_init_matches_the_jax_tools_shapes():
    jp = jt5.init_t5_params(jt5.proxy_config(), jax.random.PRNGKey(0))
    tp = tt5.init_t5_params(tt5.proxy_config(), 0, "cpu")
    want = {k: np.asarray(v).shape for k, v in flatten(jax.tree.map(np.asarray, jp))}
    assert {k: tuple(t.shape) for k, t in flatten(tp)} == want


def test_main_runs_on_the_cpu(capsys, monkeypatch):
    cfg = _tiny(tt5)
    monkeypatch.setattr(tt5, "proxy_config", lambda: cfg)
    tt5.main(["--steps", "2", "--batch", "2", "--ctx", "8", "--eval-bytes", "64",
              "--device", "cpu"])
    out = capsys.readouterr().out
    assert "T5 proxy quality: fp32 NLL" in out and "step 1: loss" in out
