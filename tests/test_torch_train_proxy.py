"""The port's proxy trainer (fastertransformer4codefuse_tpu_torch/tools/
train_proxy.py) against the JAX repo's tools/train_proxy.py: three training
steps from the same weights and batches (JAX's loss_fn + value_and_grad +
optax.adamw against the port's prefill + autograd + torch AdamW), the
schedule, the checkpoint format both ways, the corpus and the batch draw.

Tolerances: the loss within 1e-5 relative and the params within 1e-5 of
max |param| after three steps (fp32 summation order in the forward and the
gradient; Adam's update divides by sqrt(v), so a gradient's relative error
passes into the update); the schedule within 1e-7 (optax evaluates it in
fp32)."""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools"))
import train_proxy as jtp  # noqa: E402  (the JAX repo's tool)

from fastertransformer4codefuse_tpu import init_params as jax_init_params  # noqa: E402
from fastertransformer4codefuse_tpu.models import gptneox as jmodel  # noqa: E402
from fastertransformer4codefuse_tpu_torch.models.params import from_jax_params  # noqa: E402
from fastertransformer4codefuse_tpu_torch.tools import train_proxy as ttp  # noqa: E402

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tree_np(tree):
    return {k: (_tree_np(v) if isinstance(v, dict) else np.asarray(v)) for k, v in tree.items()}


def _flat_np(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_np(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v.detach().cpu() if torch.is_tensor(v) else v)
    return out


def _jax_steps(cfg, params, batches, steps, lr):
    """The JAX tool's training loop body (its loss_fn, value_and_grad and
    optax.adamw), unjitted, over ``batches``."""
    warmup = min(50, max(steps // 10, 1))
    opt = optax.adamw(optax.warmup_cosine_decay_schedule(0.0, lr, warmup,
                                                         max(steps, warmup + 1)),
                      weight_decay=0.01)
    o = opt.init(params)
    B, S = batches[0].shape

    def loss_fn(p, ids):
        cache = jmodel.init_kv_cache(cfg, B, S, jnp.float32)
        hidden, _ = jmodel.prefill(cfg, p, ids, jnp.full((B,), S, jnp.int32), cache)
        logits = jmodel.lm_logits(cfg, p, hidden)
        lp = jax.nn.log_softmax(logits[:, :-1], axis=-1)
        nll = -jnp.take_along_axis(lp, ids[:, 1:][..., None], axis=-1)
        return nll.mean()

    losses = []
    for ids in batches:
        loss, g = jax.value_and_grad(loss_fn)(params, jnp.asarray(ids))
        updates, o = opt.update(g, o, params)
        params = optax.apply_updates(params, updates)
        losses.append(float(loss))
    return params, losses


def test_three_training_steps_match_jax_and_optax():
    steps, lr, B, S = 3, 3e-4, 2, 32
    jcfg = jtp.sized_config(4, 16, 2, 64)
    tcfg = ttp.sized_config(4, 16, 2, 64)
    jparams = jax_init_params(jcfg, rng=jax.random.PRNGKey(0), dtype="fp32")
    train, _ = ttp.split_corpus(ttp.load_corpus(REPO))
    rng = np.random.default_rng(0)
    batches = [ttp.draw_batch(rng, train, B, S) for _ in range(steps)]
    want_params, want_losses = _jax_steps(jcfg, jparams, batches, steps, lr)

    params = from_jax_params(_tree_np(jparams), device="cpu")
    opt = ttp.make_optimizer(params)
    lr_at = ttp.schedule_of(steps, lr)
    losses = [float(ttp.train_step(tcfg, params, opt, lr_at(i), torch.from_numpy(ids)))
              for i, ids in enumerate(batches)]
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    assert losses[0] > 4.0  # a byte model at init: ~ln 256
    got, want = _flat_np(params), _flat_np(want_params)
    assert got.keys() == want.keys()
    top = max(np.abs(w).max() for w in want.values())
    for k in want:
        err = np.abs(got[k] - want[k]).max()
        assert err <= 1e-5 * top, (k, err, top)


@pytest.mark.parametrize("steps", [3, 10, 600, 3000])
def test_schedule_equals_optax(steps):
    lr = 3e-4
    warmup = min(50, max(steps // 10, 1))
    want = optax.warmup_cosine_decay_schedule(0.0, lr, warmup, max(steps, warmup + 1))
    lr_at = ttp.schedule_of(steps, lr)
    for i in range(steps + 2):
        assert abs(lr_at(i) - float(want(i))) <= 1e-7, i


def test_checkpoints_load_both_ways(tmp_path):
    """JAX save_params -> port load_params, and port save_params -> JAX
    load_params, leaf for leaf; the config travels in __config__."""
    cfg = jtp.sized_config(4, 16, 2, 64)
    jparams = jax_init_params(cfg, rng=jax.random.PRNGKey(1), dtype="fp32")
    path = str(tmp_path / "jax.npz")
    jtp.save_params(path, jparams)
    loaded = ttp.load_params(path, device="cpu")
    want = _flat_np(jparams)
    got = _flat_np(loaded)
    assert got.keys() == want.keys()
    for k in want:
        assert np.array_equal(got[k], want[k]), k

    tparams = ttp.init_params(ttp.sized_config(4, 16, 2, 64), seed=2, device="cpu")
    path2 = str(tmp_path / "port.npz")
    ttp.save_params(path2, tparams)
    z = dict(np.load(path2))
    z["__config__"] = np.array('{"heads": 4, "dh": 16, "layers": 2, "inter": 64}')
    np.savez(path2, **z)
    back = jtp.load_params(path2)
    want = _flat_np(tparams)
    got = _flat_np(back)
    assert got.keys() == want.keys()
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    for mod in (jtp, ttp):
        c = mod.config_of_ckpt(path2)
        assert (c.head_num, c.size_per_head, c.layer_num, c.inter_size) == (4, 16, 2, 64)


def test_corpus_and_batches_equal_the_jax_tools():
    corpus = ttp.load_corpus(REPO)
    assert np.array_equal(corpus, jtp.load_corpus(REPO))
    train, held = ttp.split_corpus(corpus)
    assert len(held) == len(corpus) - int(len(corpus) * 0.95)
    r1, r2 = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(3):
        starts = r2.integers(0, len(train) - 256 - 1, size=8)
        want = np.stack([train[s: s + 256] for s in starts])
        assert np.array_equal(ttp.draw_batch(r1, train, 8, 256), want)


@pytest.mark.parametrize("with_git", [True, False])
def test_tracked_corpus_leaves_out_ignored_trees(tmp_path, with_git):
    """The corpus reader of the port's tools reads what the repository
    tracks: on a clean tree the bytes of ``load_corpus``; a copy planted
    under a git-ignored ``build/`` grows ``load_corpus`` (and the JAX tool's,
    the same function: a fault of the JAX package the port does not copy)
    but not the tracked reader, in a git work tree (``git ls-files``) and in
    a tree without ``.git`` (a walk that honours ``.gitignore``)."""
    root = str(tmp_path)
    files = {"a.py": "x = 1\n", "docs/b.md": "# B\n", "pkg/c.py": "def f():\n    pass\n",
             "pkg/d.txt": "not text of the corpus\n", ".gitignore": "build/\n__pycache__/\n"}
    for rel, text in files.items():
        os.makedirs(os.path.dirname(os.path.join(root, rel)), exist_ok=True)
        with open(os.path.join(root, rel), "w") as f:
            f.write(text)
    if with_git:
        subprocess.run(["git", "init", "-q", root], check=True)
        subprocess.run(["git", "-C", root, "add", "-A"], check=True)
    clean = ttp.load_corpus(root)
    assert len(clean) and np.array_equal(ttp.load_tracked_corpus(root), clean)
    for rel in ("a.py", "docs/b.md", "pkg/c.py"):
        for stale in ("build/copy", "pkg/__pycache__"):
            os.makedirs(os.path.dirname(os.path.join(root, stale, rel)), exist_ok=True)
            shutil.copy(os.path.join(root, rel), os.path.join(root, stale, rel))
    grown = ttp.load_corpus(root)
    assert len(grown) > len(clean) and np.array_equal(jtp.load_corpus(root), grown)
    assert np.array_equal(ttp.load_tracked_corpus(root), clean)
    assert all("build" not in p and "__pycache__" not in p
               for p in ttp.tracked_text_paths(root, ("*.py", "*.md")))


def test_main_trains_and_writes_a_checkpoint_on_the_cpu(tmp_path, capsys):
    out = str(tmp_path / "p.npz")
    ttp.main(["--steps", "2", "--batch", "2", "--seq", "16", "--heads", "2", "--dh", "16",
              "--layers", "1", "--inter", "32", "--out", out, "--device", "cpu"])
    text = capsys.readouterr().out
    assert "ms/step" in text and "step     1" in text
    cfg = jtp.config_of_ckpt(out)
    assert (cfg.head_num, cfg.layer_num) == (2, 1)
    assert np.load(out + ".heldout.npy").dtype == np.int32
    assert ttp.load_params(out, device="cpu")["layers"]["qkv_w"].shape == (1, 32, 96)
