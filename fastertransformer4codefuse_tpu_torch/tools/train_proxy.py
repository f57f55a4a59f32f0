"""Train a small byte-level GPT-NeoX on this repository's own source text
(port of the JAX repo's tools/train_proxy.py).

A quality-eval proxy with trained weight statistics: no checkpoint can be
downloaded here, and random Gaussian weights are a dishonest quantization
testbed, since trained weights grow the per-channel outliers that group-wise
scales and AWQ exist for. The model's own ``prefill`` is the training
forward, differentiated by autograd; on the card its attention is K5's fp32
forward and its gradient K5's dK/dV and dQ kernels (``ops/attention.py``
``PrefillFlash``).

The same flags, batches and checkpoint as the JAX tool: batches are drawn by
``np.random.default_rng(seed)`` as there, the optimizer is AdamW (betas 0.9,
0.999, eps 1e-8, weight decay 0.01) under optax's warmup-cosine schedule
(``warmup_cosine``), and the npz holds the ``/``-joined parameter keys, the
``__config__`` json and a ``.heldout.npy`` beside it, so either package's
checkpoint loads into the other. Initialization is ``models.params.
init_params`` (one seeded ``torch.Generator``, fp32), so the weights differ
from the JAX tool's.

    python -m fastertransformer4codefuse_tpu_torch.tools.train_proxy --steps 600 \\
        --out /tmp/ftcf_proxy.npz [--device cpu]
"""
from __future__ import annotations

import argparse
import fnmatch
import glob
import json
import math
import os
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from ..core.config import GptNeoXConfig
from ..engine import kv_cache as kvc
from ..models import gptneox as model
from ..models.params import init_params

REPO_ROOT = Path(__file__).resolve().parents[2]


def load_corpus(root: str, extra_roots=()) -> np.ndarray:
    """Byte stream of source text: the repo's Python + Markdown, plus any
    ``extra_roots`` (more source trees: a larger proxy needs more text so as
    not to overfit). The same bytes as the JAX tool's."""
    exts = ("*.py", "*.md")
    extra_exts = ("*.py", "*.md", "*.cc", "*.cu", "*.h", "*.hpp", "*.cpp")
    paths = sorted(
        sum((glob.glob(os.path.join(root, "**", e), recursive=True) for e in exts), [])
        + sum(
            (glob.glob(os.path.join(r, "**", e), recursive=True)
             for r in extra_roots for e in extra_exts),
            [],
        )
    )
    blobs = []
    for p in paths:
        try:
            with open(p, "rb") as f:
                blobs.append(f.read())
        except OSError:
            pass
    data = b"\n\n".join(blobs)
    return np.frombuffer(data, dtype=np.uint8).astype(np.int32)


def _ignore_patterns(root: str):
    """The patterns of ``root``'s ``.gitignore`` (no negations, no nesting)."""
    try:
        with open(os.path.join(root, ".gitignore")) as f:
            lines = [x.strip() for x in f]
    except OSError:
        return []
    return [x for x in lines if x and not x.startswith(("#", "!"))]


def _ignored(rel: str, is_dir: bool, patterns) -> bool:
    name = rel.rsplit("/", 1)[-1]
    for p in patterns:
        if p.endswith("/") and not is_dir:
            continue
        p = p.rstrip("/")
        if fnmatch.fnmatch(rel, p.lstrip("/")) if "/" in p else fnmatch.fnmatch(name, p):
            return True
    return False


def _git_tracked(root: str):
    """Paths under ``root`` (relative to it) that git tracks, where ``root``
    is the top of a git work tree; else None (no ``.git``, as in a ``git
    archive`` copy, also one unpacked inside another checkout; or no git)."""
    def git(*args):
        return subprocess.run(["git", "-C", root, *args], capture_output=True)

    try:
        top = git("rev-parse", "--show-toplevel")
        if top.returncode or os.path.realpath(top.stdout.decode().strip()) != os.path.realpath(
                root):
            return None
        listed = git("ls-files", "-z")
    except OSError:
        return None
    if listed.returncode:
        return None
    return [p for p in listed.stdout.decode().split("\0") if p]


def tracked_text_paths(root: str, exts) -> list:
    """The files under ``root`` whose names match ``exts`` that the
    repository tracks: ``git ls-files`` in a git work tree; where there is
    no ``.git`` (a ``git archive`` copy), a walk that leaves out what
    ``root``'s ``.gitignore`` names (``build/``, ``__pycache__/``, ...). As
    ``glob`` does in ``load_corpus``, no hidden file or directory."""
    rels = _git_tracked(root)
    if rels is None:
        patterns = _ignore_patterns(root)
        rels = []
        for d, dirs, files in os.walk(root):
            at = os.path.relpath(d, root).replace(os.sep, "/")
            at = "" if at == "." else at + "/"
            dirs[:] = sorted(x for x in dirs
                             if not x.startswith(".") and not _ignored(at + x, True, patterns))
            rels += [at + x for x in files if not _ignored(at + x, False, patterns)]
    return [os.path.join(root, r) for r in rels
            if not any(part.startswith(".") for part in r.split("/"))
            and any(fnmatch.fnmatch(r.rsplit("/", 1)[-1], e) for e in exts)]


def load_tracked_corpus(root: str, extra_roots=()) -> np.ndarray:
    """``load_corpus`` over what the repository tracks (``tracked_text_paths``):
    ``load_corpus`` globs every file under ``root``, so a stale tree under a
    git-ignored ``build/`` enters the corpus and may put held-out text into
    the training split. The same order and joins, so on a clean checkout
    the same bytes as ``load_corpus``."""
    paths = sorted(tracked_text_paths(root, ("*.py", "*.md")) + sum(
        (tracked_text_paths(r, ("*.py", "*.md", "*.cc", "*.cu", "*.h", "*.hpp", "*.cpp"))
         for r in extra_roots), []))
    blobs = []
    for p in paths:
        try:
            with open(p, "rb") as f:
                blobs.append(f.read())
        except OSError:
            pass
    return np.frombuffer(b"\n\n".join(blobs), dtype=np.uint8).astype(np.int32)


def proxy_config() -> GptNeoXConfig:
    """The default ~19M-parameter proxy: vocab 256 (raw bytes), CodeFuse's
    block (GPT-J residual, tanh-gelu, rotary over half the head)."""
    return GptNeoXConfig.tiny(
        head_num=8,
        size_per_head=64,
        layer_num=6,
        vocab_size=256,
        rotary_embedding_dim=32,
        inter_size=2048,
        activation="gelu-tanh",
        model_name="proxy19m",
    )


def sized_config(heads, dh, layers, inter) -> GptNeoXConfig:
    return GptNeoXConfig.tiny(
        head_num=heads,
        size_per_head=dh,
        layer_num=layers,
        vocab_size=256,
        rotary_embedding_dim=dh // 2,
        inter_size=inter,
        activation="gelu-tanh",
        model_name=f"proxy-h{heads}x{dh}-L{layers}",
    )


def config_of_ckpt(path) -> GptNeoXConfig:
    """The proxy config a checkpoint was trained with (its ``__config__``
    json; the default 19M for a checkpoint without one)."""
    z = np.load(path, allow_pickle=False)
    if "__config__" in z.files:
        return sized_config(**json.loads(str(z["__config__"])))
    return proxy_config()


def flatten(params, prefix=""):
    """[(``/``-joined key, tensor)] of a nested parameter dict, in key order."""
    out = []
    for k in sorted(params):
        v = params[k]
        key = f"{prefix}{k}"
        out += flatten(v, key + "/") if isinstance(v, dict) else [(key, v)]
    return out


def detached(params):
    """The nested params dict with every leaf detached from autograd."""
    return {k: detached(v) if isinstance(v, dict) else v.detach() for k, v in params.items()}


def save_params(path: str, params) -> None:
    np.savez(path, **{k: v.detach().cpu().numpy() for k, v in flatten(params)})


def load_params(path: str, device=None):
    """The nested params dict of an npz written by either package's
    ``save_params``, as tensors on ``device`` (the card when None)."""
    from ..core.device import resolve_device

    device = resolve_device(device)
    z = np.load(path)
    params = {}
    for key in z.files:
        if key.startswith("__"):  # metadata (e.g. __config__), not a leaf
            continue
        parts = key.split("/")
        d = params
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = torch.from_numpy(np.array(z[key])).to(device)
    return params


def warmup_cosine(step: int, lr: float, warmup: int, decay_steps: int) -> float:
    """``optax.warmup_cosine_decay_schedule(0.0, lr, warmup, decay_steps)`` at
    ``step``: linear from 0 to lr over ``warmup`` steps, then a cosine to 0 at
    ``decay_steps``."""
    if step < warmup:
        return lr * step / warmup
    t = min(step - warmup, decay_steps - warmup)
    return lr * 0.5 * (1.0 + math.cos(math.pi * t / (decay_steps - warmup)))


def schedule_of(steps: int, lr: float):
    """The JAX tool's schedule for a run of ``steps``: warmup min(50,
    max(steps // 10, 1)), decay over max(steps, warmup + 1)."""
    warmup = min(50, max(steps // 10, 1))
    decay = max(steps, warmup + 1)
    return lambda i: warmup_cosine(i, lr, warmup, decay)


def make_optimizer(params, betas=(0.9, 0.999)) -> torch.optim.AdamW:
    """``optax.adamw(schedule, *betas, weight_decay=0.01)`` over every leaf
    of ``params`` (made to require grad): each step sets its lr."""
    leaves = [t.requires_grad_() for _, t in flatten(params)]
    return torch.optim.AdamW(leaves, lr=0.0, betas=betas, eps=1e-8, weight_decay=0.01)


def loss_fn(config: GptNeoXConfig, params, ids: torch.Tensor) -> torch.Tensor:
    """Mean next-byte NLL of a batch [B, S] through the model's prefill (a
    fresh fp32 cache, every row at full length)."""
    B, S = ids.shape
    cache = kvc.init_cache(config, B, S, torch.float32, ids.device)
    lens = torch.full((B,), S, dtype=torch.int32, device=ids.device)
    hidden, _ = model.prefill(config, params, ids, lens, cache)
    logits = model.lm_logits(config, params, hidden)  # [B, S, V] fp32
    lp = torch.log_softmax(logits[:, :-1], dim=-1)
    return -lp.gather(-1, ids[:, 1:, None].long()).mean()


def train_step(config, params, opt, lr: float, ids: torch.Tensor) -> torch.Tensor:
    """One AdamW step at ``lr``; returns the loss before it (on the device)."""
    for g in opt.param_groups:
        g["lr"] = lr
    opt.zero_grad(set_to_none=True)
    loss = loss_fn(config, params, ids)
    loss.backward()
    opt.step()
    return loss.detach()


def draw_batch(rng: np.random.Generator, train: np.ndarray, B: int, S: int) -> np.ndarray:
    """B windows of S bytes, as the JAX tool draws them."""
    starts = rng.integers(0, len(train) - S - 1, size=B)
    return np.stack([train[s: s + S] for s in starts])


def split_corpus(corpus: np.ndarray):
    split = int(len(corpus) * 0.95)
    return corpus[:split], corpus[split:]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--out", default="/tmp/ftcf_proxy.npz")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--dh", type=int, default=64)
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--inter", type=int, default=2048)
    ap.add_argument("--corpus-extra", default="",
                    help="comma-separated extra source roots to enlarge the byte corpus")
    ap.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    args = ap.parse_args(argv)

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to train on the CPU")
    cfg = sized_config(args.heads, args.dh, args.layers, args.inter)
    corpus = load_tracked_corpus(str(REPO_ROOT),
                                 [r for r in args.corpus_extra.split(",") if r])
    train, held = split_corpus(corpus)
    print(f"corpus: {len(corpus)} bytes ({len(train)} train / {len(held)} held-out)")

    params = init_params(cfg, seed=args.seed, dtype=torch.float32, device=dev)
    print(f"params: {sum(t.numel() for _, t in flatten(params)) / 1e6:.1f}M")
    opt = make_optimizer(params)
    lr_at = schedule_of(args.steps, args.lr)
    B, S = args.batch, args.seq
    rng = np.random.default_rng(args.seed)
    t0 = t1 = time.time()
    for i in range(args.steps):
        ids = torch.from_numpy(draw_batch(rng, train, B, S)).to(dev)
        loss = train_step(cfg, params, opt, lr_at(i), ids)
        if i % 50 == 0 or i == args.steps - 1:
            print(f"step {i:5d}  loss {float(loss):.4f}  ({(time.time() - t0):.0f}s)", flush=True)
        if i == 0:  # step 0 builds the kernels on a fresh checkout: timed apart
            t1 = time.time()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t2 = time.time()
    print(f"trained {args.steps} steps in {t2 - t0:.1f} s: step 0 {t1 - t0:.1f} s, then "
          f"{1e3 * (t2 - t1) / max(args.steps - 1, 1):.1f} ms/step")

    save_params(args.out, params)
    # the config rides in the npz so that evaluators rebuild the architecture
    z = dict(np.load(args.out, allow_pickle=False))
    z["__config__"] = np.array(json.dumps(dict(
        heads=args.heads, dh=args.dh, layers=args.layers, inter=args.inter)))
    np.savez(args.out, **z)
    np.save(args.out + ".heldout.npy", held)
    print(f"saved {args.out} (+ .heldout.npy, {len(held)} bytes)")


if __name__ == "__main__":
    main()
