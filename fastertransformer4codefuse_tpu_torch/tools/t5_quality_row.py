"""Train a byte-level T5 proxy and measure the int8 quality delta (port of
the JAX repo's tools/t5_quality_row.py).

The T5 counterpart of ``train_proxy`` + ``quality_table``: a small T5 trains
as a byte-level prefix-LM on this repository's source text (a window's first
half is the encoder input, its second half the decoder target); then the
float and int8 (``models.t5.quantize_t5_params``) weights run teacher-forced
NLL over held-out bytes, and greedy agreement through the same ``T5Engine``.
The training forward is the served code: the loss runs ``models.t5.
decode_step`` over the target positions (incremental cache and cross
attention) under plain autograd, so the evaluation measures the served
program. T5 runs in plain PyTorch (the JAX package runs it in XLA): no
kernel on this path.

    python -m fastertransformer4codefuse_tpu_torch.tools.t5_quality_row --steps 400 \\
        [--device cpu] [--corpus-extra DIR,...]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..engine.t5_engine import T5Engine
from ..models import t5 as t5m
from ..models.t5 import T5Config
from .train_proxy import (REPO_ROOT, detached, flatten, load_tracked_corpus, make_optimizer,
                          warmup_cosine)

VOCAB = 259  # 0 = pad / decoder start, 1 = eos, bytes at ids 2..257


def proxy_config() -> T5Config:
    return T5Config(
        head_num=4, size_per_head=64, d_model=256, layer_num=4,
        dec_layer_num=4, vocab_size=VOCAB, inter_size=1024, num_buckets=32,
        max_distance=128, activation="relu", start_id=0, end_id=1,
        tie_head=True,
    )


def init_t5_params(cfg: T5Config, seed: int = 0, device="cpu"):
    """Random fp32 params of the JAX tool's shapes and scales, from one
    seeded ``torch.Generator`` (other numbers than the JAX tool's)."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    D, nH, dh, F = cfg.d_model, cfg.head_num, cfg.size_per_head, cfg.inter_size
    n = nH * dh

    def dense(shape, scale):
        return torch.randn(shape, generator=gen, device=device) * scale

    def ones(shape):
        return torch.ones(shape, device=device)

    def stack_attn(L):
        return {
            "ln1_w": ones((L, D)),
            "q_w": dense((L, D, n), (D * dh) ** -0.5),
            "k_w": dense((L, D, n), D ** -0.5),
            "v_w": dense((L, D, n), D ** -0.5),
            "o_w": dense((L, n, D), n ** -0.5),
            "ln2_w": ones((L, D)),
            "wi": dense((L, D, F), D ** -0.5),
            "wo": dense((L, F, D), F ** -0.5),
        }

    enc = stack_attn(cfg.layer_num)
    dec = stack_attn(cfg.dec_layer_num)
    Ld = cfg.dec_layer_num
    dec.update({
        "ln_x_w": ones((Ld, D)),
        "xq_w": dense((Ld, D, n), (D * dh) ** -0.5),
        "xk_w": dense((Ld, D, n), D ** -0.5),
        "xv_w": dense((Ld, D, n), D ** -0.5),
        "xo_w": dense((Ld, n, D), n ** -0.5),
    })
    return {
        "embed": dense((cfg.vocab_size, D), 1.0),
        "enc": enc,
        "dec": dec,
        "enc_rel_bias": dense((cfg.num_buckets, nH), 0.5),
        "dec_rel_bias": dense((cfg.num_buckets, nH), 0.5),
        "enc_final_ln_w": ones((D,)),
        "dec_final_ln_w": ones((D,)),
    }


def batch_loss(cfg: T5Config, params, enc_ids: torch.Tensor, dec_targets: torch.Tensor):
    """Teacher-forced prefix-LM loss through the serving code path: the
    encoder, then ``decode_step`` at each target position."""
    B, T = dec_targets.shape
    S = enc_ids.shape[1]
    lens = torch.full((B,), S, dtype=torch.int32, device=enc_ids.device)
    enc = t5m.encode(cfg, params, enc_ids, lens)
    state = t5m.init_decoder_state(cfg, params, enc, lens, T + 1)
    # decoder inputs: the start token, then the targets shifted right
    dec_in = torch.cat([torch.full((B, 1), cfg.start_id, dtype=dec_targets.dtype,
                                   device=dec_targets.device), dec_targets[:, :-1]], dim=1)
    nlls = []
    for t in range(T):
        logits, state = t5m.decode_step(cfg, params, state, dec_in[:, t], t)
        lp = torch.log_softmax(logits, dim=-1)
        nlls.append(-lp.gather(1, dec_targets[:, t: t + 1].long())[:, 0])
    return torch.stack(nlls).mean()


@torch.no_grad()
def eval_nll(cfg, params, held: np.ndarray, ctx: int) -> float:
    """Mean teacher-forced NLL (nats a byte) over the held-out windows of
    2 * ctx bytes."""
    dev = params["embed"].device
    W = 2 * ctx
    tot = torch.zeros((), dtype=torch.float64, device=dev)
    cnt = 0
    for s in range(0, len(held) - W, W):
        win = torch.from_numpy(held[s: s + W].astype(np.int64)).to(dev)
        tot += batch_loss(cfg, params, win[None, :ctx], win[None, ctx:]).double() * ctx
        cnt += ctx
    return float(tot) / cnt


def greedy_agreement(eng_a, eng_b, held, ctx, rng, n_prompts=8, out_len=48):
    """(matching tokens, compared tokens): each prompt's greedy tokens up to
    the first difference, as the JAX tool counts them."""
    agree = tot_toks = 0
    for _ in range(n_prompts):
        s = int(rng.integers(0, len(held) - ctx))
        prompt = [int(x) for x in held[s: s + ctx]]
        a = eng_a.generate([prompt], out_len)
        b = eng_b.generate([prompt], out_len)
        na = int(a.sequence_lengths[0, 0])
        for x, y in zip(a.output_ids[0, 0, :na], b.output_ids[0, 0, :na]):
            tot_toks += 1
            if x != y:
                break
            agree += 1
    return agree, tot_toks


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--ctx", type=int, default=96, help="enc and dec window")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--eval-bytes", type=int, default=8192)
    ap.add_argument("--corpus-extra", default="",
                    help="comma-separated extra source roots to enlarge the byte corpus")
    ap.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the CPU")

    extra = [r for r in args.corpus_extra.split(",") if r]
    data = load_tracked_corpus(str(REPO_ROOT), extra) + 2  # byte -> id
    split = len(data) - 4 * args.eval_bytes
    train, held = data[:split], data[split:]
    print(f"corpus {len(data) / 1e6:.1f}MB (held-out {len(held) / 1e3:.0f}KB)")

    cfg = proxy_config()
    params = init_t5_params(cfg, 0, dev)
    print(f"T5 proxy params: {sum(t.numel() for _, t in flatten(params)) / 1e6:.1f}M")
    opt = make_optimizer(params, betas=(0.9, 0.98))
    W = 2 * args.ctx
    rng = np.random.default_rng(0)
    t0 = time.time()
    for step in range(args.steps):
        starts = rng.integers(0, len(train) - W, size=args.batch)
        win = torch.from_numpy(np.stack([train[s: s + W] for s in starts]).astype(np.int64))
        win = win.to(dev)
        opt.param_groups[0]["lr"] = warmup_cosine(step, args.lr, 40, args.steps)
        opt.zero_grad(set_to_none=True)
        loss = batch_loss(cfg, params, win[:, : args.ctx], win[:, args.ctx:])
        loss.backward()
        opt.step()
        if step % 50 == 0 or step == args.steps - 1:
            print(f"step {step}: loss {float(loss.detach()):.3f} nats/byte ({time.time() - t0:.0f}s)",
                  flush=True)

    params = detached(params)
    qp = t5m.quantize_t5_params(params)
    nll_fp = eval_nll(cfg, params, held, args.ctx)
    nll_i8 = eval_nll(cfg, qp, held, args.ctx)
    agree, tot_toks = greedy_agreement(T5Engine(cfg, params), T5Engine(cfg, qp), held, args.ctx,
                                       rng)
    print(f"T5 proxy quality: fp32 NLL {nll_fp:.4f} | int8 NLL {nll_i8:.4f} "
          f"(dNLL {nll_i8 - nll_fp:+.4f}) | greedy agreement "
          f"{agree}/{tot_toks} = {agree / max(tot_toks, 1):.1%}", flush=True)


if __name__ == "__main__":
    main()
