#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. device, torch and CUDA versions, card name and power limit; build the
     CUDA kernels from ``fastertransformer4codefuse_tpu_torch/csrc``;
  2. each kernel (K1-K4, K6-K8, and K2/K3 on int4 weights) against its plain
     PyTorch version at CodeFuse-13B shapes: max error against the stated
     tolerance, median kernel and plain times (CUDA events, device time);
  3. 2-layer models of CodeFuse-13B width (int8; int4 per-channel; int4 with
     group size 128) built on the CPU and copied to the card: prefill and
     teacher-forced decode logits on the card (kernels) against the CPU
     (plain versions);
  4. CodeFuse-13B (40 layers, full width, int8 KV cache, random weights)
     built on the card, once with int8 weights and then with int4 weights,
     per-channel and group-wise (G = 128), and driven through
     ``GptNeoXEngine.generate`` and ``CodeFuseHandler.predict``; for each,
     the kernel launch counters are zeroed just before and checked just after
     against the counts its route must give.
The line before the last holds the kernels' JSON record; the last line is the
device record. Without a CUDA device, or without the package beside it, the
script exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))


def log(*a):
    print(*a, flush=True)


def fail(msg: str) -> int:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    return 1


class ByteTokenizer:
    """Bytes as token ids; ids past the ASCII range decode to nothing."""

    def encode(self, text):
        return list(text.encode("utf-8"))

    def decode(self, ids):
        return "".join(chr(int(i)) for i in ids if 0 <= int(i) < 128)

    def get_vocab(self):
        return {chr(i): i for i in range(32, 127)}


def device_time_ms(torch, fn, reps=5, calls=10):
    """Median over ``reps`` of the mean device time of ``calls`` back-to-back
    calls. A sleep kernel ahead of each window keeps the device busy while
    the host enqueues the calls, so the window holds device time only."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / calls)
    return statistics.median(out)


def rel_err(torch, got, ref):
    """(max |got - ref|, that over max |ref|), in fp32."""
    d = (got.float() - ref.float()).abs().max().item()
    return d, d / max(ref.float().abs().max().item(), 1e-30)


def phase_kernels(torch, records):
    from fastertransformer4codefuse_tpu_torch.ops.flash_decode import (
        flash_decode_stacked, flash_decode_stacked_plain,
    )
    from fastertransformer4codefuse_tpu_torch.ops.quant_matmul import (
        quant_matmul, quant_matmul_plain,
    )
    from fastertransformer4codefuse_tpu_torch.ops.quant_matmul_fused import (
        fused_proj_down, fused_proj_down_plain, fused_up_proj_down, fused_up_proj_down_plain,
    )
    from fastertransformer4codefuse_tpu_torch.ops.quant_matmul_w4 import (
        quant_matmul_w4, quant_matmul_w4_group, quant_matmul_w4_group_plain,
        quant_matmul_w4_head, quant_matmul_w4_head_plain, quant_matmul_w4_plain,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    H, F = 5120, 20480

    def i8(*shape):
        return torch.empty(shape, dtype=torch.int8, device=dev).random_(-128, 128, generator=gen)

    def scale(n):
        return torch.empty(n, device=dev).uniform_(0.5, 1.5, generator=gen) * (0.02 / 127)

    def bf(*shape, std=1.0):
        return (torch.randn(shape, device=dev, generator=gen) * std).to(torch.bfloat16)

    ok = True

    def report(name, case, fn_k, fn_p, tol, ms_key):
        nonlocal ok
        got, ref = fn_k(), fn_p()
        torch.cuda.synchronize()
        absd, rel = rel_err(torch, got, ref)
        finite = bool(torch.isfinite(got.float()).all())
        passed = finite and rel < tol
        ok &= passed
        t_k = device_time_ms(torch, fn_k)
        t_p = device_time_ms(torch, fn_p)
        log(f"  {name:18s} {case:34s} max_abs {absd:.3e} rel {rel:.2e} (tol {tol:g}) "
            f"{'ok' if passed else 'MISS'}  kernel {t_k:.4f} ms  plain {t_p:.4f} ms")
        r = records[name]
        r["max_abs_err"] = max(r["max_abs_err"], absd)
        if case == ms_key:
            r["ms"], r["plain_ms"] = t_k, t_p

    log("phase 2: kernels against their plain versions (CodeFuse-13B shapes)")
    # K1: bf16 output rounding (2^-8 relative) + fp32 summation order
    tol_mm = 1e-2
    shapes = [("qkv", H, 3 * H, True, None), ("up", H, F, True, "gelu-tanh"),
              ("down", F, H, False, None)]
    for tag, K, N, has_bias, act in shapes:
        w, s = i8(K, N), scale(N)
        b = bf(N, std=0.02) if has_bias else None
        for M in (1, 4, 512):
            x = bf(M, K)
            report("quant_matmul", f"{tag} {K}->{N} M={M}",
                   lambda: quant_matmul(x, w, s, b, act),
                   lambda: quant_matmul_plain(x, w, s, b, act), tol_mm, "qkv 5120->15360 M=1")
    w_up, w_proj, w_down = i8(H, F), i8(H, H), i8(F, H)
    s_up, s_proj, s_down = scale(F), scale(H), scale(H)
    b_up, b_down = bf(F, std=0.02), bf(H, std=0.02)
    for M in (1, 4):
        x_up, x_proj, res, h = bf(M, H), bf(M, H), bf(M, H), bf(M, F, std=0.5)
        report("fused_proj_down", f"proj+down M={M}",
               lambda: fused_proj_down(x_proj, h, w_proj, w_down, s_proj, s_down, b_down, res),
               lambda: fused_proj_down_plain(x_proj, h, w_proj, w_down, s_proj, s_down,
                                             b_down, res), tol_mm, "proj+down M=1")
        # the bf16 hidden may round differently in the two versions: 2e-2
        report("fused_up_proj_down", f"up+proj+down M={M}",
               lambda: fused_up_proj_down(x_up, x_proj, res, w_up, w_proj, w_down, s_up, s_proj,
                                          s_down, b_up, b_down, "gelu-tanh"),
               lambda: fused_up_proj_down_plain(x_up, x_proj, res, w_up, w_proj, w_down, s_up,
                                                s_proj, s_down, b_up, b_down, "gelu-tanh"),
               2e-2, "up+proj+down M=1")
    # K6/K7: bf16 output rounding + fp32 summation order
    def scale4(n):
        return torch.empty(n, device=dev).uniform_(0.5, 1.5, generator=gen) * (0.02 / 7)

    G = 128
    for tag, K, N, has_bias, act in shapes:
        p4, s4 = i8(K // 2, N), scale4(N)
        gs = (torch.empty(K // G, N, device=dev).uniform_(0.5, 1.5, generator=gen)
              * (0.02 / 7)).to(torch.bfloat16)
        b = bf(N, std=0.02) if has_bias else None
        for M in (1, 4, 512):
            x = bf(M, K)
            report("quant_matmul_w4", f"{tag} {K}->{N} M={M}",
                   lambda: quant_matmul_w4(x, p4, s4, b, act),
                   lambda: quant_matmul_w4_plain(x, p4, s4, b, act), tol_mm,
                   "qkv 5120->15360 M=1")
            report("quant_matmul_w4_group", f"{tag} {K}->{N} g{G} M={M}",
                   lambda: quant_matmul_w4_group(x, p4, gs, G, b, act),
                   lambda: quant_matmul_w4_group_plain(x, p4, gs, G, b, act), tol_mm,
                   "qkv 5120->15360 g128 M=1")
    # K8: fp32 logits; only the summation order differs
    Vp = 102400
    p_head, s_head = i8(H // 2, Vp), scale4(Vp)
    for M in (1, 4):
        x = bf(M, H)
        report("quant_matmul_w4_head", f"head {H}->{Vp} M={M}",
               lambda: quant_matmul_w4_head(x, p_head, s_head),
               lambda: quant_matmul_w4_head_plain(x, p_head, s_head), 1e-4,
               f"head {H}->{Vp} M=1")
    del p_head
    # K2/K3 on per-channel int4 weights (their records keep the int8 times)
    w_up, w_proj, w_down = i8(H // 2, F), i8(H // 2, H), i8(F // 2, H)
    s_up, s_proj, s_down = scale4(F), scale4(H), scale4(H)
    for M in (1, 4):
        x_up, x_proj, res, h = bf(M, H), bf(M, H), bf(M, H), bf(M, F, std=0.5)
        report("fused_proj_down", f"int4 proj+down M={M}",
               lambda: fused_proj_down(x_proj, h, w_proj, w_down, s_proj, s_down, b_down, res,
                                       bits=4),
               lambda: fused_proj_down_plain(x_proj, h, w_proj, w_down, s_proj, s_down,
                                             b_down, res, bits=4), tol_mm, "proj+down M=1")
        report("fused_up_proj_down", f"int4 up+proj+down M={M}",
               lambda: fused_up_proj_down(x_up, x_proj, res, w_up, w_proj, w_down, s_up, s_proj,
                                          s_down, b_up, b_down, "gelu-tanh", bits=4),
               lambda: fused_up_proj_down_plain(x_up, x_proj, res, w_up, w_proj, w_down, s_up,
                                                s_proj, s_down, b_up, b_down, "gelu-tanh",
                                                bits=4),
               2e-2, "up+proj+down M=1")
    # K4: p rounded to bf16 before PV in both; online vs full softmax order
    B, nH, dh, S, L = 4, 40, 128, 1152, 2
    pos = torch.tensor([10, S - 1, 500, 777], dtype=torch.int32, device=dev)
    q = bf(B, nH, dh)
    k8, v8 = i8(L, B, nH, S, dh), i8(L, B, nH, S, dh)
    ks = (torch.rand((L, B, nH, S), device=dev, generator=gen) * 0.02).to(torch.bfloat16)
    vs = (torch.rand((L, B, nH, S), device=dev, generator=gen) * 0.02).to(torch.bfloat16)
    kb, vb = bf(L, B, nH, S, dh), bf(L, B, nH, S, dh)
    sm = 1.0 / dh ** 0.5
    report("flash_decode", "int8 cache B=4 S=1152",
           lambda: flash_decode_stacked(q, k8, ks, v8, vs, 1, pos, sm),
           lambda: flash_decode_stacked_plain(q, k8, ks, v8, vs, 1, pos, sm), 2e-2,
           "int8 cache B=4 S=1152")
    report("flash_decode", "bf16 cache B=4 S=1152",
           lambda: flash_decode_stacked(q, kb, None, vb, None, 1, pos, sm),
           lambda: flash_decode_stacked_plain(q, kb, None, vb, None, 1, pos, sm), 2e-2,
           "int8 cache B=4 S=1152")
    return ok


def phase_reference(torch, pkg, **quant):
    """2 layers at CodeFuse-13B width: card (kernels) vs CPU (plain).
    ``quant``: init_params' weight_bits and group_size. Returns max |dlogits|
    / max |logits| after the prefill and after each decode step."""
    from fastertransformer4codefuse_tpu_torch.engine import kv_cache
    from fastertransformer4codefuse_tpu_torch.models import gptneox as model
    from fastertransformer4codefuse_tpu_torch.models.params import params_to

    cfg = pkg.GptNeoXConfig(**{**pkg.GptNeoXConfig.codefuse_13b().__dict__, "layer_num": 2})
    p_cpu = pkg.init_params(cfg, seed=7, dtype="bf16", int8_mode=1, quantize_embeddings=True,
                            **quant)
    p_gpu = params_to(p_cpu, "cuda")
    rng = np.random.default_rng(7)
    B, S, steps = 2, 64, 3
    ids = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int64)
    lens = np.array([S, S - 17], np.int32)
    logits = {}
    for name, p, dev in (("card", p_gpu, "cuda"), ("cpu", p_cpu, "cpu")):
        cache = kv_cache.init_cache(cfg, B, S + steps + 1, torch.int8, dev)
        t_ids = torch.from_numpy(ids).to(dev)
        t_lens = torch.from_numpy(lens).to(dev)
        hidden, cache = model.prefill(cfg, p, t_ids, t_lens, cache)
        out = [model.lm_logits(cfg, p, model.last_token_hidden(hidden, t_lens))]
        for st in range(steps):
            tok = torch.from_numpy(ids[:, st]).to(dev)  # teacher-forced tokens
            positions = (t_lens + st).to(torch.int32)
            h, cache = model.decode_step(cfg, p, tok, positions, cache)
            out.append(model.lm_logits(cfg, p, h))
        logits[name] = [o.float().cpu() for o in out]
    rels = []
    for i, (a, b) in enumerate(zip(logits["card"], logits["cpu"])):
        if not bool(torch.isfinite(a).all()) or a.shape != (B, cfg.vocab_size):
            raise RuntimeError(f"reference step {i}: bad logits {a.shape}")
        rels.append(rel_err(torch, a, b)[1])
    return rels


def main() -> int:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args()
    import torch

    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    sys.path.insert(0, REPO)
    try:
        import fastertransformer4codefuse_tpu_torch as pkg
    except ImportError as e:
        return fail(f"the port's package is not beside this script: {e}")
    from fastertransformer4codefuse_tpu_torch.ops import _cuda
    from fastertransformer4codefuse_tpu_torch.ops.flash_decode import flash_decode_stacked
    from fastertransformer4codefuse_tpu_torch.ops.quant_matmul import quant_matmul
    from fastertransformer4codefuse_tpu_torch.ops.quant_matmul_fused import (
        fused_proj_down, fused_up_proj_down,
    )
    from fastertransformer4codefuse_tpu_torch.ops.quant_matmul_w4 import (
        quant_matmul_w4, quant_matmul_w4_group, quant_matmul_w4_head,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log("phase 1: device")
    log(f"  device {kind} x{torch.cuda.device_count()}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    log(f"  nvidia-smi: {smi}")
    t0 = time.time()
    lib_path = _cuda.build()
    _cuda.lib()
    log(f"  kernels built in {time.time() - t0:.1f} s -> {os.path.relpath(lib_path, REPO)}")
    for line in _cuda.build_log.splitlines():
        if "registers" in line or ("spill" in line and "0 bytes spill stores" not in line):
            log("   ", line.strip())

    src = "fastertransformer4codefuse_tpu_torch/csrc/"
    tpu = "fastertransformer4codefuse_tpu/ops/"
    kernels = {
        "quant_matmul": (quant_matmul, src + "quant_matmul.cu", tpu + "quant_matmul.py:139"),
        "fused_up_proj_down": (fused_up_proj_down, src + "quant_matmul_fused.cu",
                               tpu + "quant_matmul_fused.py:434"),
        "fused_proj_down": (fused_proj_down, src + "quant_matmul_fused.cu",
                            tpu + "quant_matmul_fused.py:280"),
        "flash_decode": (flash_decode_stacked, src + "flash_decode.cu",
                         tpu + "flash_decode.py:593"),
        "quant_matmul_w4": (quant_matmul_w4, src + "quant_matmul_w4.cu",
                            tpu + "quant_matmul_w4.py:204"),
        "quant_matmul_w4_group": (quant_matmul_w4_group, src + "quant_matmul_w4.cu",
                                  tpu + "quant_matmul_w4.py:315"),
        "quant_matmul_w4_head": (quant_matmul_w4_head, src + "quant_matmul_w4.cu",
                                 tpu + "quant_matmul_w4.py:82"),
    }
    records = {
        n: {"name": n, "route": "cuda", "source": s, "replaces": r, "launches": 0,
            "max_abs_err": 0.0, "ms": None, "plain_ms": None}
        for n, (_, s, r) in kernels.items()
    }
    if not phase_kernels(torch, records):
        return fail("a kernel disagrees with its plain version")

    log("phase 3: 2-layer CodeFuse-13B-width models, card (kernels) vs CPU (plain)")
    tol_ref = 5e-2
    for label, quant in CONFIGS:
        rels = phase_reference(torch, pkg, **quant)
        log(f"  {label}: max |dlogits| / max |logits| after prefill and 3 teacher-forced "
            f"decode steps: {', '.join(f'{r:.2e}' for r in rels)} (tol {tol_ref:g})")
        if max(rels) >= tol_ref:
            return fail(f"{label}: card and CPU logits disagree")

    launched = {n: 0 for n in kernels}
    for label, quant in CONFIGS:
        log(f"phase 4: CodeFuse-13B {label} (40 layers, int8 KV) on the card")
        err = phase_serve(torch, pkg, quant, kernels, launched)
        if err:
            return fail(f"{label}: {err}")
    for n in records:
        records[n]["launches"] = launched[n]
    if not all(launched.values()):
        return fail(f"a kernel was never launched by the main path: {launched}")
    print(smi, flush=True)
    print(json.dumps({"kernels": list(records.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


# (label, init_params quantization): the served configurations
CONFIGS = [
    ("int8", dict(weight_bits=8, group_size=0)),
    ("int4 per-channel", dict(weight_bits=4, group_size=0)),
    ("int4 g128", dict(weight_bits=4, group_size=128)),
]


def expected_launches(L, prefills, forwards, weight_bits, group_size):
    """Launches each kernel wrapper must count for a run of ``prefills``
    prefills and ``forwards`` decode forwards of an L-layer CodeFuse model
    (parallel residual, tanh-gelu, biases): prefill runs QKV, proj, up and
    down as GEMMs; decode runs QKV as a GEMM and the post-attention block as
    K2 (which calls K3) for per-channel weights, or all four GEMMs as K7 for
    group-wise int4; every prefill and forward ends in one LM head call."""
    gemm = {8: "quant_matmul", 4: "quant_matmul_w4"}[weight_bits]
    out = {"flash_decode": L * forwards}
    if group_size:
        out["quant_matmul_w4_group"] = L * 4 * (prefills + forwards)
    else:
        out[gemm] = L * (4 * prefills + forwards)
        out["fused_up_proj_down"] = out["fused_proj_down"] = L * forwards
    if weight_bits == 4:
        out["quant_matmul_w4_head"] = prefills + forwards
    return out


def phase_serve(torch, pkg, quant, kernels, launched):
    """Serve CodeFuse-13B with ``quant`` weights through engine and handler;
    returns an error message, or None. Adds this run's launches to
    ``launched``."""
    import gc

    from fastertransformer4codefuse_tpu_torch.api.handler import CodeFuseHandler
    from fastertransformer4codefuse_tpu_torch.api.trie import VocabTrie
    from fastertransformer4codefuse_tpu_torch.models.params import param_bytes

    cfg = pkg.GptNeoXConfig.codefuse_13b()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    params = pkg.init_params(cfg, seed=0, dtype="bf16", int8_mode=1, quantize_embeddings=True,
                             device="cuda", **quant)
    torch.cuda.synchronize()
    log(f"  params {param_bytes(params) / 2**30:.2f} GiB built in {time.time() - t0:.1f} s")
    engine = pkg.GptNeoXEngine(
        cfg, params, pkg.RuntimeConfig(dtype="bf16", int8_mode=1, kv_cache_dtype="int8")
    )
    V = cfg.vocab_size
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, V, 1000).tolist()
    tok = ByteTokenizer()
    streamed_text = []
    handler = CodeFuseHandler(engine=engine, tokenizer=tok, trie=VocabTrie(tok.get_vocab()),
                              warmup=False, on_stream_text=lambda b, j, s: streamed_text.append(s))

    for fn, _, _ in kernels.values():
        fn.launches = 0
    forwards = 0
    prefills = 0

    def run(*a, **kw):
        nonlocal forwards, prefills
        torch.cuda.synchronize()
        t = time.time()
        out = engine.generate(*a, **kw)
        torch.cuda.synchronize()
        forwards += engine.decode_forwards
        prefills += 1
        return out, time.time() - t, engine.decode_forwards

    _, t_pre, _ = run([prompt], 1, top_k=1)
    g1, t1, f1 = run([prompt], 64, top_k=1, return_cum_log_probs=True)
    g2, t2, f2 = run([prompt], 64, top_k=1, return_cum_log_probs=True)
    if not np.array_equal(g1.output_ids, g2.output_ids):
        return "greedy generation is not deterministic"
    gen = g1.output_ids[0, 0, 1000:g1.sequence_lengths[0, 0]]
    if (gen < 0).any() or (gen >= V).any():
        return "greedy ids out of range"
    # the cumulative log-prob takes a log-softmax over all V logits each step:
    # finite only if every logit was finite
    if not np.isfinite(g1.cum_log_probs).all():
        return "non-finite logits"
    step_ms = (min(t1, t2) - t_pre) / max(f1, 1) * 1e3
    log(f"  B=1 1000-token prompt, 64 greedy tokens x2: identical, {f1} decode forwards, "
        f"prefill {t_pre * 1e3:.1f} ms, decode {step_ms:.2f} ms/step")

    streamed = []
    g3, _, _ = run([prompt], 64, top_k=1, callback=lambda m: streamed.append(m["last_tokens"][0][0]))
    gen1 = g1.output_ids[0, 0, 1000:1000 + len(streamed)].tolist()
    if streamed != gen1 or not np.array_equal(g3.output_ids, g1.output_ids):
        return "streamed tokens differ from the non-streamed greedy ones"
    log(f"  streamed {len(streamed)} tokens == non-streamed greedy tokens")

    lens = [100, 367, 633, 900]
    prompts = [rng.integers(0, V, n).tolist() for n in lens]
    kw = dict(top_k=40, top_p=0.9, temperature=0.8, repetition_penalty=1.1,
              random_seed=[11, 22, 33, 44], return_cum_log_probs=True)
    _, t_pre4, _ = run(prompts, 1, **kw)
    s1, ts, fs = run(prompts, 32, **kw)
    s2, _, _ = run(prompts, 32, **kw)
    for b, n in enumerate(lens):
        gen = s1.output_ids[b, 0, n:s1.sequence_lengths[b, 0]]
        if (gen < 0).any() or (gen >= V).any():
            return f"sampled ids out of range in row {b}"
    if not np.array_equal(s1.output_ids, s2.output_ids):
        return "sampling with per-row seeds is not reproducible"
    if not np.isfinite(s1.cum_log_probs).all():
        return "non-finite sampled log-probs"
    step4_ms = (ts - t_pre4) / max(fs, 1) * 1e3
    log(f"  B=4 ragged prompts {lens}, 32 sampled tokens (top_k 40, top_p 0.9, T 0.8, "
        f"rep 1.1, seeds) x2: reproducible, {fs} decode forwards, prefill "
        f"{t_pre4 * 1e3:.1f} ms, decode {step4_ms:.2f} ms/step")

    text = "def quick_sort(arr):\n    " * 20
    req = {"prompts": [{"prompt": text, "top_k": 1, "random_seed": 5}], "out_seq_length": 32}
    responses = []
    for stream in (False, True):
        r = dict(req, stream=stream)
        code, msg, res = handler.predict(r, f"smoke-{int(stream)}")
        forwards += engine.decode_forwards
        prefills += 1
        if code != 0:
            return f"handler request failed: {msg}"
        responses.append(json.loads(res["res"]))
    for key in ("generated_code", "length", "cum_log_prob"):
        if responses[0][key] != responses[1][key]:
            return f"streamed handler response differs in {key}"
    if "".join(streamed_text) != responses[0]["generated_code"][0][0]:
        return "streamed text differs from the non-streamed response"
    req3 = {"prompts": [
        {"prompt": "import numpy as np\n", "top_k": 40, "top_p": 0.9, "temperature": 0.8,
         "repetition_penalty": 1.1, "random_seed": 7, "stop_words": ["\n\n"]},
        {"prompt": "class Tree:\n    def ", "top_k": 40, "top_p": 0.9, "temperature": 0.8,
         "repetition_penalty": 1.1, "random_seed": 8, "stop_words": ["\n\n"]},
    ], "out_seq_length": 32}
    code, msg, res = handler.predict(req3, "smoke-3")
    forwards += engine.decode_forwards
    prefills += 1
    if code != 0:
        return f"handler request failed: {msg}"
    r3 = json.loads(res["res"])
    if len(r3["generated_code"]) != 2 or any(n[0] > 32 for n in r3["length"]):
        return f"bad handler response {r3}"
    log(f"  handler: greedy, streamed (== greedy) and a 2-prompt sampled request answered; "
        f"lengths {[responses[0]['length'], r3['length']]}")

    torch.cuda.synchronize()
    counts = {n: fn.launches for n, (fn, _, _) in kernels.items()}
    expect = {n: 0 for n in kernels}
    expect.update(expected_launches(cfg.layer_num, prefills, forwards, **quant))
    log(f"  {prefills} prefills, {forwards} decode forwards; launches {counts}, "
        f"expected {expect}")
    if counts != expect:
        return "kernel launch counts do not match the forwards run"
    for n, c in counts.items():
        launched[n] += c
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  peak device memory {peak:.2f} GiB; decode {step_ms:.2f} ms/step at B=1, "
        f"{step4_ms:.2f} ms/step at B=4; prefill {t_pre * 1e3:.1f} ms (1000 tokens)")
    return None  # the model is freed with this frame, before the next one is built


if __name__ == "__main__":
    sys.exit(main())
