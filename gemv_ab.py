#!/usr/bin/env python3
"""Time the port's weight-only GEMVs, its prefill-width GEMM, K10, the
decode attention kernels K4/K9/K11 at CodeFuse-13B shapes, and the prefill
attention body of K5 and K12, on one NVIDIA GPU, for an A/B of two copies
of the port on one card.

    python3 gemv_ab.py [--root DIR] [--label NAME]
                       [--kernels gemv,gemm,k10,decode,band,k5bwd,mma] [--widths 1,4,8]
                       [--may-refuse]

``--root`` is the directory that holds the ``fastertransformer4codefuse_tpu_torch``
package to time (default: the one beside this script), so one call can time
an unpacked copy of another commit, in turns with this one (parent, tree,
tree, parent). ``--kernels`` picks the groups of cases:

- ``gemv`` (the default): K1, K3, K6, K7, K8 and K13's GEMV form at the
  ``--widths`` (M <= 32), with ``torch._weight_int4pack_mm`` on the QKV
  shape beside at every width above 1;
- ``gemm``: the prefill-width GEMM (M > 32): K13 int8 and int4 g128 at
  M = 512, 1024 and 3072, K1 proj (5120 -> 5120) and down (20480 -> 5120)
  at 1024 and 3072, K6 and K7 QKV at 1024, K8's head at 64;
- ``k10``: chunked-prefill attention over pages (B = 8 rows of C = 128
  queries starting at 0 .. 1920, 40 heads x 128) on int8, packed int4 and
  bf16 pages of 256, and int8 pages of 128;
- ``decode``: the decode attention cases of ``chip_smoke.py`` phase 2: K4 on
  int8, bf16, "int4" and "int8k_int4v" caches (B = 4, S = 1152, 40 x 128
  heads), int8 at B = 1, S = 4096, GQA g = 8 (40 query heads) and g = 48
  (48 x 128, one KV head), and 80 x 64 heads on 80 KV heads and on one; K9 on int8, bf16, "int4" and
  "int8k_int4v" pages of 256 (8 slots, positions 100-2000), and g = 8 and
  48; K11 on int8, bf16 and "int4" (2 x 4 beams, S = 1152). With
  ``--may-refuse`` (for an older copy, whose kernels took fewer shapes) a
  case the copy's kernel does not take prints its refusal instead of a time;
  without it a refusal is a miss;
- ``band``: K12 at Longformer-base's shape (B = 2, S = 4096, 12 x 64 heads,
  w_half 256, lengths 4096 and 2900), the band and the causal band, and K5
  at ``chip_smoke.py`` phase 2's cases (B = 1, S = 4096, 40 x 128; B = 2,
  S = 2048, lengths 2048 and 1300; B = 1, S = 4096, 32 x 64);
- ``k5bwd``: K5's fp32 backward, the dK/dV and dQ kernels, at
  ``chip_smoke.py`` phase 12's timed shapes (B = 1, S = 2048, 40 x 128;
  proxy85m's B = 8, S = 2048, 12 x 64) and GQA (32 query heads on 8), from
  the fp32 forward's lse and delta = rowsum(dO * O), held to their plain
  version within 1e-4; beside each shape SDPA's fp32 causal backward alone
  (its forward once, ``torch.autograd.grad`` of the output timed);
- ``mma``: the card's ``mma.sync`` rate, the ceiling of the kernels built
  on it: m16n8k8 TF32 (the 3xTF32 products of K5's backward) and m16n8k16
  bf16, each warp looping over 1, 4 or 8 independent accumulators, 4 to 16
  warps a block, 8 blocks an SM (a source of its own, built by ``nvcc``
  into ``build/mma_rate``; no check, TFLOP/s instead of ms).

Each case is checked against its plain version (max |kernel - plain| / max
|plain| below 1e-2 for the GEMMs, 2e-2 per (query, head) row for the
attention kernels) and timed as
``chip_smoke.py`` times its kernels (CUDA events, median of 5 windows of 10
calls, a sleep kernel ahead of each window). Prints one JSON object a line,
the card's name and power limit first; exits non-zero without a card or on
a miss.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from chip_smoke import device_time_ms


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--kernels", default="gemv")
    ap.add_argument("--widths", default="1,4,8")
    ap.add_argument("--may-refuse", action="store_true",
                    help="a decode case the copy's kernel refuses is logged, not a miss")
    args = ap.parse_args()
    groups = set(args.kernels.split(","))
    if not groups <= {"gemv", "gemm", "k10", "decode", "band", "k5bwd", "mma"}:
        print("gemv_ab: --kernels takes gemv, gemm, k10, decode, band, k5bwd and mma, got "
              f"{args.kernels}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("gemv_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from fastertransformer4codefuse_tpu_torch.ops import _cuda
    from fastertransformer4codefuse_tpu_torch.ops.attention import (
        prefill_attention_flash, prefill_attention_flash_plain, prefill_flash_bwd_dkv,
        prefill_flash_bwd_dq, prefill_flash_bwd_plain, prefill_flash_forward,
    )
    from fastertransformer4codefuse_tpu_torch.ops.flash_decode import (
        flash_chunk_paged, flash_chunk_paged_plain, flash_decode_beam_plain,
        flash_decode_beam_stacked, flash_decode_paged, flash_decode_paged_plain,
        flash_decode_stacked, flash_decode_stacked_plain,
    )
    from fastertransformer4codefuse_tpu_torch.ops.quant_matmul import (
        quant_matmul, quant_matmul_plain,
    )
    from fastertransformer4codefuse_tpu_torch.ops.quant_matmul_fused import (
        fused_proj_down, fused_proj_down_plain, fused_qkv_up, fused_qkv_up_plain,
    )
    from fastertransformer4codefuse_tpu_torch.ops.quant_matmul_w4 import (
        quant_matmul_w4, quant_matmul_w4_group, quant_matmul_w4_group_plain,
        quant_matmul_w4_head, quant_matmul_w4_head_plain, quant_matmul_w4_plain,
    )
    from fastertransformer4codefuse_tpu_torch.ops.sliding_window import (
        sliding_window_attention, sliding_window_attention_plain,
    )

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    _cuda.lib()
    print(json.dumps({"label": args.label, "card": card, "root": args.root}), flush=True)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    H, F, V = 5120, 20480, 102400
    ok = True

    def i8(*shape):
        return torch.empty(shape, dtype=torch.int8, device=dev).random_(-128, 128, generator=gen)

    def bf(*shape, std=1.0):
        return (torch.randn(shape, device=dev, generator=gen) * std).to(torch.bfloat16)

    def scale(n, qmax):
        return torch.empty(n, device=dev).uniform_(0.5, 1.5, generator=gen) * (0.02 / qmax)

    def gscale(k, n, qmax, dtype, G=128):
        return scale((k // G, n), qmax).to(dtype)

    def row_rel(g, r):  # each (query, head) row of attention held to its own magnitude
        d = (g.float() - r.float()).abs()
        return (d.amax(-1) / r.float().abs().amax(-1).clamp_min(1e-30)).max().item()

    def run(name, M, kernel, plain, a, tol=1e-2, rel_of=None):
        nonlocal ok
        got, ref = kernel(*a), plain(*a)
        if isinstance(got, tuple):
            got, ref = torch.cat(got, 1), torch.cat(ref, 1)
        rel = (rel_of or (lambda g, r: ((g.float() - r.float()).abs().max()
                                        / r.float().abs().max()).item()))(got, ref)
        ok &= rel < tol
        del got, ref
        print(json.dumps({"label": args.label, "case": name, "M": M,
                          "ms": device_time_ms(torch, lambda: kernel(*a)), "rel": rel}),
              flush=True)

    bf16, f32 = torch.bfloat16, torch.float32
    if "gemv" in groups or "gemm" in groups:
        w8q, s8q, w4q, s4q = i8(H, 3 * H), scale(3 * H, 127), i8(H // 2, 3 * H), scale(3 * H, 7)
        g4q = gscale(H, 3 * H, 7, bf16)
        w8u, s8u, w4u, s4u = i8(H, F), scale(F, 127), i8(H // 2, F), scale(F, 7)
        g4u = gscale(H, F, 7, bf16)
        w8p, w8d, s8p, s8d = i8(H, H), i8(F, H), scale(H, 127), scale(H, 127)
        bq, bu, bd = bf(3 * H, std=0.02), bf(F, std=0.02), bf(H, std=0.02)
        wh, sh = i8(H // 2, V), scale(V, 7)
        act = "gelu-tanh"
    if "gemv" in groups:
        w4p, w4d, s4p, s4d = i8(H // 2, H), i8(F // 2, H), scale(H, 7), scale(H, 7)
        g4p, g4d, g8p, g8d = (gscale(H, H, 7, bf16), gscale(F, H, 7, bf16),
                              gscale(H, H, 127, f32), gscale(F, H, 127, f32))
        lib_w = torch._convert_weight_to_int4pack(
            torch.randint(0, 256, (3 * H, H // 2), dtype=torch.uint8, device=dev,
                          generator=gen), 8)
        for M in (int(w) for w in args.widths.split(",")):
            x1, x2, h, res = bf(M, H), bf(M, H), bf(M, F, std=0.5), bf(M, H)
            cases = {
                "K1 qkv": (quant_matmul, quant_matmul_plain, (x1, w8q, s8q, bq)),
                "K6 qkv": (quant_matmul_w4, quant_matmul_w4_plain, (x1, w4q, s4q, bq)),
                "K7 qkv g128": (quant_matmul_w4_group, quant_matmul_w4_group_plain,
                                (x1, w4q, g4q, 128, bq)),
                "K8 head": (quant_matmul_w4_head, quant_matmul_w4_head_plain, (x1, wh, sh)),
                "K13 int8": (fused_qkv_up, fused_qkv_up_plain,
                             (x1, x2, w8q, w8u, s8q, s8u, bq, bu, None, act, 8, 0)),
                "K13 int4": (fused_qkv_up, fused_qkv_up_plain,
                             (x1, x2, w4q, w4u, s4q, s4u, bq, bu, None, act, 4, 0)),
                "K13 int4 g128": (fused_qkv_up, fused_qkv_up_plain,
                                  (x1, x2, w4q, w4u, g4q, g4u, bq, bu, None, act, 4, 128)),
                "K3 int8": (fused_proj_down, fused_proj_down_plain,
                            (x1, h, w8p, w8d, s8p, s8d, bd, res, 8, 0)),
                "K3 int4": (fused_proj_down, fused_proj_down_plain,
                            (x1, h, w4p, w4d, s4p, s4d, bd, res, 4, 0)),
                "K3 int4 g128": (fused_proj_down, fused_proj_down_plain,
                                 (x1, h, w4p, w4d, g4p, g4d, bd, res, 4, 128)),
                "K3 int8 g128": (fused_proj_down, fused_proj_down_plain,
                                 (x1, h, w8p, w8d, g8p, g8d, bd, res, 8, 128)),
            }
            for name, (kernel, plain, a) in cases.items():
                run(name, M, kernel, plain, a)
            if M > 1:
                sz = torch.ones(H // 128, 3 * H, 2, dtype=bf16, device=dev)
                print(json.dumps({"label": args.label, "case": "_weight_int4pack_mm qkv g128",
                                  "M": M, "ms": device_time_ms(
                                      torch, lambda: torch._weight_int4pack_mm(x1, lib_w, 128,
                                                                               sz))}),
                      flush=True)
        del w4p, w4d, lib_w
    if "gemm" in groups:
        for M in (512, 1024, 3072):
            x1, x2 = bf(M, H), bf(M, H)
            run("K13 int8", M, fused_qkv_up, fused_qkv_up_plain,
                (x1, x2, w8q, w8u, s8q, s8u, bq, bu, None, act, 8, 0))
            run("K13 int4 g128", M, fused_qkv_up, fused_qkv_up_plain,
                (x1, x2, w4q, w4u, g4q, g4u, bq, bu, None, act, 4, 128))
            if M == 512:
                continue
            h = bf(M, F, std=0.5)
            run("K1 proj", M, quant_matmul, quant_matmul_plain, (x1, w8p, s8p, bd))
            run("K1 down", M, quant_matmul, quant_matmul_plain, (h, w8d, s8d, bd))
            if M == 1024:
                run("K6 qkv", M, quant_matmul_w4, quant_matmul_w4_plain, (x1, w4q, s4q, bq))
                run("K7 qkv g128", M, quant_matmul_w4_group, quant_matmul_w4_group_plain,
                    (x1, w4q, g4q, 128, bq))
            del x1, x2, h
        x = bf(64, H)
        run("K8 head", 64, quant_matmul_w4_head, quant_matmul_w4_head_plain, (x, wh, sh),
            tol=1e-4)
    if "k10" in groups:
        B, nKV, dh, C, L = 8, 40, 128, 128, 2
        starts = torch.tensor([0, 128, 384, 640, 896, 1152, 1536, 1920], dtype=torch.int32,
                              device=dev)
        q = bf(B, C, nKV, dh)

        for ps in (256, 128):
            n_pg = 2048 // ps
            P = B * n_pg + 1
            pt = (torch.randperm(P - 1, device=dev, generator=gen) + 1).reshape(
                B, n_pg).to(torch.int32)
            sk = (torch.rand((L, P, nKV, ps), device=dev, generator=gen) * 0.02).to(bf16)
            sv = (torch.rand((L, P, nKV, ps), device=dev, generator=gen) * 0.02).to(bf16)
            pk8, pv8 = i8(L, P, nKV, ps, dh), i8(L, P, nKV, ps, dh)
            kinds = [("int8", (pk8, sk, pv8, sv))]
            if ps == 256:
                kinds += [("int4", (i8(L, P, nKV, ps // 2, dh), sk, i8(L, P, nKV, ps // 2, dh),
                                    sv)),
                          ("bf16", (bf(L, P, nKV, ps, dh), None, bf(L, P, nKV, ps, dh), None))]
            for tag, (a, sa, b_, sb) in kinds:
                run(f"K10 {tag} pages of {ps}", B * C, flash_chunk_paged,
                    flash_chunk_paged_plain, (q, a, sa, b_, sb, 1, starts, pt, dh ** -0.5),
                    tol=2e-2, rel_of=row_rel)
            del kinds, pk8, pv8, a, b_
    if "decode" in groups:
        L = 2

        def attn(name, M, kernel, plain, a):
            nonlocal ok
            try:
                run(name, M, kernel, plain, a, tol=2e-2, rel_of=row_rel)
            except ValueError as e:  # a shape this copy's kernel does not take
                print(json.dumps({"label": args.label, "case": name, "M": M,
                                  "refused": str(e)}), flush=True)
                ok &= args.may_refuse

        def cache(X, nKV, n, dh, kind):  # (k, ks, v, vs) over n positions
            sc = [(torch.rand((L, X, nKV, n), device=dev, generator=gen) * 0.02).to(bf16)
                  for _ in range(2)]
            if kind == "bf16":
                return bf(L, X, nKV, n, dh), None, bf(L, X, nKV, n, dh), None
            k = i8(L, X, nKV, n // 2 if kind == "int4" else n, dh)
            v = i8(L, X, nKV, n if kind == "int8" else n // 2, dh)
            return k, sc[0], v, sc[1]

        for B, S, nH, nKV, dh, kinds in (
                (4, 1152, 40, 40, 128, ("int8", "bf16", "int4", "int8k_int4v")),
                (1, 4096, 40, 40, 128, ("int8",)), (4, 1152, 40, 5, 128, ("int8", "bf16")),
                (4, 1152, 48, 1, 128, ("int8", "bf16")), (4, 1152, 80, 80, 64, ("int8",)),
                (4, 1152, 80, 1, 64, ("int8",))):
            pos = torch.tensor([10, S - 1, 500, 777][:B] if B > 1 else [S - 1],
                               dtype=torch.int32, device=dev)
            q = bf(B, nH, dh)
            for kind in kinds:
                a = (q, *cache(B, nKV, S, dh, kind), 1, pos, dh ** -0.5)
                attn(f"K4 {kind} B={B} S={S} {nH}x{dh} g={nH // nKV}", B,
                     flash_decode_stacked, flash_decode_stacked_plain, a)
                del a
        B, ps, n_pg = 8, 256, 8
        P = B * n_pg + 1
        pt = (torch.randperm(P - 1, device=dev, generator=gen) + 1).reshape(B, n_pg).to(
            torch.int32)
        pos = torch.tensor([100, 371, 642, 914, 1185, 1457, 1728, 2000], dtype=torch.int32,
                           device=dev)
        for nH, nKV, kinds in ((40, 40, ("int8", "bf16", "int4", "int8k_int4v")),
                               (40, 5, ("int8",)), (48, 1, ("int8",))):
            q = bf(B, nH, 128)
            for kind in kinds:
                a = (q, *cache(P, nKV, ps, 128, kind), 1, pos, pt, 128 ** -0.5)
                attn(f"K9 {kind} pages B=8 pos 100-2000 {nH}x128 g={nH // nKV}", B,
                     flash_decode_paged, flash_decode_paged_plain, a)
                del a
        BB, bw, S = 8, 4, 1152
        pos = torch.tensor([1151, 700, 1000, 64, 900, 333, 1100, 512], dtype=torch.int32,
                           device=dev)
        indir = torch.randint(0, bw, (BB, S), generator=gen, device=dev, dtype=torch.int32)
        q = bf(BB, 40, 128)
        for kind in ("int8", "bf16", "int4"):
            a = (q, *cache(BB, 40, S, 128, kind), 1, pos, indir, bw, 128 ** -0.5)
            attn(f"K11 {kind} B=2 bw=4 S=1152", BB, flash_decode_beam_stacked,
                 flash_decode_beam_plain, a)
            del a
    if "band" in groups:
        B, S, nH, dh, w = 2, 4096, 12, 64, 256
        q, k, v = bf(B, S, nH, dh, std=dh ** -0.5), bf(B, S, nH, dh), bf(B, S, nH, dh)
        masked = torch.arange(S, device=dev)[None, :] >= torch.tensor(
            [4096, 2900], device=dev)[:, None]
        for causal in (False, True):
            run(f"K12 {'causal band' if causal else 'band'} B=2 S=4096 12x64 w=256 "
                "lengths 4096/2900", B * S,
                lambda *a, c=causal: sliding_window_attention(*a, causal=c),
                lambda *a, c=causal: sliding_window_attention_plain(*a, causal=c),
                (q, k, v, w, masked), tol=2e-2, rel_of=row_rel)
        del q, k, v
        for B, S, lens, nH, dh in ((1, 4096, [4096], 40, 128), (2, 2048, [2048, 1300], 40, 128),
                                   (1, 4096, [4096], 32, 64)):
            q, k, v = bf(B, S, nH, dh), bf(B, S, nH, dh), bf(B, S, nH, dh)
            ln = torch.tensor(lens, dtype=torch.int32, device=dev)
            run(f"K5 B={B} S={S} {nH}x{dh} lengths {lens}", B * S, prefill_attention_flash,
                prefill_attention_flash_plain, (q, k, v, ln, dh ** -0.5), tol=2e-2,
                rel_of=row_rel)
            del q, k, v
    if "k5bwd" in groups:
        import torch.nn.functional as F

        for B, S, nH, nKV, dh in ((1, 2048, 40, 40, 128), (8, 2048, 12, 12, 64),
                                  (1, 2048, 32, 8, 128)):
            q, ct = (torch.randn(B, S, nH, dh, device=dev, generator=gen) for _ in range(2))
            k, v = (torch.randn(B, S, nKV, dh, device=dev, generator=gen) for _ in range(2))
            ln = torch.full((B,), S, dtype=torch.int32, device=dev)
            sm = dh ** -0.5
            out, lse = prefill_flash_forward(q, k, v, ln, sm)
            a = (q, k, v, ct, lse, (ct * out).sum(-1).transpose(1, 2).contiguous(), ln, sm)
            shape = f"B={B} S={S} {nH}x{dh} on {nKV} KV heads"
            run(f"K5 fp32 dK/dV {shape}", B * S, prefill_flash_bwd_dkv,
                lambda *x: prefill_flash_bwd_plain(*x)[1:], a, tol=1e-4)
            run(f"K5 fp32 dQ {shape}", B * S, prefill_flash_bwd_dq,
                lambda *x: prefill_flash_bwd_plain(*x)[0], a, tol=1e-4)
            leaves = [t.transpose(1, 2).clone().requires_grad_() for t in (q, k, v)]
            y = F.scaled_dot_product_attention(*leaves, is_causal=True, scale=sm,
                                               enable_gqa=nKV != nH)
            cth = ct.transpose(1, 2)
            print(json.dumps({"label": args.label, "case": f"SDPA fp32 backward alone {shape}",
                              "M": B * S, "ms": device_time_ms(torch, lambda: torch.autograd.grad(
                                  y, leaves, grad_outputs=cth, retain_graph=True))}),
                  flush=True)
            del q, k, v, ct, out, lse, a, leaves, y
    if "mma" in groups:
        mma_rates(torch, _cuda, args.label)
    return 0 if ok else 1


MMA_SRC = r'''
#include <stdint.h>
template <int BF16, int CH>
__global__ void rate(float* out, int iters) {
  const uint32_t one = BF16 ? 0x3f803f80u : 0x3f800000u;
  uint32_t a[4] = {one + threadIdx.x, one, one, one}, b[2] = {one, one};
  float d[CH][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      if (BF16)
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
                     "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                     : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
      else
        asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
                     "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                     : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
    }
  }
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < CH; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
#define CASE(B, C) if (bf16 == B && chains == C) rate<B, C><<<blocks, threads, 0, st>>>(out, iters);
extern "C" int mma_rate(int bf16, int chains, float* out, int blocks, int threads, int iters,
                        cudaStream_t st) {
  CASE(0, 1) CASE(0, 4) CASE(0, 8) CASE(1, 1) CASE(1, 4) CASE(1, 8)
  return (int)cudaGetLastError();
}
'''


def mma_rates(torch, _cuda, label):
    """The ``mma`` group: TFLOP/s of mma.sync, one JSON line a case."""
    import ctypes

    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "mma_rate")
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "mma_rate.cu"), "w") as f:
        f.write(MMA_SRC)
    so = os.path.join(d, "libmma_rate.so")
    subprocess.run([_cuda._nvcc(), *_cuda.GENCODE, "-O3", "-shared", "-Xcompiler", "-fPIC", "-o",
                    so, os.path.join(d, "mma_rate.cu")], check=True)
    lib = ctypes.CDLL(so)
    lib.mma_rate.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(sms * 8 * 512, device="cuda")
    st = torch.cuda.current_stream().cuda_stream
    iters = 4096
    for bf16, name, flop in ((0, "tf32 m16n8k8", 2048), (1, "bf16 m16n8k16", 4096)):
        for chains in (1, 4, 8):
            for threads in (128, 256, 512):
                def launch():
                    err = lib.mma_rate(bf16, chains, out.data_ptr(), sms * 8, threads, iters, st)
                    if err:
                        raise RuntimeError(f"mma_rate: CUDA error {err}")
                ms = device_time_ms(torch, launch)
                n = sms * 8 * threads // 32 * iters * chains
                print(json.dumps({"label": label, "case": f"mma.sync {name}, {chains} chains, "
                                  f"{threads // 32} warps a block", "ms": ms,
                                  "tflops": n * flop / ms / 1e9}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
