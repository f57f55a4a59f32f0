#!/usr/bin/env python3
"""Time the port's weight-streaming GEMVs (K1, K3, K6, K7, K8 and K13's GEMV
form) at CodeFuse-13B shapes on one NVIDIA GPU, for an A/B of two copies of
the port on one card.

    python3 gemv_ab.py [--root DIR] [--label NAME] [--widths 1,4,8]

``--root`` is the directory that holds the ``fastertransformer4codefuse_tpu_torch``
package to time (default: the one beside this script), so one call can time
an unpacked copy of another commit, in turns with this one. Each case is
checked against its plain version (max |kernel - plain| / max |plain| below
1e-2) and timed as ``chip_smoke.py`` times its kernels (CUDA events, median
of 5 windows of 10 calls, a sleep kernel ahead of each window); ``torch._weight_int4pack_mm`` on the QKV shape
is timed beside at every width above 1. Prints one JSON object a line, the
card's name and power limit first; exits non-zero without a card or on a
miss.
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
    ap.add_argument("--widths", default="1,4,8")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("gemv_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from fastertransformer4codefuse_tpu_torch.ops import _cuda
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

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    _cuda.lib()
    print(json.dumps({"label": args.label, "card": card, "root": args.root}), flush=True)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    H, F, V = 5120, 20480, 102400

    def i8(*shape):
        return torch.empty(shape, dtype=torch.int8, device=dev).random_(-128, 128, generator=gen)

    def bf(*shape, std=1.0):
        return (torch.randn(shape, device=dev, generator=gen) * std).to(torch.bfloat16)

    def scale(n, qmax):
        return torch.empty(n, device=dev).uniform_(0.5, 1.5, generator=gen) * (0.02 / qmax)

    def gscale(k, n, qmax, dtype, G=128):
        return scale((k // G, n), qmax).to(dtype)

    bf16, f32 = torch.bfloat16, torch.float32
    w8q, s8q, w4q, s4q = i8(H, 3 * H), scale(3 * H, 127), i8(H // 2, 3 * H), scale(3 * H, 7)
    g4q = gscale(H, 3 * H, 7, bf16)
    w8u, s8u, w4u, s4u = i8(H, F), scale(F, 127), i8(H // 2, F), scale(F, 7)
    g4u = gscale(H, F, 7, bf16)
    w8p, w8d, s8p, s8d = i8(H, H), i8(F, H), scale(H, 127), scale(H, 127)
    w4p, w4d, s4p, s4d = i8(H // 2, H), i8(F // 2, H), scale(H, 7), scale(H, 7)
    g4p, g4d, g8p, g8d = (gscale(H, H, 7, bf16), gscale(F, H, 7, bf16), gscale(H, H, 127, f32),
                          gscale(F, H, 127, f32))
    bq, bu, bd = bf(3 * H, std=0.02), bf(F, std=0.02), bf(H, std=0.02)
    wh, sh = i8(H // 2, V), scale(V, 7)
    lib_w = torch._convert_weight_to_int4pack(
        torch.randint(0, 256, (3 * H, H // 2), dtype=torch.uint8, device=dev, generator=gen), 8)
    ok = True
    for M in (int(w) for w in args.widths.split(",")):
        x1, x2, h, res = bf(M, H), bf(M, H), bf(M, F, std=0.5), bf(M, H)
        act = "gelu-tanh"
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
            got, ref = kernel(*a), plain(*a)
            if isinstance(got, tuple):
                got, ref = torch.cat(got, 1), torch.cat(ref, 1)
            rel = ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()
            ok &= rel < 1e-2
            print(json.dumps({"label": args.label, "case": name, "M": M,
                              "ms": device_time_ms(torch, lambda: kernel(*a)), "rel": rel}),
                  flush=True)
        if M > 1:
            sz = torch.ones(H // 128, 3 * H, 2, dtype=bf16, device=dev)
            print(json.dumps({"label": args.label, "case": "_weight_int4pack_mm qkv g128", "M": M,
                              "ms": device_time_ms(
                                  torch, lambda: torch._weight_int4pack_mm(x1, lib_w, 128, sz))}),
                  flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
