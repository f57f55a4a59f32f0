"""Sweep the launch plans of the port's weight-only kernels on the card and
record the winners into the tile cache (``ops/tile_tuning.py``): the port of
the JAX package's ``tools/tile_autotune.py``, the analog of the reference's
gpt_gemm writing gemm_config.in (utils/gemm_test/gpt_gemm_func.cc,
cublasAlgoMap).

    python -m fastertransformer4codefuse_tpu_torch.ops.tile_autotune \\
        [--models codefuse13b,starcoder15b,mixtral8x7b] [--out PATH] [--log PATH]
        [--gemv-buckets 1,32] [--gemm-buckets 512,1024,4096] [--only SUBSTRING]
    python -m fastertransformer4codefuse_tpu_torch.ops.tile_autotune --dry --sms 132

It runs on an NVIDIA card only (``--dry`` prints the cases and candidates
without one). For every shape that the models' served routes launch
(``cases``), at every M bucket:

- the candidates are the default plan and its neighbours: for the GEMV
  (M <= 32) the split count of each segment scaled together (``SPLIT_FACTORS``),
  for the GEMM each block tile (``GEMM_TILES``) under each group-M width and
  stage cap;
- each candidate is launched through the kernel's own wrapper, its plan
  served from a scratch cache, and held against the plain version within
  1e-2 of max |plain| before it is timed (a miss stops the sweep);
- time: CUDA events, the median of 5 windows of 10 calls, a sleep kernel
  ahead of each window; the calls cycle through copies of the weights that
  together exceed twice the 50 MB L2, so that no call reads its weight from
  L2;
- the winner is recorded only if it beats the default by at least 3% and by
  more than the windows' spread (of either); otherwise the default is
  recorded. So no entry is slower than the default, and every shape swept
  has an entry.

The GEMV's tensor-core body (2-32 rows) gives a row the same bits at every M
only under one split count, so its buckets 2, 4, 8, 16 and 32 share one
choice: a candidate must be no slower than the default at each of them, and
its summed time must win as above. M = 1 (the FMA loop) is its own bucket.

Each recorded entry also carries the card's name, power limit and SM count,
``default_us`` and ``spread_us``; ``--log`` writes one JSON line an entry
with every candidate's time, the bound and the library call's time (bf16 ``torch.matmul`` on the
dequantized weight at GEMM widths, ``torch._weight_int*pack_mm`` at GEMV
widths where one takes the shape).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

import torch

from . import tile_tuning
from .quant_matmul import (
    DEFAULT_GEMM, GEMM_BK, GEMM_TILES, GEMV_MAX_CHUNK, GemmPlan, kernel_name, split_chunk,
    split_ranges,
)

L2_BYTES = 50e6
HBM_BYTES_PER_S = 3.35e12  # one H100 SXM (NVIDIA's data sheet), at 700 W
BF16_FLOPS = 989e12
WINDOWS, CALLS, SLEEP_CYCLES = 5, 10, 10_000_000
TOL = 1e-2
MIN_GAIN = 0.03
SPLIT_FACTORS = (0.25, 1 / 3, 0.5, 2 / 3, 1.0, 1.5, 2.0, 3.0)
GROUP_MS = (4, 8, 16)
STAGE_CAPS = (4, 8)
GEMV_JOINT = (2, 4, 8, 16, 32)  # the tensor-core body's buckets: one choice
G128 = 128
GELU = "gelu-tanh"

# name -> widths; the served routes' products (PERF.md §6 "Launches")
MODELS = {
    # CodeFuse-13B (GPT-NeoX): decode K13 (qkv | up) + K3 (proj + down), the
    # int4 head K8; prefill and chunk ticks K13 + proj + down; int8, int4 and
    # int4 g128, at tp = 1 and at the tp = 2 shard widths
    "codefuse13b": dict(H=5120, F=20480, qkv=15360, V_pad=102400, tps=(1, 2),
                        formats=((8, 0), (4, 0), (4, G128))),
    # StarCoder-15B int8: four K1 a layer (MQA QKV 6144 + 2 x 128)
    "starcoder15b": dict(H=6144, F=24576, qkv=6400, formats=((8, 0),)),
    # Mixtral-8x7B int8 attention (GQA 32 x 128 queries on 8 KV heads); its
    # experts run torch.bmm
    "mixtral8x7b": dict(H=4096, qkv=6144, formats=((8, 0),)),
}


@dataclass(frozen=True)
class Case:
    """One product: ``op`` (k1, k6, k7, k8, k13, k3) of K x N (K13: N | N2 over
    joined columns; K3: K over proj + K2 over down)."""
    note: str
    op: str
    bits: int
    G: int
    K: int
    N: int
    K2: int = 0
    N2: int = 0

    def body(self, gemv: bool) -> str:
        pre = {"k13": "ncat_", "k3": "pd_"}.get(self.op, "")
        return pre + ("gemv" if gemv else "gemm")

    def kernel(self, gemv: bool) -> str:
        scale = torch.empty(0, dtype=torch.bfloat16 if self.G else torch.float32)
        return kernel_name(self.body(gemv), self.bits, self.G, scale)

    def key_kn(self) -> tuple:
        return self.K + self.K2, self.N + self.N2

    def segs(self) -> list:
        """(K, N, share) of each GEMV segment, as the wrappers split them."""
        if self.op == "k13":
            return [(self.K, self.N, 1.0), (self.K, self.N2, 1.0)]
        if self.op == "k3":
            share = self.K / (self.K + self.K2)
            return [(self.K, self.N, share), (self.K2, self.N, 1.0 - share)]
        return [(self.K, self.N, 1.0)]

    def gemm(self) -> bool:
        return self.op != "k3"  # K3 is decode only


def cases(models) -> list:
    out = []
    for name in models:
        m = MODELS[name]
        H = m["H"]
        for tp in m.get("tps", (1,)):
            for bits, G in m["formats"]:
                single = {8: "k1", 4: "k7" if G else "k6"}[bits]
                tag = f"{name} tp{tp} int{bits}{f' g{G}' if G else ''}"
                if name == "codefuse13b":
                    q, f = m["qkv"] // tp, m["F"] // tp
                    out += [Case(f"{tag} qkv|up", "k13", bits, G, H, q, N2=f),
                            Case(f"{tag} proj+down", "k3", bits, G, H // tp, H, K2=f),
                            Case(f"{tag} proj", single, bits, G, H // tp, H),
                            Case(f"{tag} down", single, bits, G, f, H)]
                    if bits == 4 and not G:
                        out.append(Case(f"{tag} head", "k8", 4, 0, H, m["V_pad"] // tp))
                elif name == "starcoder15b":
                    out += [Case(f"{tag} qkv", single, bits, G, H, m["qkv"]),
                            Case(f"{tag} proj", single, bits, G, H, H),
                            Case(f"{tag} up", single, bits, G, H, m["F"]),
                            Case(f"{tag} down", single, bits, G, m["F"], H)]
                else:
                    out += [Case(f"{tag} qkv", single, bits, G, H, m["qkv"]),
                            Case(f"{tag} proj", single, bits, G, H, H)]
    return out


def gemv_candidates(case: Case, sms: int) -> list:
    """Split-count tuples: the default's (``split_ranges``) first, then each
    factor of ``SPLIT_FACTORS`` applied to every segment, kept where every
    segment's ranges are ones the GEMV takes."""
    default = tuple(split_ranges(K, N, sms, share, case.bits, case.G)[0]
                    for K, N, share in case.segs())
    out = [default]
    for f in SPLIT_FACTORS:
        cand = []
        for (K, _, _), d in zip(case.segs(), default):
            n, chunk = split_chunk(K, max(1, round(d * f)), case.G)
            cand.append(n if chunk <= GEMV_MAX_CHUNK else None)
        if None not in cand and tuple(cand) not in out:
            out.append(tuple(cand))
    return out


def gemm_candidates() -> list:
    out = [DEFAULT_GEMM]
    for (rows, cols) in GEMM_TILES:
        for gm in GROUP_MS:
            for st in STAGE_CAPS:
                p = GemmPlan(rows, cols, gm, st)
                if p not in out:
                    out.append(p)
    return out


def bucket_m(b: int) -> int:
    """The M a bucket is timed at: its top, and the 3000-token prefill's 3072
    for 4096."""
    return 3072 if b == 4096 else b


# --- on the card -------------------------------------------------------------


def card_fields(dev) -> dict:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout
    name, power = [p.strip() for p in smi.strip().splitlines()[dev.index or 0].split(",")]
    return {"card": torch.cuda.get_device_name(dev), "power_limit": power,
            "sms": torch.cuda.get_device_properties(dev).multi_processor_count,
            "smi_name": name}


class Operands:
    """A case's weights (``n`` copies) and its calls at one M."""

    def __init__(self, case: Case, dev, gen):
        self.case, self.dev, self.gen = case, dev, gen
        c = case
        pk = (lambda k: k // 2) if c.bits == 4 else (lambda k: k)

        def i8(*shape):
            return torch.empty(shape, dtype=torch.int8, device=dev).random_(-128, 128,
                                                                            generator=gen)

        def scale(k, n):
            qmax = 127 if c.bits == 8 else 7
            if c.G:
                return (torch.empty(k // c.G, n, device=dev).uniform_(0.5, 1.5, generator=gen)
                        * (0.02 / qmax)).to(torch.bfloat16)
            return torch.empty(n, device=dev).uniform_(0.5, 1.5, generator=gen) * (0.02 / qmax)

        def one():
            if c.op == "k13":
                return (i8(pk(c.K), c.N), scale(c.K, c.N), i8(pk(c.K), c.N2), scale(c.K, c.N2))
            if c.op == "k3":
                return (i8(pk(c.K), c.N), scale(c.K, c.N), i8(pk(c.K2), c.N), scale(c.K2, c.N))
            return (i8(pk(c.K), c.N), scale(c.K, c.N))

        first = one()
        nbytes = sum(t.numel() * t.element_size() for t in first)
        self.weight_bytes = nbytes
        self.copies = [first] + [one() for _ in range(max(2, math.ceil(2 * L2_BYTES / nbytes)) - 1)]
        self.b1 = self._bf(c.N, std=0.02)
        self.b2 = self._bf(c.N2, std=0.02) if c.N2 else None
        self._mats = None

    def _bf(self, *shape, std=1.0):
        return (torch.randn(shape, device=self.dev, generator=self.gen) * std).to(torch.bfloat16)

    def calls(self, M):
        """(call(i) on weight copy i, plain(), operands' bytes, operations)."""
        from .quant_matmul import quant_matmul, quant_matmul_plain
        from .quant_matmul_fused import (
            fused_proj_down, fused_proj_down_plain, fused_qkv_up, fused_qkv_up_plain,
        )
        from .quant_matmul_w4 import (
            quant_matmul_w4, quant_matmul_w4_group, quant_matmul_w4_group_plain,
            quant_matmul_w4_head, quant_matmul_w4_head_plain, quant_matmul_w4_plain,
        )

        c, b1 = self.case, self.b1
        x = self._bf(M, c.K)
        ws = self.copies
        if c.op == "k13":
            x2 = self._bf(M, c.K)
            f = lambda i, plain=False: (fused_qkv_up_plain if plain else fused_qkv_up)(  # noqa: E731
                x, x2, ws[i][0], ws[i][2], ws[i][1], ws[i][3], b1, self.b2, None, GELU, c.bits,
                c.G)
            io = (x, x2, b1, self.b2)
            flops = 2 * M * c.K * (c.N + c.N2)
        elif c.op == "k3":
            x2, res = self._bf(M, c.K2, std=0.5), self._bf(M, c.N)
            f = lambda i, plain=False: (fused_proj_down_plain if plain else fused_proj_down)(  # noqa: E731
                x, x2, ws[i][0], ws[i][2], ws[i][1], ws[i][3], b1, res, c.bits, c.G)
            io = (x, x2, b1, res)
            flops = 2 * M * (c.K + c.K2) * c.N
        else:
            kern, plain_fn = {
                "k1": (lambda x, w, s: quant_matmul(x, w, s, b1),
                       lambda x, w, s: quant_matmul_plain(x, w, s, b1)),
                "k6": (lambda x, w, s: quant_matmul_w4(x, w, s, b1),
                       lambda x, w, s: quant_matmul_w4_plain(x, w, s, b1)),
                "k7": (lambda x, w, s: quant_matmul_w4_group(x, w, s, c.G, b1),
                       lambda x, w, s: quant_matmul_w4_group_plain(x, w, s, c.G, b1)),
                "k8": (quant_matmul_w4_head, quant_matmul_w4_head_plain),
            }[c.op]
            f = lambda i, plain=False: (plain_fn if plain else kern)(x, ws[i][0], ws[i][1])  # noqa: E731
            io = (x, None if c.op == "k8" else b1)
            flops = 2 * M * c.K * c.N
        out_bytes = M * (c.N + c.N2) * (4 if c.op == "k8" else 2)
        nbytes = self.weight_bytes + out_bytes + sum(
            t.numel() * t.element_size() for t in io if t is not None)
        return (lambda i: f(i % len(ws))), (lambda: f(0, plain=True)), nbytes, flops

    def library(self, M):
        """(fn(i), label) of one PyTorch call computing the same product, timed
        beside the kernel and used nowhere in the port, or (None, why not)."""
        c = self.case
        if c.op == "k3":
            return None, "none: no one PyTorch call computes it"
        if M > 32:
            mats = self._dequantized()
            x = self._bf(M, c.K)
            label = ("two torch.matmul, bf16 weights dequantized beforehand" if c.op == "k13"
                     else "torch.matmul, bf16 weight dequantized beforehand")
            return (lambda i: [x @ w for w in mats[i % len(mats)]]), label
        if c.op == "k13":
            return None, "none: no one PyTorch call computes it"
        x = self._bf(M, c.K)
        try:
            if c.bits == 8:
                w, s = self.copies[0][0].t().contiguous(), self.copies[0][1].to(torch.bfloat16)
                fn = lambda i: torch._weight_int8pack_mm(x, w, s)  # noqa: E731
                name = "torch._weight_int8pack_mm"
            else:
                g = c.G or 256
                u8 = torch.randint(0, 256, (c.N, c.K // 2), dtype=torch.uint8, device=self.dev,
                                   generator=self.gen)
                w = torch._convert_weight_to_int4pack(u8, 8)
                sz = torch.ones(c.K // g, c.N, 2, dtype=torch.bfloat16, device=self.dev)
                fn = lambda i: torch._weight_int4pack_mm(x, w, g, sz)  # noqa: E731
                name = f"torch._weight_int4pack_mm (groups of {g})"
            fn(0)
            torch.cuda.synchronize()
            return fn, name
        except (RuntimeError, NotImplementedError, AttributeError, TypeError) as e:
            why = (str(e).strip().splitlines() or [type(e).__name__])[0][:80]
            return None, f"none on CUDA, torch {torch.__version__} ({why})"

    def _dequantized(self):
        """bf16 copies of the weights (K13: both products'), enough to exceed
        twice the L2 together; made once."""
        from ..models.params import QuantizedTensor

        if self._mats is None:
            c = self.case
            n = min(len(self.copies),
                    max(2, math.ceil(2 * L2_BYTES / (2 * c.K * (c.N + c.N2)))))
            self._mats = [[QuantizedTensor(q=w[j], scale=w[j + 1], k_axis=-2, group_size=c.G,
                                           bits=c.bits).dequantize().to(torch.bfloat16)
                           for j in range(0, len(w), 2)] for w in self.copies[:n]]
        return self._mats


def time_us(call):
    """(median, spread) in µs of one call: CUDA events around 10 calls, 5
    windows, a sleep kernel ahead of each so that the host's enqueue is not
    timed."""
    call(0)
    torch.cuda.synchronize()
    out, i = [], 0
    for _ in range(WINDOWS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(CALLS):
            call(i)
            i += 1
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) * 1e3 / CALLS)
    return statistics.median(out), max(out) - min(out)


class served:
    """A scratch tile cache at ``path`` holding ``entries`` {(kernel, bucket,
    K, N, G): fields}, recorded for a card of ``sms`` SMs, served to the
    kernels' own wrappers (``FTCF_TILE_CACHE``) inside the ``with``."""

    def __init__(self, path, entries, sms):
        self.path, self.entries, self.sms = str(path), entries, sms

    def __enter__(self):
        with open(self.path, "w") as f:
            json.dump({tile_tuning._key(*k): {"us": 1.0, "note": "", **v, "sms": self.sms}
                       for k, v in self.entries.items()}, f)
        self.was = os.environ.get("FTCF_TILE_CACHE")
        os.environ["FTCF_TILE_CACHE"] = self.path
        tile_tuning.invalidate()
        return self

    def __exit__(self, *exc):
        if self.was is None:
            os.environ.pop("FTCF_TILE_CACHE", None)
        else:
            os.environ["FTCF_TILE_CACHE"] = self.was
        tile_tuning.invalidate()


def rel(got, ref):
    if isinstance(got, tuple):
        got, ref = torch.cat(got, 1), torch.cat(ref, 1)
    d = (got.float() - ref.float()).abs().max().item()
    return d / max(ref.float().abs().max().item(), 1e-30)


def plan_fields(plan) -> dict:
    if isinstance(plan, GemmPlan):
        return {"bn": plan.cols, "bk": GEMM_BK, "rows": plan.rows, "group_m": plan.group_m,
                "stages": plan.stages}
    return {"bn": 0, "bk": 0, "splits": list(plan)}


def plan_label(plan) -> str:
    if isinstance(plan, GemmPlan):
        return f"{plan.rows}x{plan.cols} g{plan.group_m} s{plan.stages}"
    return ",".join(map(str, plan))


def choose(times: dict, default):
    """The winner of ``times`` {candidate: [(median, spread) per width]}: no
    slower than the default at any width, the least summed median, kept only
    if it wins by MIN_GAIN of the default's sum and by more than the summed
    spread of either; else the default."""
    d = times[default]
    d_sum = sum(t for t, _ in d)
    best, best_sum = default, d_sum
    for cand, ts in times.items():
        if all(t <= td for (t, _), (td, _) in zip(ts, d)) and sum(t for t, _ in ts) < best_sum:
            best, best_sum = cand, sum(t for t, _ in ts)
    if best != default:
        spread = max(sum(s for _, s in times[best]), sum(s for _, s in d))
        if d_sum - best_sum < MIN_GAIN * d_sum or d_sum - best_sum <= spread:
            best = default
    return best


def sweep(case, ops, gemv, buckets, scratch, card, out_path, log_f):
    """Time every candidate of ``case`` at ``buckets`` (one shared choice for
    all of them), record the winner under each bucket; return the log rows."""
    kernel = case.kernel(gemv)
    K, N = case.key_kn()
    cands = gemv_candidates(case, card["sms"]) if gemv else gemm_candidates()
    default = cands[0]
    widths = [bucket_m(b) for b in buckets]
    calls = {M: ops.calls(M) for M in widths}
    refs = {}
    for M, (_, plain, _, _) in calls.items():
        refs[M] = plain()
    times = {}
    for cand in cands:
        per = []
        for b, M in zip(buckets, widths):
            call = calls[M][0]
            with served(scratch, {(kernel, b, K, N, case.G): plan_fields(cand)}, card["sms"]):
                e = rel(call(0), refs[M])
                if not e < TOL:
                    raise SystemExit(f"tile_autotune: {kernel} {case.note} M={M} under {cand}: "
                                     f"max |kernel - plain| / max |plain| = {e:.3e} (tol {TOL})")
                before = tile_tuning.hits[kernel]
                per.append(time_us(call))
                if tile_tuning.hits[kernel] == before:
                    raise SystemExit(f"tile_autotune: {kernel} {case.note}: the scratch entry "
                                     f"was not served")
        times[cand] = per
    del refs
    best = choose(times, default)
    rows = []
    for i, (b, M) in enumerate(zip(buckets, widths)):
        us, spread = times[best][i]
        d_us, d_spread = times[default][i]
        lib_fn, lib_label = ops.library(M)
        lib_us = time_us(lib_fn)[0] if lib_fn is not None else None
        nbytes, flops = calls[M][2], calls[M][3]
        bound_us = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e6
        tile_tuning.record(
            kernel, b, K, N, case.G, bn=plan_fields(best)["bn"], bk=plan_fields(best)["bk"],
            us=us, note=f"{case.note} M={M}", path=out_path,
            extra={k: v for k, v in {**plan_fields(best), "default_us": round(d_us, 2),
                                     "spread_us": round(max(spread, d_spread), 2),
                                     "card": card["card"], "power_limit": card["power_limit"],
                                     "sms": card["sms"]}.items() if k not in ("bn", "bk")})
        row = {"key": tile_tuning._key(kernel, b, K, N, case.G), "note": case.note, "M": M,
               "plan": plan_fields(best), "us": round(us, 2), "default_us": round(d_us, 2),
               "candidates_us": {plan_label(c): round(times[c][i][0], 2) for c in cands},
               "spread_us": round(max(spread, d_spread), 2), "bound_us": round(bound_us, 2),
               "library_us": None if lib_us is None else round(lib_us, 2),
               "library": lib_label, "candidates": len(cands),
               "card": card["card"], "power_limit": card["power_limit"]}
        rows.append(row)
        if log_f is not None:
            log_f.write(json.dumps(row) + "\n")
            log_f.flush()
        print(f"  {row['key']:44s} {case.note:34s} M={M:5d} default {d_us:9.2f} us  "
              f"tuned {us:9.2f} us ({plan_fields(best)})  bound {bound_us:8.2f} us  "
              f"library {row['library_us']}", flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--models", default=",".join(MODELS))
    ap.add_argument("--out", default=tile_tuning._DEFAULT_PATH,
                    help="the cache file the winners are recorded into")
    ap.add_argument("--log", default="", help="a JSON line a recorded entry")
    ap.add_argument("--gemv-buckets", default="1,32",
                    help="1: the M = 1 loop; 32: the shared choice of buckets 2-32")
    ap.add_argument("--gemm-buckets", default="512,1024,4096")
    ap.add_argument("--head-gemm-buckets", default="64",
                    help="the int4 head's GEMM buckets (a beam prefill's 8 rows x 8 beams)")
    ap.add_argument("--only", default="", help="sweep only the cases whose note has this")
    ap.add_argument("--dry", action="store_true", help="print the cases and candidates")
    ap.add_argument("--sms", type=int, default=0, help="with --dry: the card's SM count")
    args = ap.parse_args(argv)
    models = [m for m in args.models.split(",") if m]
    todo = [c for c in cases(models) if args.only in c.note]
    gemv_b = [int(b) for b in args.gemv_buckets.split(",") if b]
    gemm_b = [int(b) for b in args.gemm_buckets.split(",") if b]
    head_b = [int(b) for b in args.head_gemm_buckets.split(",") if b]

    def jobs(c):
        for b in gemv_b:
            yield True, ([1] if b == 1 else list(GEMV_JOINT))
        for b in (head_b if c.op == "k8" else gemm_b if c.gemm() else ()):
            yield False, [b]

    if args.dry:
        sms = args.sms or 132
        for c in todo:
            for gemv, bs in jobs(c):
                n = len(gemv_candidates(c, sms)) if gemv else len(gemm_candidates())
                print(f"{c.kernel(gemv):16s} {c.note:34s} K={c.key_kn()[0]} N={c.key_kn()[1]} "
                      f"buckets {bs}: {n} candidates")
        return 0
    if not torch.cuda.is_available():
        print("tile_autotune: no CUDA device: the sweep runs on the card only", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_fields(dev)
    print(f"tile_autotune: {card['card']} ({card['smi_name']}, {card['power_limit']}, "
          f"{card['sms']} SMs), torch {torch.__version__}, {len(todo)} cases -> {args.out}",
          flush=True)
    t0 = time.time()
    log_f = open(args.log, "a") if args.log else None
    gen = torch.Generator(device=dev).manual_seed(2024)
    with tempfile.TemporaryDirectory() as tmp:
        scratch = Path(tmp) / "candidate.json"
        for c in todo:
            ops = Operands(c, dev, gen)
            for gemv, bs in jobs(c):
                sweep(c, ops, gemv, bs, scratch, card, args.out, log_f)
            del ops
            torch.cuda.empty_cache()
    if log_f is not None:
        log_f.close()
    print(f"tile_autotune: done in {time.time() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
