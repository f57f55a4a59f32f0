#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. device, torch and CUDA versions, card name and power limit; build the
     CUDA kernels from ``fastertransformer4codefuse_tpu_torch/csrc``; every
     GEMV instance within 128 registers and without spills, and no TMA +
     wgmma instance (the prefill attention body: K5 under CausalPrefix, K12
     under Band, whose dh 64 and 128 instances must be built; K10, the GEMM)
     and no decode attention instance (K4/K9/K11 and their combine)
     spilling;
  2. each kernel (K1-K13; K2/K3 on int4 weights and with group scales,
     int4 and int8, G = 128; the GEMVs K1, K3, K6, K7, K8 and K13's GEMV
     form (int8, int4 and int4 g128) at M = 1, 4 and 8, K1 QKV, K6 and K13
     int8 also at 32, then row r of K6, K7 and K13 int8 bit for bit the same
     at M = 2, 4, 8 and 32; the prefill-width GEMM (TMA + wgmma): K13's form
     at M = 512, 1024 and 3072 beside the pair of unfused GEMMs it replaces,
     K1 QKV, K6 and K7 at 512 and 1024, K1 proj and down at 1024 and 3072,
     K8's head at 64, each with its tiles and waves and beside the bf16
     ``torch.matmul`` yardstick, then rows of K1, K7 and K13 at M = 130 bit
     for bit the same rows at M = 1024, two calls equal bytes, and the host
     cost of a call; the packed int4 reads of K4/K9/K10/K11; K10 also on
     pages of 128 and on bf16 pages of 12 (raw rows), and two calls equal
     bytes; K4 also at B = 1, S = 4096, with GQA g = 8 (40 query heads) and
     MQA g = 48 (48 x 128, one KV head), at 80 x 64 heads and MQA g = 80 (80
     x 64, one KV head), and each row at B = 1 bit for bit its row at B = 8
     and two calls equal bytes; K9 also at g = 8 and 48; K5 also at 32 x 64
     heads)
     against its plain PyTorch version at CodeFuse-13B shapes, K12 at
     Longformer-base shapes (S = 4096, w_half 256, both band modes; two
     calls equal bytes) and at the band's edges (S = 1000: w = 0, 130 and
     S, dh 128 with w = 300; lengths off the 128-key tiles, an empty row;
     both modes): max error against the stated tolerance, median kernel and
     plain times (CUDA events, device time), the card's bound for the same
     work and the kernel's share of it, and where one PyTorch call computes
     the same function, its time at every case
     (``scaled_dot_product_attention`` on a dense bf16 K/V of the same
     length, causal for K5, the resolved cache for K11, with a boolean
     band-and-length mask for K12;
     ``torch._weight_int8pack_mm`` / ``torch._weight_int4pack_mm`` for the
     weight-only GEMVs where they run on the card, ``torch.matmul`` on a bf16
     weight dequantized beforehand for the GEMM (two for K13); the port
     calls none of them); the group-scaled GEMVs beside their per-channel forms (K7 beside
     K6, K13 g128 beside K13 int4, K3 g128 beside K3 per-channel); the int4
     instances with fp32 group scales (FTCF_GSCALE_BF16=0: K7 and K13 at M =
     1, 4, 8, 512 and 1024, K3 at 1, 4 and 8, K2 at 1 and 4) beside their
     bf16-scale instances; K11 also bit for bit against K4 over a gathered
     copy; K13 (M = 1, 4, 1024), K3 (M = 1, 4), K1 proj and down (M = 1024),
     K4 and K5 at CodeFuse-13B's tp = 2 shard shapes (20 heads a rank); the
     GEMMs under their plans from the tile cache (``ops/tile_tuning.py``),
     each case's tiles logged; then (``phase_tile_cache``) K13 at M = 1024
     on each of the GEMM's four block tiles in every weight format against
     its plain version and bit for bit against the default tile, and every
     entry of the shipped cache served to its kernel at its M against the
     plain version, its recorded default and tuned times logged (and timed
     again where it leaves the default); phases 4 and 5 count the cache's
     hits on the served CodeFuse-13B routes (> 0) and time the 3000-token
     prefill's GEMM and the int8 ticks' GEMM, K13 and K3 with the default
     plans (``FTCF_TILE_TUNE=0``) beside the cache's;
  3. models of CodeFuse-13B width, int8 at 2 layers and int4 at 1
     (``REF_LAYERS``; int8 and int4 g128, each with
     ``fused_decode`` True (K13 + K3) and False (unfused GEMMs), the two
     routes' card logits also against each other; int4 per-channel; int8 at
     its first layer on an int4 dense cache, on int8 and int4 KV pools
     through chunked prefill, and in beam decode through a beam history;
     int4 g128 with fp32 group scales on both routes, its launches counted)
     built on the card and copied to the CPU: prefill and teacher-forced
     decode logits on the card (kernels) against the CPU (plain versions);
     and 2-layer Longformer-base (K12; with a global token, the dense path)
     and int8 BERT-base (K1) from random weights under HF's names: hidden
     states and pooled outputs, card (bf16) against CPU (fp32); no plain
     attention route taken on any of them; then four tiny configs with
     attention shapes off the 13B path (64-wide heads, 16 query heads a KV
     head, a pool on bf16 pages of 4: kernels; 32-wide heads: the plain
     routes, where the JAX package takes XLA) served on the card and the
     CPU: the same greedy tokens (teacher-forced past a near-tie), and each
     route the one the config must take;
  4. CodeFuse-13B (full width, 10 of its 40 layers, int8 KV cache, random
     weights) built on the card, once with int8 weights and then with int4
     weights, per-channel and group-wise (G = 128), and driven through
     ``GptNeoXEngine.generate`` and ``CodeFuseHandler.predict``, then a
     ``fused_decode`` A/B (decode ms/step of each route, in turns); on the int8
     weights, a 3000-token prompt on an "int4" cache (greedy x2 + streamed;
     its prefill profiled with K5, whose milliseconds and launches it
     reports beside the GEMM's, and with the plain attention forced in),
     prompts of 2048 and 1300 tokens on an "int8k_int4v" cache, and beam
     search (2 prompts x 4 beams, x2 + streamed, every hypothesis rescored
     teacher-forced); prompt learning: prefix tables of the model's own K/V
     of a 128- and a 96-token prefix, a prefix-prompted and a soft-prompted
     (64 x 5120 embeddings) greedy run held to the concatenated sequence's
     greedy (teacher-forced), prefix-prompted beams (2 x 4, rescored), a
     dense pool (bf16 KV) with the two-task table (prompted and plain
     requests mid-flight) against each request's solo run; the DEBUG sweep on clean
     weights and with a NaN planted in layer 7's scales (named by the sweep
     and by the checked forward), its ms;
  4b. SmoothQuant W8A8 and AWQ: at 2 layers of 13B width, calibration stats
     card vs CPU, the AWQ fold (fp-exact; int4 g128 error against
     round-to-nearest), the SmoothQuant fold, act_int8 logits card vs CPU;
     at 40 layers, the float model built on the card for its stats, folded,
     quantized and freed, the 1000- and 3000-token prefills with act_int8
     beside weight-only (profiled), torch._int_mm against the port's GEMM
     at M = 3072, decode with K13 + K3 and no torch._int_mm, peak memory;
  5. on the int8 model of phase 4, pooled serving: a ``BatchingServer`` on a
     paged pool (8 slots, 2048 positions, 65 pages of 256) takes a mix of 10
     greedy and sampled requests from threads, twice, and one greedy request
     alone; the same mix twice on int4 pages; the host and device split of
     chunk and decode ticks on int8 and on int4 pages; then a pooled
     ``CodeFuseHandler``, one with two length classes behind the HTTP front
     end on localhost, a lazy paged pool that must preempt, a dense pool
     (K4), a dense beam pool (2 slots x 4 beams, K11; each request's beams
     in the mix equal its beams alone) and a handler with a sampling and a
     beam class. Tick dispatch runs under
     ``torch.cuda.set_sync_debug_mode("error")``. Then prompt-lookup
     speculative decoding (k = 8, 3-grams) on code prompts with repeated
     lines: ``speculative_generate`` (1000-token prompt, 128 tokens) beside
     static greedy decode, ``speculative_generate_batched`` at B = 4, a
     ``MultiPoolServer`` with a speculative and a sampling class taking 8
     requests from threads (speculative ticks under the same sync check),
     and the handler's speculative route; each path's tokens held to greedy
     through the same chunked program, teacher-forced (near-ties allowed);
  6. encoder serving at full depth: Longformer-base (12 layers) behind an
     ``EncoderBatchingServer`` takes 8 requests of 300-4096 tokens from
     threads, a batch with a global token takes the dense path, and int8
     BERT-base (12 layers) takes 16 requests of 32-512 tokens; each request
     equals its solo encode; encodes/s and tokens/s of each mix x4 in three
     timed windows, ms per batch, peak memory, where Longformer's
     batched-vs-solo gap comes from, and a profiled encode of each model;
  7. checkpoint -> CLI at CodeFuse-13B widths with 1 layer: random weights
     under HF's GPT-NeoX names written by ``ckpt.convert.convert_hf_to_bin``
     (fp16), int8 and int4 g128 payloads by ``ckpt.quantize.quant_and_save``;
     the loaded parameters equal the reference bit for bit, ``api.cli.main``
     over a JSONL file and with ``--serve --paged_pages`` on stdin prints
     what handlers on an engine over the reference parameters give; load
     time, read rate and reader logged; the directory removed;
  8. the decoder families (``phase_families``): StarCoder (bigcode/starcoder,
     10 of its 40 layers, full width, int8 weights, embeddings and KV) through the
     engine (a 1000-token prompt, 64 greedy tokens x2; B = 4 sampled x2; a
     3000-token prompt), the handler, a paged ``BatchingServer`` taking 7
     greedy requests from threads (three of them alone equal to themselves
     in the mix; each compared with its static greedy run) and beam search
     (2 x 4 beams, rescored); then Qwen2.5-Coder-7B, CodeLlama-7B (int8 and
     int4 g128), GPT-J-6B, GPT-2 XL (a paged pool whose dh-64 chunk
     attention takes the plain route), OPT-6.7B and Mixtral-8x7B (a dense
     pool; two runs equal bytes) at their published widths and 1 layer
     (Mixtral 2),
     card against CPU: logits, greedy tokens (teacher-forced past near-ties;
     for Mixtral also past router near-ties) and exact launches;
  9. the encoder-decoder, vision and audio families (``phase_seq2seq``),
     none of which reaches a JAX kernel: T5-3B (google-t5/t5-3b, 12 + 12
     of its 24 + 24 layers, int8, random weights at HF's init scales drawn and quantized
     on the card) behind a ``T5BatchingServer(max_batch=8)``: 8 greedy, 2
     sampled and 4 beam requests from threads, twice, the batches the
     coalescing rule's, greedy tokens held to a solo teacher-forced pass,
     sampled requests equal bytes, beams rescored; encode, decode and beam
     ms/step, a profiled decode step, requests/s, peak memory; T5-3B's
     width (int8 and bf16), BART-large and Marian (opus-mt-en-de) at 2 + 2
     layers, card vs CPU (logits, greedy tokens past near-ties); ViT-B/16,
     Swin-T, DeBERTa-v3-base, XLNet-base and the large Conformer at
     published widths and depths, card vs CPU (hidden states, two card
     encodes equal bytes, encodes/s);
  10. tensor parallelism (``phase_tp``): CodeFuse-13B int8 at full width, 4
     layers, tp = 2 as two ranks of a gloo group on the one card (spawned
     after the kernels are built; NCCL refuses two ranks on one device)
     beside a tp = 1 engine over the same weights: a static greedy batch of
     two ~1000-token prompts (teacher-forced logits against tp = 1's, greedy
     tokens equal past near-ties, both ranks' tokens the same bytes), a
     paged pool of 4 requests (each token held to the tp = 1 static
     program's argmax), one counted all-reduce a layer a forward and one
     all-gather of the logits a forward, each rank's launches exact, and
     the two ranks' times beside tp = 1's;
  11. pipeline parallelism (``phase_pp``): the same model at 4 layers on four
     ranks of one gloo group on the card, as pp = 2 (two copies of the mesh,
     2 layers a stage) and as tp 2 x pp 2, beside a pp = 1 engine on rank 0:
     the static greedy batch at 1 and 2 microbatches (teacher-forced logits
     against pp = 1's, greedy tokens equal past near-ties, every rank the
     same bytes), a dense pool of 4 requests (each token held to the pp = 1
     static program's argmax), the counted hops, broadcasts, all-reduces and
     all-gathers exact, each rank's launches exact at its stage's layers, and
     the times beside pp = 1's.
  12. training (``phase_train``): K5's fp32 forward (with each row's
     log-sum-exp) and its backward, the dK/dV and dQ kernels, against their
     plain versions (the gradient of sum(out * ct) by autograd of the plain
     forward; within 1e-4 of max |plain|) at CodeFuse-13B's 40 x 128 (B = 1,
     S = 2048), proxy85m's B = 8, S = 2048, 8 x 256 with a length below S
     and GQA g = 4, the autograd route the kernels' bytes, timed beside the
     fp32 bound and SDPA's fp32 causal forward (+ backward); proxy85m (12 x
     64 heads, 12 layers) trained in fp32 on the repository's text through
     ``tools.train_proxy`` (100 steps at S = 256, then 3 at S = 2048; the
     loss must fall below 0.8 x its first; K5 and each backward kernel
     exactly L a step), ms per step, one more step at each width profiled
     (device time, busy share, K5's share); the checkpoint saved and loaded the
     same bytes; a short bf16 quality table of the trained model
     (``tools.quality_table``: float, int8, int8 + int8 KV, int4 g128; K13,
     K1, K3, K4 and K7 launched; int8's dNLL under 0.02).
Phase 2 also holds the group-wise forms no served model makes: K1 and K13 on
int8 weights with group scales (M = 1, 4, 1024) and K7 as the group-wise
transposed head. For each path of phases 4 to 11 the kernel launch counters are zeroed just
before it is driven and checked just after against the counts its route must
give, with the attention dispatchers' ``plain_routes`` at 0 (on GPT-2 XL's
paged pool, one a layer a chunk tick; every path of phase 9 launches 0). The line before the last holds the kernels' JSON record; the last line
is the device record. Without a CUDA device, or without the package beside
it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import os
import queue
import re
import statistics
import subprocess
import sys
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# One H100 SXM (NVIDIA's data sheet): HBM rate and dense bf16 tensor rate, at
# the 700 W power limit. A kernel's bound is the larger of its bytes over the
# first and its operations over the second.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
CARD = ""  # nvidia-smi's "name, power limit", logged beside each phase-5 measurement
# the attention dispatchers (prefill_attention, kv_cache.attend_chunk and
# attend_decode), whose ``plain_routes`` count calls sent to a plain version
ROUTERS = ()


T0 = time.time()


def log(*a):
    """Print a line; a phase's first line also gets the seconds since start."""
    if a and str(a[0]).startswith("phase "):
        a = (*a, f"[{time.time() - T0:.0f} s in]")
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


def ptxas_entries(build_log):
    """(source, kernel, template arguments, registers, spill store bytes,
    spill load bytes) of each entry function in ``nvcc -Xptxas -v``'s log."""
    out, src, entry, spill = [], "", None, (0, 0)
    for line in build_log.splitlines():
        if line.startswith("== "):
            src = line[3:].split(" (")[0]
            continue
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry, spill = m.group(1), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            k = re.search(r"N4ftcfL?\d+(\w+?)I((?:Li\d+E)+)", entry)
            name, args = (k.group(1), ",".join(re.findall(r"Li(\d+)E", k.group(2)))) if k \
                else (entry[:40], "")
            out.append((src, name, args, int(m.group(1)), *spill))
            entry = None
    return out


def bound(nbytes, flops):
    """(bound_ms, bound_by) for ``nbytes`` moved and ``flops`` done."""
    t_b, t_f = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def rel_err(torch, got, ref):
    """(max |got - ref|, that over max |ref|), in fp32."""
    d = (got.float() - ref.float()).abs().max().item()
    return d, d / max(ref.float().abs().max().item(), 1e-30)


def row_rel_err(torch, got, ref):
    """(max |got - ref|, the largest over output rows of max |got - ref| /
    max |ref| within the row), in fp32. A row is one query and head of an
    attention output (the last axis, dh): each row is held to its own
    magnitude, so rows that average many keys (small values) count as much
    as rows that attend one."""
    d = (got.float() - ref.float()).abs()
    per_row = d.amax(-1) / ref.float().abs().amax(-1).clamp_min(1e-30)
    return d.max().item(), per_row.max().item()


def phase_kernels(torch, records):
    import torch.nn.functional as F

    from fastertransformer4codefuse_tpu_torch.ops.attention import (
        prefill_attention_flash, prefill_attention_flash_plain,
    )
    from fastertransformer4codefuse_tpu_torch.ops.flash_decode import (
        flash_chunk_paged, flash_chunk_paged_plain, flash_decode_beam_plain,
        flash_decode_beam_stacked, flash_decode_paged, flash_decode_paged_plain,
        flash_decode_stacked, flash_decode_stacked_plain, gather_beam_rows, gather_pages,
        is_packed, pack_seq_pairs, unpack_seq_pairs,
    )
    from fastertransformer4codefuse_tpu_torch.models.params import QuantizedTensor
    from fastertransformer4codefuse_tpu_torch.ops.quant_matmul import (
        DEFAULT_GEMM, gemm_plan, gemm_tiles, quant_matmul, quant_matmul_plain,
    )
    from fastertransformer4codefuse_tpu_torch.ops.quant_matmul_fused import (
        fused_proj_down, fused_proj_down_plain, fused_qkv_up, fused_qkv_up_plain,
        fused_up_proj_down, fused_up_proj_down_plain,
    )
    from fastertransformer4codefuse_tpu_torch.ops.quant_matmul_w4 import (
        quant_matmul_w4, quant_matmul_w4_group, quant_matmul_w4_group_plain,
        quant_matmul_w4_head, quant_matmul_w4_head_plain, quant_matmul_w4_plain,
    )
    from fastertransformer4codefuse_tpu_torch.ops.sliding_window import (
        sliding_window_attention, sliding_window_attention_plain,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    H, F_ = 5120, 20480

    def i8(*shape):
        return torch.empty(shape, dtype=torch.int8, device=dev).random_(-128, 128, generator=gen)

    def scale(n):
        return torch.empty(n, device=dev).uniform_(0.5, 1.5, generator=gen) * (0.02 / 127)

    def bf(*shape, std=1.0):
        return (torch.randn(shape, device=dev, generator=gen) * std).to(torch.bfloat16)

    ok = True

    def report(name, case, fn_k, fn_p, tol, ms_key, work=None, fn_lib=None, lib_label="",
               err=rel_err, fn_pair=None, pair_label="", peers=(), note=""):
        """Check one case and time it; the record's case (``ms_key``) fills the
        record. ``work`` = (bytes read, operations): the output's bytes are
        added and the bound and the kernel's share of it logged. ``err``
        gives (max abs error, the relative error held to ``tol``). A kernel
        with two outputs returns a tuple, held as their concatenation.
        ``fn_pair``: the unfused kernels this one replaces, timed beside it;
        ``fn_lib``: the library call, timed at every case given; ``peers``:
        (label, ms) of kernels timed earlier in this run, logged beside;
        ``note`` ends the line. Returns the kernel's time."""
        nonlocal ok
        got, ref = fn_k(), fn_p()
        torch.cuda.synchronize()
        if isinstance(got, tuple):
            got, ref = torch.cat(got, 1), torch.cat(ref, 1)
        absd, rel = err(torch, got, ref)
        finite = bool(torch.isfinite(got.float()).all())
        passed = finite and rel < tol
        ok &= passed
        t_k = device_time_ms(torch, fn_k)
        t_p = device_time_ms(torch, fn_p)
        line = (f"  {name:18s} {case:34s} max_abs {absd:.3e} rel {rel:.2e} (tol {tol:g}) "
                f"{'ok' if passed else 'MISS'}  kernel {t_k:.4f} ms  plain {t_p:.4f} ms")
        r = records[name]
        r["max_abs_err"] = max(r["max_abs_err"], absd)
        if work is not None:
            b_ms, b_by = bound(work[0] + nbytes(got), work[1])
            line += f"  bound {b_ms:.4f} ms ({b_by}; {b_ms / t_k:.1%} of it)"
        if fn_pair is not None:
            t_pair = device_time_ms(torch, fn_pair)
            line += f"  replaces {pair_label}: {t_pair:.4f} ms"
        t_lib = None
        if fn_lib is not None:
            t_lib = device_time_ms(torch, fn_lib)
            line += f"  library {t_lib:.4f} ms ({lib_label}; kernel {t_k / t_lib:.2f}x)"
        elif lib_label:
            line += f"  library: {lib_label}"
        for label, ms in peers:
            line += f"  beside {label} {ms:.4f} ms ({t_k / ms:.2f}x)"
        line += note
        if case == ms_key:
            r["ms"], r["plain_ms"] = t_k, t_p
            r["bound_ms"], r["bound_by"] = b_ms, b_by
            if fn_pair is not None:
                r["replaced_pair_ms"] = t_pair
            r["library_ms"] = t_lib
            if lib_label:
                r["library"] = lib_label
        log(line)
        return t_k

    def library_mm(bits, M, K, N, G=0):
        """(fn, label): one PyTorch call computing a weight-only GEMM of these
        shapes (int8 per-channel: torch._weight_int8pack_mm; int4 per-channel
        or by groups: torch._weight_int4pack_mm, a per-channel scale being
        equal groups of 256), or (None, why not) where none runs on the card.
        Random weights: it is timed, never compared."""
        x = bf(M, K)
        name = "torch._weight_int8pack_mm" if bits == 8 else "torch._weight_int4pack_mm"
        try:
            if bits == 8:
                w, s = i8(N, K), scale(N).to(torch.bfloat16)
                fn = lambda: torch._weight_int8pack_mm(x, w, s)  # noqa: E731
            else:
                g = G or 256
                u8 = torch.randint(0, 256, (N, K // 2), dtype=torch.uint8, device=dev,
                                   generator=gen)
                w = torch._convert_weight_to_int4pack(u8, 8)
                sz = torch.ones(K // g, N, 2, dtype=torch.bfloat16, device=dev)
                fn = lambda: torch._weight_int4pack_mm(x, w, g, sz)  # noqa: E731
                name += f" (groups of {g})"
            fn()
            torch.cuda.synchronize()
            return fn, name
        except (RuntimeError, NotImplementedError, AttributeError, TypeError) as e:
            why = (str(e).strip().splitlines() or [type(e).__name__])[0][:100]
            return None, f"none on CUDA, torch {torch.__version__} (checked: {name}: {why})"

    log("phase 2: kernels against their plain versions (CodeFuse-13B, StarCoder and "
        "Longformer-base shapes)")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    # The prefill-width GEMM (M > 32): its plan from the tile cache (kernel
    # ``kernel`` over K x (N1 + N2), group size G), its tiles and waves on
    # this card, and its yardstick, one torch.matmul on a bf16 weight
    # dequantized beforehand (the port never calls it)
    def tiles(M, N1, N2=0, kernel="", K=H, G=0):
        plan = gemm_plan(kernel, M, K, N1 + N2, G, dev) if kernel else DEFAULT_GEMM
        n = gemm_tiles(M, N1, N2, plan)
        return (f"  GEMM {n} tiles of {plan.rows}x{plan.cols} (group_m {plan.group_m}, "
                f"stages {plan.stages}), {n / sms:.2f} waves on {sms} SMs")

    lib_bf16 = "torch.matmul, bf16 weight dequantized beforehand"

    def gemm_lib(M, x, wb, lib=lambda: (None, "")):
        """(fn, label) of a case's library call: the bf16 yardstick at M >
        32, ``lib()`` (a weight-only library call or none) at GEMV widths."""
        return ((lambda: torch.matmul(x, wb)), lib_bf16) if M > 32 else lib()

    # K1: bf16 output rounding (2^-8 relative) + fp32 summation order; the
    # library call beside the QKV cases at GEMV widths
    tol_mm = 1e-2
    shapes = [("qkv", H, 3 * H, True, None), ("up", H, F_, True, "gelu-tanh"),
              ("down", F_, H, False, None), ("proj", H, H, True, None)]
    # M = 8, the pools' width, and 32, the GEMV ceiling (QKV): the
    # tensor-core body; 1024 (a chunk tick) and 3072 (the 3000-token
    # prefill): the GEMM
    k1_widths = {"qkv": (1, 4, 8, 32, 512), "up": (1, 4, 8, 512),
                 "down": (1, 4, 8, 512, 1024, 3072), "proj": (1024, 3072)}
    for tag, K, N, has_bias, act in shapes:
        w, s = i8(K, N), scale(N)
        wb = (w.float() * s).to(torch.bfloat16)
        b = bf(N, std=0.02) if has_bias else None
        for M in k1_widths[tag]:
            x = bf(M, K)
            lib = gemm_lib(M, x, wb, (lambda: library_mm(8, M, K, N)) if tag == "qkv"
                           else (lambda: (None, "")))
            report("quant_matmul", f"{tag} {K}->{N} M={M}",
                   lambda: quant_matmul(x, w, s, b, act),
                   lambda: quant_matmul_plain(x, w, s, b, act), tol_mm, "qkv 5120->15360 M=1",
                   work=(nbytes(x, w, s, b), 2 * M * K * N), fn_lib=lib[0], lib_label=lib[1],
                   note=tiles(M, N, kernel="gemm_i8", K=K) if M > 32 else "")
        del wb
    # K1 at StarCoder's widths (6144 wide, MQA QKV 6144 + 2 x 128 = 6400,
    # FFN 24576, biases everywhere): a decode step (M = 1), a pool tick (8)
    # and the 1000-token prefill (the GEMM)
    star = [("qkv", 6144, 6400, "none"), ("up", 6144, 24576, "gelu-tanh"),
            ("down", 24576, 6144, "none"), ("proj", 6144, 6144, "none")]
    for tag, K, N, act in star:
        act = None if act == "none" else act
        w, s, b = i8(K, N), scale(N), bf(N, std=0.02)
        wb = (w.float() * s).to(torch.bfloat16)
        for M in (1, 8, 1000):
            x = bf(M, K)
            lib = gemm_lib(M, x, wb)
            report("quant_matmul", f"StarCoder {tag} {K}->{N} M={M}",
                   lambda: quant_matmul(x, w, s, b, act),
                   lambda: quant_matmul_plain(x, w, s, b, act), tol_mm, "qkv 5120->15360 M=1",
                   work=(nbytes(x, w, s, b), 2 * M * K * N), fn_lib=lib[0], lib_label=lib[1],
                   note=tiles(M, N, kernel="gemm_i8", K=K) if M > 32 else "")
        del w, wb
    w_up, w_proj, w_down = i8(H, F_), i8(H, H), i8(F_, H)
    s_up, s_proj, s_down = scale(F_), scale(H), scale(H)
    b_up, b_down = bf(F_, std=0.02), bf(H, std=0.02)
    k3_ms = {}  # (format, M) -> K3's time, beside the group-scaled K3 below
    for M in (1, 4, 8):
        x_up, x_proj, res, h = bf(M, H), bf(M, H), bf(M, H), bf(M, F_, std=0.5)
        k3_ms["int8", M] = report("fused_proj_down", f"proj+down M={M}",
               lambda: fused_proj_down(x_proj, h, w_proj, w_down, s_proj, s_down, b_down, res),
               lambda: fused_proj_down_plain(x_proj, h, w_proj, w_down, s_proj, s_down,
                                             b_down, res), tol_mm, "proj+down M=1",
               work=(nbytes(x_proj, h, w_proj, w_down, s_proj, s_down, b_down, res),
                     2 * M * (H * H + F_ * H)))
        if M == 8:
            continue  # K2 (off the served routes) at M = 1 and 4 only
        # the bf16 hidden may round differently in the two versions: 2e-2
        report("fused_up_proj_down", f"up+proj+down M={M}",
               lambda: fused_up_proj_down(x_up, x_proj, res, w_up, w_proj, w_down, s_up, s_proj,
                                          s_down, b_up, b_down, "gelu-tanh"),
               lambda: fused_up_proj_down_plain(x_up, x_proj, res, w_up, w_proj, w_down, s_up,
                                                s_proj, s_down, b_up, b_down, "gelu-tanh"),
               2e-2, "up+proj+down M=1",
               work=(nbytes(x_up, x_proj, res, w_up, w_proj, w_down, s_up, s_proj, s_down, b_up,
                            b_down), 2 * M * (H * F_ + H * H + F_ * H)))
    # K6/K7: bf16 output rounding + fp32 summation order
    def scale4(n):
        return torch.empty(n, device=dev).uniform_(0.5, 1.5, generator=gen) * (0.02 / 7)

    # The library call beside the QKV cases; K7 beside K6 on the same x
    G = 128

    def dequant4(p, sc, G=0):  # a packed int4 weight dequantized to bf16
        return QuantizedTensor(q=p, scale=sc, k_axis=-2, group_size=G,
                               bits=4).dequantize().to(torch.bfloat16)

    for tag, K, N, has_bias, act in shapes[:3]:
        p4, s4 = i8(K // 2, N), scale4(N)
        gs = (torch.empty(K // G, N, device=dev).uniform_(0.5, 1.5, generator=gen)
              * (0.02 / 7)).to(torch.bfloat16)
        wb4, wbg = dequant4(p4, s4), dequant4(p4, gs, G)
        b = bf(N, std=0.02) if has_bias else None
        for M in (1, 4, 8, 32, 512, 1024) if tag == "qkv" else (1, 4, 8, 512):
            x = bf(M, K)
            first = tag == "qkv"
            lib = gemm_lib(M, x, wb4, (lambda: library_mm(4, M, K, N)) if first
                           else (lambda: (None, "")))
            t6 = report("quant_matmul_w4", f"{tag} {K}->{N} M={M}",
                   lambda: quant_matmul_w4(x, p4, s4, b, act),
                   lambda: quant_matmul_w4_plain(x, p4, s4, b, act), tol_mm,
                   "qkv 5120->15360 M=1", work=(nbytes(x, p4, s4, b), 2 * M * K * N),
                   fn_lib=lib[0], lib_label=lib[1],
                   note=tiles(M, N, kernel="gemm_i4", K=K) if M > 32 else "")
            if M == 32:
                continue  # K7 at 32 rows: the row-independence check below
            lib = gemm_lib(M, x, wbg, (lambda: library_mm(4, M, K, N, G)) if first
                           else (lambda: (None, "")))
            report("quant_matmul_w4_group", f"{tag} {K}->{N} g{G} M={M}",
                   lambda: quant_matmul_w4_group(x, p4, gs, G, b, act),
                   lambda: quant_matmul_w4_group_plain(x, p4, gs, G, b, act), tol_mm,
                   "qkv 5120->15360 g128 M=1", work=(nbytes(x, p4, gs, b), 2 * M * K * N),
                   fn_lib=lib[0], lib_label=lib[1], peers=[("K6", t6)],
                   note=tiles(M, N, kernel="gemm_i4g", K=K, G=G) if M > 32 else "")
        del wb4, wbg
    # K8: fp32 logits; only the summation order differs
    Vp = 102400
    p_head, s_head = i8(H // 2, Vp), scale4(Vp)
    wb_head = dequant4(p_head, s_head)
    for M in (1, 4, 8, 64):  # 64: the GEMM (a beam prefill's head, 8 rows x 8 beams)
        x = bf(M, H)
        lib = gemm_lib(M, x, wb_head, lambda: library_mm(4, M, H, Vp))
        report("quant_matmul_w4_head", f"head {H}->{Vp} M={M}",
               lambda: quant_matmul_w4_head(x, p_head, s_head),
               lambda: quant_matmul_w4_head_plain(x, p_head, s_head), 1e-4,
               f"head {H}->{Vp} M=1", work=(nbytes(x, p_head, s_head), 2 * M * H * Vp),
               fn_lib=lib[0], lib_label=lib[1],
               note=tiles(M, Vp, kernel="gemm_i4") if M > 32 else "")
    del p_head, wb_head
    # K2/K3 on per-channel int4 weights (their records keep the int8 times)
    w_up, w_proj, w_down = i8(H // 2, F_), i8(H // 2, H), i8(F_ // 2, H)
    s_up, s_proj, s_down = scale4(F_), scale4(H), scale4(H)
    for M in (1, 4, 8):
        x_up, x_proj, res, h = bf(M, H), bf(M, H), bf(M, H), bf(M, F_, std=0.5)
        k3_ms["int4", M] = report("fused_proj_down", f"int4 proj+down M={M}",
               lambda: fused_proj_down(x_proj, h, w_proj, w_down, s_proj, s_down, b_down, res,
                                       bits=4),
               lambda: fused_proj_down_plain(x_proj, h, w_proj, w_down, s_proj, s_down,
                                             b_down, res, bits=4), tol_mm, "proj+down M=1",
               work=(nbytes(x_proj, h, w_proj, w_down, s_proj, s_down, b_down, res),
                     2 * M * (H * H + F_ * H)))
        if M == 8:
            continue
        report("fused_up_proj_down", f"int4 up+proj+down M={M}",
               lambda: fused_up_proj_down(x_up, x_proj, res, w_up, w_proj, w_down, s_up, s_proj,
                                          s_down, b_up, b_down, "gelu-tanh", bits=4),
               lambda: fused_up_proj_down_plain(x_up, x_proj, res, w_up, w_proj, w_down, s_up,
                                                s_proj, s_down, b_up, b_down, "gelu-tanh",
                                                bits=4),
               2e-2, "up+proj+down M=1")
    del w_up, w_proj, w_down

    # K2/K3 with group scales (G = 128): int4 with bf16 scales (the g128
    # checkpoint's decode) and int8 with fp32 scales (the JAX package's
    # group-wise cases); K3 int4 beside the K7 pair it replaces
    def gscale(k, n, qmax, dtype):
        return (torch.empty(k // G, n, device=dev).uniform_(0.5, 1.5, generator=gen)
                * (0.02 / qmax)).to(dtype)

    for bits, qmax, sdt in ((4, 7, torch.bfloat16), (8, 127, torch.float32)):
        pk = (lambda k: k // 2) if bits == 4 else (lambda k: k)
        w_up, w_proj, w_down = i8(pk(H), F_), i8(pk(H), H), i8(pk(F_), H)
        g_up, g_proj, g_down = (gscale(H, F_, qmax, sdt), gscale(H, H, qmax, sdt),
                                gscale(F_, H, qmax, sdt))
        tag = f"int{bits} g{G}"
        for M in (1, 4, 8):
            x_up, x_proj, res, h = bf(M, H), bf(M, H), bf(M, H), bf(M, F_, std=0.5)
            args3 = (x_proj, h, w_proj, w_down, g_proj, g_down, b_down, res, bits, G)
            pair = None
            if bits == 4:
                pair = lambda: (quant_matmul_w4_group(x_proj, w_proj, g_proj, G),  # noqa: E731
                                quant_matmul_w4_group(h, w_down, g_down, G))
            report("fused_proj_down", f"{tag} proj+down M={M}",
                   lambda: fused_proj_down(*args3), lambda: fused_proj_down_plain(*args3),
                   tol_mm, "proj+down M=1",
                   work=(nbytes(x_proj, h, w_proj, w_down, g_proj, g_down, b_down, res),
                         2 * M * (H * H + F_ * H)), fn_pair=pair, pair_label="K7 proj + K7 down",
                   peers=[(f"K3 int{bits} per-channel", k3_ms[f"int{bits}", M])])
            if M == 8:
                continue
            args2 = (x_up, x_proj, res, w_up, w_proj, w_down, g_up, g_proj, g_down, b_up, b_down,
                     "gelu-tanh", bits, G)
            report("fused_up_proj_down", f"{tag} up+proj+down M={M}",
                   lambda: fused_up_proj_down(*args2), lambda: fused_up_proj_down_plain(*args2),
                   2e-2, "up+proj+down M=1",
                   work=(nbytes(x_up, x_proj, res, w_up, w_proj, w_down, g_up, g_proj, g_down,
                                b_up, b_down), 2 * M * (H * F_ + H * H + F_ * H)))
        del w_up, w_proj, w_down

    # K13: QKV (from ln1) and up with its activation (from ln2) over joined
    # output columns: int8, int4, int4 g128; the GEMV form at M = 1 and 4,
    # the GEMM form at M = 512, 1024 and 3072 (int4 per-channel at 512), each
    # beside the pair of unfused GEMMs it replaces (K1 QKV + K1 up; K6 + K6;
    # K7 + K7) timed the same way
    b_q, b_u = bf(3 * H, std=0.02), bf(F_, std=0.02)
    k13_int4_ms = {}  # M -> K13 int4 per-channel, beside K13 g128
    for bits, G13, lab, fmt13 in ((8, 0, "int8", "i8"), (4, 0, "int4", "i4"),
                                  (4, G, "int4 g128", "i4g")):
        if bits == 8:
            wq, sq, wu, su = i8(H, 3 * H), scale(3 * H), i8(H, F_), scale(F_)
            single = lambda x, w, s, b, act=None: quant_matmul(x, w, s, b, act)  # noqa: E731
            pair_label = "K1 QKV + K1 up"
        elif not G13:
            wq, sq, wu, su = i8(H // 2, 3 * H), scale4(3 * H), i8(H // 2, F_), scale4(F_)
            single = lambda x, w, s, b, act=None: quant_matmul_w4(x, w, s, b, act)  # noqa: E731
            pair_label = "K6 QKV + K6 up"
        else:
            wq, wu = i8(H // 2, 3 * H), i8(H // 2, F_)
            sq, su = gscale(H, 3 * H, 7, torch.bfloat16), gscale(H, F_, 7, torch.bfloat16)
            single = (lambda x, w, s, b, act=None:  # noqa: E731
                      quant_matmul_w4_group(x, w, s, G, b, act))
            pair_label = "K7 QKV + K7 up"
        # the GEMM form's yardstick: the two matmuls (x1 @ Wqkv, x2 @ Wup) on
        # bf16 weights dequantized beforehand, since the two products take
        # different x (ln1 and ln2 under the parallel residual)
        if bits == 8:
            wqb, wub = (wq.float() * sq).to(torch.bfloat16), (wu.float() * su).to(torch.bfloat16)
        else:
            wqb, wub = dequant4(wq, sq, G13), dequant4(wu, su, G13)
        Ms = {"int8": (1, 4, 8, 32, 512, 1024, 3072), "int4": (1, 4, 8, 512),
              "int4 g128": (1, 4, 8, 512, 1024, 3072)}[lab]
        for M in Ms:
            x1, x2 = bf(M, H), bf(M, H)
            args = (x1, x2, wq, wu, sq, su, b_q, b_u, None, "gelu-tanh", bits, G13)
            peers = [("K13 int4", k13_int4_ms[M])] if G13 and M in k13_int4_ms else []
            lib = (((lambda: (torch.matmul(x1, wqb), torch.matmul(x2, wub))),
                    "two torch.matmul, x1 @ Wqkv + x2 @ Wup, bf16 weights dequantized "
                    "beforehand") if M > 32 else
                   (None, "none: no one PyTorch call computes it"))
            t13 = report("fused_qkv_up", f"{lab} {H}->{3 * H}|{F_} M={M}",
                   lambda: fused_qkv_up(*args), lambda: fused_qkv_up_plain(*args), tol_mm,
                   f"int8 {H}->{3 * H}|{F_} M=1",
                   work=(nbytes(x1, x2, wq, sq, wu, su, b_q, b_u), 2 * M * H * (3 * H + F_)),
                   fn_pair=lambda: (single(x1, wq, sq, b_q), single(x2, wu, su, b_u, "gelu-tanh")),
                   pair_label=pair_label, fn_lib=lib[0], lib_label=lib[1], peers=peers,
                   note=tiles(M, 3 * H, F_, kernel=f"ncat_gemm_{fmt13}", G=G13) if M > 32
                   else "")
            if lab == "int4":
                k13_int4_ms[M] = t13
            del x1, x2
        del wq, wu, wqb, wub

    # The int4 instances with fp32 group scales (the JAX package's
    # FTCF_GSCALE_BF16=0): K7 and K13 at M = 1, 4, 8 and the GEMM at 512 and
    # 1024, K3 at 1, 4 and 8, K2 (off the served routes) at 1 and 4; each
    # beside its bf16-scale instance on the same payload and x, with the
    # scales rounded to bf16
    def f32_pair(k, n):
        g = gscale(k, n, 7, torch.float32)
        return g, g.to(torch.bfloat16)

    p_q, p_u, p_p, p_d = i8(H // 2, 3 * H), i8(H // 2, F_), i8(H // 2, H), i8(F_ // 2, H)
    (g_q, g_q16), (g_u, g_u16), (g_p, g_p16), (g_d, g_d16) = (
        f32_pair(H, 3 * H), f32_pair(H, F_), f32_pair(H, H), f32_pair(F_, H))
    none = "none: no one PyTorch call computes it"
    for M in (1, 4, 8, 512, 1024):
        x, x2 = bf(M, H), bf(M, H)
        t16 = device_time_ms(torch, lambda: quant_matmul_w4_group(x, p_q, g_q16, G, b_q))
        lib = gemm_lib(M, x, dequant4(p_q, g_q, G) if M > 32 else None,
                       lambda: library_mm(4, M, H, 3 * H, G))
        report("quant_matmul_w4_group_f32", f"qkv {H}->{3 * H} g128 fp32 M={M}",
               lambda: quant_matmul_w4_group(x, p_q, g_q, G, b_q),
               lambda: quant_matmul_w4_group_plain(x, p_q, g_q, G, b_q), tol_mm,
               f"qkv {H}->{3 * H} g128 fp32 M=1",
               work=(nbytes(x, p_q, g_q, b_q), 2 * M * H * 3 * H), fn_lib=lib[0],
               lib_label=lib[1], peers=[("its bf16-scale instance", t16)],
               note=tiles(M, 3 * H, kernel="gemm_i4gf", G=G) if M > 32 else "")
        del lib
        args = (x, x2, p_q, p_u, g_q, g_u, b_q, b_u, None, "gelu-tanh", 4, G)
        args16 = (x, x2, p_q, p_u, g_q16, g_u16, b_q, b_u, None, "gelu-tanh", 4, G)
        t16 = device_time_ms(torch, lambda: fused_qkv_up(*args16))
        lib = (None, none)
        if M > 32:
            wqb, wub = dequant4(p_q, g_q, G), dequant4(p_u, g_u, G)
            lib = ((lambda: (torch.matmul(x, wqb), torch.matmul(x2, wub))),
                   "two torch.matmul, x1 @ Wqkv + x2 @ Wup, bf16 weights dequantized beforehand")
        report("fused_qkv_up_f32", f"int4 g128 fp32 {H}->{3 * H}|{F_} M={M}",
               lambda: fused_qkv_up(*args), lambda: fused_qkv_up_plain(*args), tol_mm,
               f"int4 g128 fp32 {H}->{3 * H}|{F_} M=1",
               work=(nbytes(x, x2, p_q, g_q, p_u, g_u, b_q, b_u), 2 * M * H * (3 * H + F_)),
               fn_lib=lib[0], lib_label=lib[1], peers=[("its bf16-scale instance", t16)],
               note=tiles(M, 3 * H, F_, kernel="ncat_gemm_i4gf", G=G) if M > 32 else "")
        del lib
        if M > 8:
            continue
        x_p, h, res = bf(M, H), bf(M, F_, std=0.5), bf(M, H)
        args3 = (x_p, h, p_p, p_d, g_p, g_d, b_down, res, 4, G)
        args3_16 = (x_p, h, p_p, p_d, g_p16, g_d16, b_down, res, 4, G)
        t16 = device_time_ms(torch, lambda: fused_proj_down(*args3_16))
        report("fused_proj_down_f32", f"int4 g128 fp32 proj+down M={M}",
               lambda: fused_proj_down(*args3), lambda: fused_proj_down_plain(*args3), tol_mm,
               "int4 g128 fp32 proj+down M=1",
               work=(nbytes(x_p, h, p_p, p_d, g_p, g_d, b_down, res),
                     2 * M * (H * H + F_ * H)), lib_label=none,
               peers=[("its bf16-scale instance", t16)])
        if M == 8:
            continue
        args2 = (x2, x_p, res, p_u, p_p, p_d, g_u, g_p, g_d, b_u, b_down, "gelu-tanh", 4, G)
        args2_16 = (x2, x_p, res, p_u, p_p, p_d, g_u16, g_p16, g_d16, b_u, b_down, "gelu-tanh",
                    4, G)
        t16 = device_time_ms(torch, lambda: fused_up_proj_down(*args2_16))
        report("fused_up_proj_down_f32", f"int4 g128 fp32 up+proj+down M={M}",
               lambda: fused_up_proj_down(*args2), lambda: fused_up_proj_down_plain(*args2),
               2e-2, "int4 g128 fp32 up+proj+down M=1",
               work=(nbytes(x2, x_p, res, p_u, p_p, p_d, g_u, g_p, g_d, b_u, b_down),
                     2 * M * (H * F_ + H * H + F_ * H)), lib_label=none,
               peers=[("its bf16-scale instance", t16)])
    del p_q, p_u, p_p, p_d

    # Item 11's group-wise forms, which no served model makes (hand-built
    # weights at CodeFuse-13B's widths, G = 128): K1 and K13 on int8 weights
    # with fp32 group scales (W_I8G: the GEMV at M = 1 and 4, the TMA +
    # wgmma GEMM at 1024), and K7 with fp32 out as the group-wise transposed
    # int4 head [H/2, V_pad]
    def dequant8g(w, g):  # an int8 weight with group scales dequantized to bf16
        return QuantizedTensor(q=w, scale=g, k_axis=-2, group_size=G,
                               bits=8).dequantize().to(torch.bfloat16)

    V_pad = 102400  # CodeFuse-13B's 100831 padded to a multiple of 2560
    q8, u8 = i8(H, 3 * H), i8(H, F_)
    gq8, gu8 = gscale(H, 3 * H, 127, torch.float32), gscale(H, F_, 127, torch.float32)
    p_h, g_h = i8(H // 2, V_pad), gscale(H, V_pad, 7, torch.bfloat16)
    wq8b, wu8b, wh_b = dequant8g(q8, gq8), dequant8g(u8, gu8), dequant4(p_h, g_h, G)
    for M in (1, 4, 1024):
        x, x2 = bf(M, H), bf(M, H)
        big = M > 32
        report("quant_matmul_g8", f"qkv {H}->{3 * H} int8 g128 M={M}",
               lambda: quant_matmul(x, q8, gq8, b_q, group_size=G),
               lambda: quant_matmul_plain(x, q8, gq8, b_q, group_size=G), tol_mm,
               f"qkv {H}->{3 * H} int8 g128 M=1",
               work=(nbytes(x, q8, gq8, b_q), 2 * M * H * 3 * H),
               fn_lib=(lambda: torch.matmul(x, wq8b)) if big else None,
               lib_label=lib_bf16 if big else none,
               note=tiles(M, 3 * H, kernel="gemm_i8g", G=G) if big else "")
        args = (x, x2, q8, u8, gq8, gu8, b_q, b_u, None, "gelu-tanh", 8, G)
        report("fused_qkv_up_g8", f"int8 g128 {H}->{3 * H}|{F_} M={M}",
               lambda: fused_qkv_up(*args), lambda: fused_qkv_up_plain(*args), tol_mm,
               f"int8 g128 {H}->{3 * H}|{F_} M=1024",
               work=(nbytes(x, x2, q8, gq8, u8, gu8, b_q, b_u), 2 * M * H * (3 * H + F_)),
               fn_lib=(lambda: (torch.matmul(x, wq8b), torch.matmul(x2, wu8b))) if big else None,
               lib_label=("two torch.matmul, x1 @ Wqkv + x2 @ Wup, bf16 weights dequantized "
                          "beforehand") if big else none,
               note=tiles(M, 3 * H, F_, kernel="ncat_gemm_i8g", G=G) if big else "")
        report("quant_matmul_w4_group_head", f"head {H}->{V_pad} int4 g128 M={M}",
               lambda: quant_matmul_w4_group(x, p_h, g_h, G, out_dtype=torch.float32),
               lambda: quant_matmul_w4_group_plain(x.float(), p_h, g_h, G), tol_mm,
               f"head {H}->{V_pad} int4 g128 M=1", work=(nbytes(x, p_h, g_h), 2 * M * H * V_pad),
               fn_lib=(lambda: torch.matmul(x, wh_b)) if big else None,
               lib_label=lib_bf16 if big else none,
               note=tiles(M, V_pad, kernel="gemm_i4g", G=G) if big else "")
        del x, x2
    del q8, u8, gq8, gu8, p_h, g_h, wq8b, wu8b, wh_b

    # Row independence of the GEMV's tensor-core body at CodeFuse-13B shapes:
    # row r of K6, K7 and K13 int8 is bit for bit the same at M = 2, 4, 8
    # and 32 (the first M of the same 32 x rows)
    x32, x32b = bf(32, H), bf(32, H)
    p4, s4, g4 = i8(H // 2, 3 * H), scale4(3 * H), gscale(H, 3 * H, 7, torch.bfloat16)
    wq, sq, wu, su = i8(H, 3 * H), scale(3 * H), i8(H, F_), scale(F_)
    by_width = {
        "quant_matmul_w4 (K6)": lambda M: quant_matmul_w4(x32[:M], p4, s4, b_q),
        "quant_matmul_w4_group (K7)": lambda M: quant_matmul_w4_group(x32[:M], p4, g4, G, b_q),
        "fused_qkv_up int8 (K13)": lambda M: torch.cat(fused_qkv_up(
            x32[:M], x32b[:M], wq, wu, sq, su, b_q, b_u, None, "gelu-tanh"), 1),
    }
    for name, fn in by_width.items():
        full = fn(32)
        differ = [M for M in (2, 4, 8) if not torch.equal(fn(M), full[:M])]
        ok &= not differ
        log(f"  row independence {name}: rows at M = 2, 4, 8 vs the same rows at M = 32: "
            + (f"MISS, M = {differ} differ" if differ else "bit for bit equal"))
    # ... and of the GEMM: its 130 rows at M = 130 are the first 130 of M =
    # 1024 bit for bit, and two calls give equal bytes
    x1k, x2k = bf(1024, H), bf(1024, H)
    by_rows = {
        "quant_matmul (K1)": lambda M: quant_matmul(x1k[:M], wq, sq, b_q),
        "quant_matmul_w4_group (K7)": lambda M: quant_matmul_w4_group(x1k[:M], p4, g4, G, b_q),
        "fused_qkv_up int8 (K13)": lambda M: torch.cat(fused_qkv_up(
            x1k[:M], x2k[:M], wq, wu, sq, su, b_q, b_u, None, "gelu-tanh"), 1),
    }
    for name, fn in by_rows.items():
        full, again, part = fn(1024), fn(1024), fn(130)
        rows_same, calls_same = torch.equal(part, full[:130]), torch.equal(full, again)
        ok &= rows_same and calls_same
        log(f"  GEMM {name}: rows at M = 130 vs the same rows at M = 1024: "
            f"{'bit for bit equal' if rows_same else 'MISS, they differ'}; two calls at M = "
            f"1024: {'equal bytes' if calls_same else 'MISS, they differ'}")

    # Host cost of one call (the wrapper, the tensor maps it encodes, the
    # launch), enqueued behind a busy card: the GEMV encodes none, a GEMM two
    # a segment (x, weight) and three with group scales
    def host_us(fn, n=40):
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(200_000_000)
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        t = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
        return t

    costs = {
        "K1 GEMV M=8 (no maps)": lambda: quant_matmul(x1k[:8], wq, sq, b_q),
        "K1 GEMM M=1024 (2 maps)": lambda: quant_matmul(x1k, wq, sq, b_q),
        "K7 GEMM M=1024 (3 maps)": lambda: quant_matmul_w4_group(x1k, p4, g4, G, b_q),
        "K13 int8 GEMM M=1024 (4 maps)": lambda: fused_qkv_up(
            x1k, x2k, wq, wu, sq, su, b_q, b_u, None, "gelu-tanh"),
    }
    log("  host us a call (median of 3 runs of 40 calls, enqueued behind a busy card): " +
        ", ".join(f"{k} {statistics.median(host_us(f) for _ in range(3)):.1f}"
                  for k, f in costs.items()))
    del p4, wq, wu, x1k, x2k

    # Attention kernels: p (times v_s) rounded to bf16 before PV in both
    # versions; online vs full softmax order. Each (query, head) row of the
    # output is held to its own magnitude (``row_rel_err``). The yardstick is
    # one scaled_dot_product_attention call on a dense bf16 K/V of the same
    # length (the int8 cache dequantized beforehand), masked per row.
    def report_attn(*a, **kw):
        report(*a, err=row_rel_err, **kw)

    def dense_bf16(k, ks):
        return (k.float() * ks.float()[..., None]).to(torch.bfloat16) if ks is not None else k

    def sdpa(qh, kd, vd, mask, sm):
        return lambda: F.scaled_dot_product_attention(qh, kd, vd, attn_mask=mask, scale=sm)

    # K4: dense cache, B = 4, S = 1152, ragged positions
    B, nH, dh, S, L = 4, 40, 128, 1152, 2
    pos = torch.tensor([10, S - 1, 500, 777], dtype=torch.int32, device=dev)
    n_keys = int((pos + 1).sum())
    q = bf(B, nH, dh)
    k8, v8 = i8(L, B, nH, S, dh), i8(L, B, nH, S, dh)
    ks = (torch.rand((L, B, nH, S), device=dev, generator=gen) * 0.02).to(torch.bfloat16)
    vs = (torch.rand((L, B, nH, S), device=dev, generator=gen) * 0.02).to(torch.bfloat16)
    kb, vb = bf(L, B, nH, S, dh), bf(L, B, nH, S, dh)
    sm = 1.0 / dh ** 0.5
    mask = (torch.arange(S, device=dev)[None, :] <= pos[:, None].long())[:, None, None, :]
    report_attn("flash_decode", "int8 cache B=4 S=1152",
           lambda: flash_decode_stacked(q, k8, ks, v8, vs, 1, pos, sm),
           lambda: flash_decode_stacked_plain(q, k8, ks, v8, vs, 1, pos, sm), 2e-2,
           "int8 cache B=4 S=1152",
           work=(nbytes(q, pos) + n_keys * nH * (2 * dh + 4), 4 * n_keys * nH * dh),
           fn_lib=sdpa(q[:, :, None], dense_bf16(k8[1], ks[1]), dense_bf16(v8[1], vs[1]), mask,
                       sm),
           lib_label="sdpa, dense bf16 K/V of the same length")
    report_attn("flash_decode", "bf16 cache B=4 S=1152",
           lambda: flash_decode_stacked(q, kb, None, vb, None, 1, pos, sm),
           lambda: flash_decode_stacked_plain(q, kb, None, vb, None, 1, pos, sm), 2e-2,
           "int8 cache B=4 S=1152",
           work=(nbytes(q, pos) + n_keys * nH * 4 * dh, 4 * n_keys * nH * dh),
           fn_lib=sdpa(q[:, :, None], kb[1], vb[1], mask, sm),
           lib_label="sdpa, the same bf16 K/V")
    # packed int4: "int4" (K and V) and "int8k_int4v" (V only) over the same
    # positions; the bound counts the packed bytes up to each row's position
    k4, v4 = i8(L, B, nH, S // 2, dh), i8(L, B, nH, S // 2, dh)
    for tag, kk in (("int4", k4), ("int8k_int4v", k8)):
        kbytes = dh // 2 if kk is k4 else dh
        report_attn("flash_decode_int4", f"{tag} cache B=4 S=1152",
               lambda: flash_decode_stacked(q, kk, ks, v4, vs, 1, pos, sm),
               lambda: flash_decode_stacked_plain(q, kk, ks, v4, vs, 1, pos, sm), 2e-2,
               "int4 cache B=4 S=1152",
               work=(nbytes(q, pos) + n_keys * nH * (kbytes + dh // 2 + 4),
                     4 * n_keys * nH * dh),
               fn_lib=sdpa(q[:, :, None], dense_bf16(unpack_seq_pairs(k4[1]), ks[1]),
                           dense_bf16(unpack_seq_pairs(v4[1]), vs[1]), mask, sm),
               lib_label="sdpa, dense bf16 K/V of the same length")
    del k8, v8, kb, vb, k4, v4

    # K4's split-S plan: each row's output at B = 1 is the same row of a B = 8
    # call (positions across 1-5 splits of 256) bit for bit, and two calls
    # give equal bytes
    B8 = 8
    pos8 = torch.tensor([1151, 0, 255, 256, 257, 700, 1000, 64], dtype=torch.int32, device=dev)
    q8 = bf(B8, nH, dh)
    k8, v8 = i8(1, B8, nH, S, dh), i8(1, B8, nH, S, dh)
    ks8, vs8 = [(torch.rand((1, B8, nH, S), device=dev, generator=gen) * 0.02).to(
        torch.bfloat16) for _ in range(2)]
    full = flash_decode_stacked(q8, k8, ks8, v8, vs8, 0, pos8, sm)
    again = flash_decode_stacked(q8, k8, ks8, v8, vs8, 0, pos8, sm)
    rows_same = all(
        torch.equal(full[b], flash_decode_stacked(
            q8[b:b + 1].contiguous(), k8[:, b:b + 1].contiguous(), ks8[:, b:b + 1].contiguous(),
            v8[:, b:b + 1].contiguous(), vs8[:, b:b + 1].contiguous(), 0,
            pos8[b:b + 1].contiguous(), sm)[0]) for b in range(B8))
    calls_same = torch.equal(full, again)
    ok &= rows_same and calls_same
    log(f"  flash_decode       int8 cache: each row at B=1 equals its row at B=8 bit for bit: "
        f"{rows_same}; two calls give {'equal bytes' if calls_same else 'MISS: other bytes'}")
    del k8, v8, ks8, vs8, full, again

    # K4 further shapes: a long prompt at B = 1 (split-S fills the card with
    # one row), GQA with g = 8 at CodeFuse-13B's 40 query heads (5 KV heads),
    # StarCoder's MQA g = 48 (48 x 128 query heads, one KV head), 64-wide heads
    # at CodeFuse-13B's width (80 x 64), and those 80 heads on one KV head
    # (g = 80: two blocks a KV head, 64 and 16 query rows)
    def attn_case(name, case, B, S, nH, nKV, dh, kinds, fn, fn_p, extra=None):
        """K4 (or K9 with ``extra`` = (page table, page size)) over random
        caches of ``kinds``, positions as phase 2's other cases, against
        the plain version, its bound and SDPA on the same bf16 K/V."""
        q = bf(B, nH, dh)
        pos = (torch.tensor([S - 1], dtype=torch.int32, device=dev) if B == 1 else
               torch.tensor(np.linspace(100, S - 48, B).astype(np.int32), device=dev))
        n_keys = int((pos + 1).sum())
        X, n = (B, S) if extra is None else (extra[0].numel() + 1, extra[1])
        mask = (torch.arange(S, device=dev)[None, :] <= pos[:, None].long())[:, None, None, :]
        g = nH // nKV
        for kind in kinds:
            if kind == "bf16":
                k, kss, v, vss = bf(1, X, nKV, n, dh), None, bf(1, X, nKV, n, dh), None
            else:
                k, v = i8(1, X, nKV, n, dh), i8(1, X, nKV, n, dh)
                kss, vss = [(torch.rand((1, X, nKV, n), device=dev, generator=gen) * 0.02).to(
                    torch.bfloat16) for _ in range(2)]
            a = (q, k, kss, v, vss, 0, pos) + ((extra[0],) if extra is not None else ()) + (
                dh ** -0.5,)
            if extra is None:
                kd = dense_bf16(k[0], None if kss is None else kss[0])
                vd = dense_bf16(v[0], None if vss is None else vss[0])
            else:
                kd = dense_bf16(gather_pages(k[0], extra[0]),
                                None if kss is None else gather_pages(kss[0], extra[0]))
                vd = dense_bf16(gather_pages(v[0], extra[0]),
                                None if vss is None else gather_pages(vss[0], extra[0]))
            per_key = 2 * dh * k.element_size() + (4 if kss is not None else 0)
            # SDPA takes the g query heads of a KV head as its g query rows
            qh = q.reshape(B, nKV, g, dh)
            report_attn(name, f"{kind} {case}", lambda: fn(*a), lambda: fn_p(*a), 2e-2,
                        None, work=(nbytes(q, pos) + n_keys * nKV * per_key,
                                    4 * n_keys * nH * dh),
                        fn_lib=sdpa(qh, kd, vd, mask, dh ** -0.5),
                        lib_label="sdpa, dense bf16 K/V, g query rows a KV head")
            del k, v, kd, vd

    attn_case("flash_decode", "B=1 S=4096 40x128", 1, 4096, 40, 40, 128, ("int8",),
              flash_decode_stacked, flash_decode_stacked_plain)
    for nh, nkv in ((40, 5), (48, 1)):
        attn_case("flash_decode", f"B=4 S=1152 {nh}x128 g={nh // nkv}", 4, 1152, nh, nkv, 128,
                  ("int8", "bf16"), flash_decode_stacked, flash_decode_stacked_plain)
    attn_case("flash_decode", "B=4 S=1152 80x64", 4, 1152, 80, 80, 64, ("int8", "bf16"),
              flash_decode_stacked, flash_decode_stacked_plain)
    attn_case("flash_decode", "B=4 S=1152 80x64 g=80", 4, 1152, 80, 1, 64, ("int8",),
              flash_decode_stacked, flash_decode_stacked_plain)
    pt_g = (torch.randperm(64, device=dev, generator=gen) + 1).reshape(8, 8).to(torch.int32)
    for nh, nkv in ((40, 5), (48, 1)):
        attn_case("flash_decode_paged", f"pages B=8 pos 100-2000 {nh}x128 g={nh // nkv}", 8,
                  2048, nh, nkv, 128, ("int8",), flash_decode_paged, flash_decode_paged_plain,
                  extra=(pt_g, 256))

    # K11: beam decode over the dense cache through the indirection, B = 2
    # batches of bw = 4 beams, random indirection, ragged positions; also
    # bit for bit against K4 over the physically gathered copy (one body,
    # the same values read in the same order)
    B, bw, S = 2, 4, 1152
    BB = B * bw
    pos = torch.tensor([1151, 700, 1000, 64, 900, 333, 1100, 512], dtype=torch.int32, device=dev)
    indir = torch.randint(0, bw, (BB, S), generator=gen, device=dev, dtype=torch.int32)
    n_keys = int((pos + 1).sum())
    q = bf(BB, nH, dh)
    mask = (torch.arange(S, device=dev)[None, :] <= pos[:, None].long())[:, None, None, :]
    k8, v8 = i8(L, BB, nH, S, dh), i8(L, BB, nH, S, dh)
    ks = (torch.rand((L, BB, nH, S), device=dev, generator=gen) * 0.02).to(torch.bfloat16)
    vs = (torch.rand((L, BB, nH, S), device=dev, generator=gen) * 0.02).to(torch.bfloat16)
    kb, vb = bf(L, BB, nH, S, dh), bf(L, BB, nH, S, dh)
    k4, v4 = i8(L, BB, nH, S // 2, dh), i8(L, BB, nH, S // 2, dh)

    def resolved(slab, scales=None):  # layer 1 through indir, unpacked: [BB, nKV, S(, dh)]
        if slab is None:
            return None
        packed = scales is not None and is_packed(slab, scales)
        return gather_beam_rows(unpack_seq_pairs(slab[1]) if packed else slab[1], indir, bw)

    beam_cases = (("int8", (k8, ks, v8, vs), 2 * dh + 4), ("bf16", (kb, None, vb, None), 4 * dh),
                  ("int4", (k4, ks, v4, vs), dh + 4))
    for tag, (a, sa, b_, sb), per_key in beam_cases:
        rk, rks, rv, rvs = resolved(a, sa), resolved(sa), resolved(b_, sb), resolved(sb)
        report_attn("flash_decode_beam", f"{tag} cache B=2 bw=4 S=1152",
               lambda: flash_decode_beam_stacked(q, a, sa, b_, sb, 1, pos, indir, bw, sm),
               lambda: flash_decode_beam_plain(q, a, sa, b_, sb, 1, pos, indir, bw, sm), 2e-2,
               "int8 cache B=2 bw=4 S=1152",
               work=(nbytes(q, pos) + 4 * n_keys + n_keys * nH * per_key, 4 * n_keys * nH * dh),
               fn_lib=sdpa(q[:, :, None], dense_bf16(rk, rks), dense_bf16(rv, rvs), mask, sm),
               lib_label="sdpa, dense bf16 K/V of the resolved cache")
        # the gathered copy as a one-layer cache, packed again where it was
        def copy(t, pack=False):
            return None if t is None else (pack_seq_pairs(t) if pack else t)[None].contiguous()

        got = flash_decode_beam_stacked(q, a, sa, b_, sb, 1, pos, indir, bw, sm)
        k4_out = flash_decode_stacked(q, copy(rk, tag == "int4"), copy(rks),
                                      copy(rv, tag == "int4"), copy(rvs), 0, pos, sm)
        torch.cuda.synchronize()
        same = bool(torch.equal(got, k4_out))
        ok &= same
        log(f"  flash_decode_beam  {tag} cache: K11 == K4 over the gathered copy bit for bit: "
            f"{same} (max |diff| {(got.float() - k4_out.float()).abs().max().item():.3e})")
    del k8, v8, kb, vb, k4, v4

    # K9 / K10: CodeFuse-13B pages: 40 KV heads, dh 128, pages of 256, 8
    # slots of logical length 2048 (8 pages each, 65 pages with the garbage
    # page), permuted block tables
    B, nKV, ps, n_pg, L = 8, 40, 256, 8, 2
    S, P = ps * n_pg, 8 * n_pg + 1
    pt = (torch.randperm(P - 1, device=dev, generator=gen) + 1).reshape(B, n_pg).to(torch.int32)
    pk8, pv8 = i8(L, P, nKV, ps, dh), i8(L, P, nKV, ps, dh)
    pks = (torch.rand((L, P, nKV, ps), device=dev, generator=gen) * 0.02).to(torch.bfloat16)
    pvs = (torch.rand((L, P, nKV, ps), device=dev, generator=gen) * 0.02).to(torch.bfloat16)
    pkb, pvb = bf(L, P, nKV, ps, dh), bf(L, P, nKV, ps, dh)

    def dense_pages(pages, scales):  # the layer-1 pages as a dense bf16 [B, nKV, S, dh]
        return dense_bf16(gather_pages(pages[1], pt, is_packed(pages, scales)),
                          None if scales is None else gather_pages(scales[1], pt))

    pos = torch.tensor(np.linspace(100, 2000, B).astype(np.int32), device=dev)
    n_keys = int((pos + 1).sum())
    q = bf(B, nKV, dh)
    mask = (torch.arange(S, device=dev)[None, :] <= pos[:, None].long())[:, None, None, :]
    for tag, (a, sa, b_, sb) in (("int8", (pk8, pks, pv8, pvs)), ("bf16", (pkb, None, pvb, None))):
        per_key = 2 * dh * a.element_size() + (4 if sa is not None else 0)
        report_attn("flash_decode_paged", f"{tag} pages B=8 pos 100-2000",
               lambda: flash_decode_paged(q, a, sa, b_, sb, 1, pos, pt, sm),
               lambda: flash_decode_paged_plain(q, a, sa, b_, sb, 1, pos, pt, sm), 2e-2,
               "int8 pages B=8 pos 100-2000",
               work=(nbytes(q, pos) + B * n_pg * 4 + n_keys * nKV * per_key,
                     4 * n_keys * nKV * dh),
               fn_lib=sdpa(q[:, :, None], dense_pages(a, sa), dense_pages(b_, sb), mask, sm),
               lib_label="sdpa, dense bf16 K/V of the same length")
    pk4, pv4 = i8(L, P, nKV, ps // 2, dh), i8(L, P, nKV, ps // 2, dh)
    packed_pages = (("int4", (pk4, pks, pv4, pvs)), ("int8k_int4v", (pk8, pks, pv4, pvs)))
    for tag, (a, sa, b_, sb) in packed_pages:
        per_key = (dh // 2 if a is pk4 else dh) + dh // 2 + 4
        report_attn("flash_decode_paged_int4", f"{tag} pages B=8 pos 100-2000",
               lambda: flash_decode_paged(q, a, sa, b_, sb, 1, pos, pt, sm),
               lambda: flash_decode_paged_plain(q, a, sa, b_, sb, 1, pos, pt, sm), 2e-2,
               "int4 pages B=8 pos 100-2000",
               work=(nbytes(q, pos) + B * n_pg * 4 + n_keys * nKV * per_key,
                     4 * n_keys * nKV * dh),
               fn_lib=sdpa(q[:, :, None], dense_pages(a, sa), dense_pages(b_, sb), mask, sm),
               lib_label="sdpa, dense bf16 K/V of the same length")
    C = 128
    starts = torch.tensor([0, 128, 384, 640, 896, 1152, 1536, 1920], dtype=torch.int32,
                          device=dev)
    qc = bf(B, C, nKV, dh)
    posc = starts[:, None].long() + torch.arange(C, device=dev)[None, :]  # [B, C]
    mask_c = (torch.arange(S, device=dev)[None, None, :] <= posc[:, :, None])[:, None]
    n_pairs = int((posc + 1).sum())  # (query, key) pairs the causal bounds admit
    n_read = int((starts + C).sum())  # keys each (row, head) reads
    for tag, (a, sa, b_, sb) in (("int8", (pk8, pks, pv8, pvs)), ("bf16", (pkb, None, pvb, None))):
        per_key = 2 * dh * a.element_size() + (4 if sa is not None else 0)
        report_attn("flash_chunk_paged", f"{tag} pages B=8 C=128",
               lambda: flash_chunk_paged(qc, a, sa, b_, sb, 1, starts, pt, sm),
               lambda: flash_chunk_paged_plain(qc, a, sa, b_, sb, 1, starts, pt, sm), 2e-2,
               "int8 pages B=8 C=128",
               work=(nbytes(qc, starts) + B * n_pg * 4 + n_read * nKV * per_key,
                     4 * n_pairs * nKV * dh),
               fn_lib=sdpa(qc.transpose(1, 2), dense_pages(a, sa), dense_pages(b_, sb), mask_c,
                           sm),
               lib_label="sdpa, dense bf16 K/V of the same length")
    for tag, (a, sa, b_, sb) in packed_pages:
        per_key = (dh // 2 if a is pk4 else dh) + dh // 2 + 4
        report_attn("flash_chunk_paged_int4", f"{tag} pages B=8 C=128",
               lambda: flash_chunk_paged(qc, a, sa, b_, sb, 1, starts, pt, sm),
               lambda: flash_chunk_paged_plain(qc, a, sa, b_, sb, 1, starts, pt, sm), 2e-2,
               "int4 pages B=8 C=128",
               work=(nbytes(qc, starts) + B * n_pg * 4 + n_read * nKV * per_key,
                     4 * n_pairs * nKV * dh),
               fn_lib=sdpa(qc.transpose(1, 2), dense_pages(a, sa), dense_pages(b_, sb), mask_c,
                           sm),
               lib_label="sdpa, dense bf16 K/V of the same length")
    # K10 gives equal bytes in two calls (no split over keys, no atomics)
    a1 = flash_chunk_paged(qc, pk8, pks, pv8, pvs, 1, starts, pt, sm)
    a2 = flash_chunk_paged(qc, pk8, pks, pv8, pvs, 1, starts, pt, sm)
    same = torch.equal(a1, a2)
    ok &= same
    log(f"  flash_chunk_paged  int8 pages: two calls give "
        f"{'equal bytes' if same else 'MISS: other bytes'}")
    del pk8, pv8, pkb, pvb, pk4, pv4, a1, a2
    # K10 at StarCoder's MQA (48 x 128 query heads on one KV head, g = 48)
    # on int8 pages of 256: the same slots, chunks and block tables
    nH_g = 48
    pk8, pv8 = i8(L, P, 1, ps, dh), i8(L, P, 1, ps, dh)
    pks1 = (torch.rand((L, P, 1, ps), device=dev, generator=gen) * 0.02).to(torch.bfloat16)
    pvs1 = (torch.rand((L, P, 1, ps), device=dev, generator=gen) * 0.02).to(torch.bfloat16)
    qg = bf(B, C, nH_g, dh)
    report_attn("flash_chunk_paged", f"int8 pages B=8 C=128 {nH_g}x128 g={nH_g}",
           lambda: flash_chunk_paged(qg, pk8, pks1, pv8, pvs1, 1, starts, pt, sm),
           lambda: flash_chunk_paged_plain(qg, pk8, pks1, pv8, pvs1, 1, starts, pt, sm), 2e-2,
           "int8 pages B=8 C=128",
           work=(nbytes(qg, starts) + B * n_pg * 4 + n_read * (2 * dh + 4),
                 4 * n_pairs * nH_g * dh),
           fn_lib=lambda: F.scaled_dot_product_attention(
               qg.transpose(1, 2), dense_pages(pk8, pks1), dense_pages(pv8, pvs1),
               attn_mask=mask_c, scale=sm, enable_gqa=True),
           lib_label="sdpa, dense bf16 K/V of the same length, enable_gqa")
    del pk8, pv8, qg
    # K10 on pages of 128, the CLI pool's: the same rows and keys, 16 pages a
    # row; a tile takes one TMA box of each page it reads
    ps2 = 128
    n_pg2 = S // ps2
    P2 = B * n_pg2 + 1
    pt2 = (torch.randperm(P2 - 1, device=dev, generator=gen) + 1).reshape(B, n_pg2).to(
        torch.int32)
    pk8, pv8 = i8(L, P2, nKV, ps2, dh), i8(L, P2, nKV, ps2, dh)
    pks2 = (torch.rand((L, P2, nKV, ps2), device=dev, generator=gen) * 0.02).to(torch.bfloat16)
    pvs2 = (torch.rand((L, P2, nKV, ps2), device=dev, generator=gen) * 0.02).to(torch.bfloat16)

    def dense_pages2(pages, scales):
        return dense_bf16(gather_pages(pages[1], pt2), gather_pages(scales[1], pt2))

    report_attn("flash_chunk_paged", "int8 pages of 128 B=8 C=128",
           lambda: flash_chunk_paged(qc, pk8, pks2, pv8, pvs2, 1, starts, pt2, sm),
           lambda: flash_chunk_paged_plain(qc, pk8, pks2, pv8, pvs2, 1, starts, pt2, sm), 2e-2,
           "int8 pages B=8 C=128",
           work=(nbytes(qc, starts) + B * n_pg2 * 4 + n_read * nKV * (2 * dh + 4),
                 4 * n_pairs * nKV * dh),
           fn_lib=sdpa(qc.transpose(1, 2), dense_pages2(pk8, pks2), dense_pages2(pv8, pvs2),
                       mask_c, sm),
           lib_label="sdpa, dense bf16 K/V of the same length")
    del pk8, pv8
    # K10 on bf16 pages of 12 (not a multiple of 8: no box holds whole 8-row
    # swizzle groups, so the rows land raw and the consumers copy them into
    # the swizzled layout), the same rows and keys
    ps3 = 12
    n_pg3 = -(-S // ps3)
    P3 = B * n_pg3 + 1
    pt3 = (torch.randperm(P3 - 1, device=dev, generator=gen) + 1).reshape(B, n_pg3).to(
        torch.int32)
    pkb, pvb = bf(L, P3, nKV, ps3, dh), bf(L, P3, nKV, ps3, dh)
    report_attn("flash_chunk_paged", "bf16 pages of 12 B=8 C=128",
           lambda: flash_chunk_paged(qc, pkb, None, pvb, None, 1, starts, pt3, sm),
           lambda: flash_chunk_paged_plain(qc, pkb, None, pvb, None, 1, starts, pt3, sm), 2e-2,
           "int8 pages B=8 C=128",
           work=(nbytes(qc, starts) + B * n_pg3 * 4 + n_read * nKV * 4 * dh,
                 4 * n_pairs * nKV * dh),
           fn_lib=sdpa(qc.transpose(1, 2), gather_pages(pkb[1], pt3)[:, :, :S],
                       gather_pages(pvb[1], pt3)[:, :, :S], mask_c, sm),
           lib_label="sdpa, dense bf16 K/V of the same length")
    del pkb, pvb

    # K5: causal prefill over the prompt's own bf16 K/V, 40 heads, dh 128
    # (and 32 x 64, a 2048-wide model's heads).
    # The work counts the (query, key) pairs the causal and length bounds
    # admit; the yardstick is one causal scaled_dot_product_attention call
    # on equal lengths (a ragged batch has no is_causal form).
    # StarCoder's prompts of 1000 and 3000 tokens: 48 x 128 on one KV head
    # (MQA, g = 48; SDPA takes it with enable_gqa).
    for B, S, lens, nH, nKV, dh in ((1, 4096, [4096], 40, 40, 128),
                                    (2, 2048, [2048, 1300], 40, 40, 128),
                                    (1, 4096, [4096], 32, 32, 64), (1, 1000, [1000], 48, 1, 128),
                                    (1, 3000, [3000], 48, 1, 128)):
        q, k, v = bf(B, S, nH, dh), bf(B, S, nKV, dh), bf(B, S, nKV, dh)
        ln = torch.tensor(lens, dtype=torch.int32, device=dev)
        n_pairs = sum(n * (n + 1) // 2 + (S - n) * n for n in lens)
        sm = dh ** -0.5
        report_attn("prefill_attention_flash",
               f"B={B} S={S} lengths {lens}" + ("" if (nH, dh) == (40, 128) else f" {nH}x{dh}")
               + ("" if nKV == nH else f" g={nH // nKV}"),
               lambda: prefill_attention_flash(q, k, v, ln, sm),
               lambda: prefill_attention_flash_plain(q, k, v, ln, sm), 2e-2,
               "B=1 S=4096 lengths [4096]",
               work=(nbytes(q, k, v, ln), 4 * n_pairs * nH * dh),
               fn_lib=lambda: F.scaled_dot_product_attention(
                   q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True,
                   scale=sm, enable_gqa=nKV != nH),
               lib_label="sdpa is_causal, equal lengths")
        del q, k, v

    # K12: banded sliding-window attention at Longformer-base shapes (12
    # heads x 64, w_half 256), ragged, both band modes; q already scaled.
    # The work counts the (query, key) pairs of unpadded rows that the band
    # and the lengths admit, and the bytes of q, k and v of unpadded rows
    # only (the kernel reads no padded row), the whole output (its padded
    # rows are written as 0) and the lengths; the yardstick is one
    # scaled_dot_product_attention with the boolean band-and-length mask
    # (its fully masked padded rows compared as 0).
    B, S, nH, dh, w = 2, 4096, 12, 64, 256
    lens = [4096, 2900]
    q, k, v = bf(B, S, nH, dh, std=dh ** -0.5), bf(B, S, nH, dh), bf(B, S, nH, dh)
    ln = torch.tensor(lens, dtype=torch.int32, device=dev)
    pos = torch.arange(S, device=dev)
    real = pos[None, :] < ln[:, None]  # [B, S]
    masked = ~real
    d = pos[:, None] - pos[None, :]  # query minus key
    for causal in (False, True):
        band = ((d >= 0) & (d <= w)) if causal else d.abs() <= w
        allow = band[None] & real[:, None, :] & real[:, :, None]  # [B, S(q), S(k)]
        n_pairs = int(allow.sum())
        tag = "causal band" if causal else "band"

        def sdpa_band(allow=allow):
            out = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                                 v.transpose(1, 2), attn_mask=allow[:, None],
                                                 scale=1.0)
            return torch.where(real[:, None, :, None], out, 0.0).transpose(1, 2)

        report_attn("sliding_window_attention", f"{tag} B=2 S=4096 w=256 lengths {lens}",
               lambda: sliding_window_attention(q, k, v, w, masked, causal=causal),
               lambda: sliding_window_attention_plain(q, k, v, w, masked, causal=causal), 2e-2,
               f"band B=2 S=4096 w=256 lengths {lens}",
               work=(3 * sum(lens) * nH * dh * q.element_size() + nbytes(ln),
                     4 * n_pairs * nH * dh), fn_lib=sdpa_band,
               lib_label="sdpa, boolean band-and-length mask, padded rows as 0")
        if not causal:
            got, ref = sdpa_band(), sliding_window_attention_plain(q, k, v, w, masked)
            torch.cuda.synchronize()
            log(f"  sliding_window_attention: the sdpa yardstick against the plain version: "
                f"row_rel_err {row_rel_err(torch, got, ref)[1]:.2e}")
        del allow
    a1 = sliding_window_attention(q, k, v, w, masked)
    a2 = sliding_window_attention(q, k, v, w, masked)
    torch.cuda.synchronize()
    log(f"  sliding_window_attention: two calls equal bytes: {torch.equal(a1, a2)}")
    ok &= torch.equal(a1, a2)
    del q, k, v, a1, a2
    # K12 at the band's edges (S = 1000, 12 heads): w = 0, w = 130 (a band
    # edge inside a 128-key tile), w = S, and dh 128 with w = 300; lengths
    # off the tile boundaries and an empty row; each in both band modes
    S = 1000
    pos = torch.arange(S, device=dev)
    for w, lens, dh in ((0, [1000, 129], 64), (130, [1000, 257], 64), (1000, [1000, 1], 64),
                        (300, [1000, 0], 128)):
        q, k, v = bf(B, S, nH, dh, std=dh ** -0.5), bf(B, S, nH, dh), bf(B, S, nH, dh)
        masked = pos[None, :] >= torch.tensor(lens, device=dev)[:, None]
        for causal in (False, True):
            report_attn("sliding_window_attention",
                   f"{'causal band' if causal else 'band'} S=1000 12x{dh} w={w} lengths {lens}",
                   lambda: sliding_window_attention(q, k, v, w, masked, causal=causal),
                   lambda: sliding_window_attention_plain(q, k, v, w, masked, causal=causal),
                   2e-2, f"band B=2 S=4096 w=256 lengths {[4096, 2900]}")
        del q, k, v

    # CodeFuse-13B's tp = 2 shard shapes (phase 10): a rank holds 20 of the
    # 40 heads, QKV columns 7680 and up columns 10240 (K13), proj rows 2560
    # and down rows 10240 into the full 5120 (K3 in decode; K1 in prefill
    # and chunk ticks), and attends over its 20 heads (K4 in decode, K5 in
    # prefill). Logged only: each record keeps its full-width case.
    Ht, Ft, nHt, dh = H // 2, F_ // 2, 20, 128
    wq, sq, wu, su = i8(H, 3 * Ht), scale(3 * Ht), i8(H, Ft), scale(Ft)
    bq, bu = bf(3 * Ht, std=0.02), bf(Ft, std=0.02)
    wqb, wub = (wq.float() * sq).to(torch.bfloat16), (wu.float() * su).to(torch.bfloat16)
    for M in (1, 4, 1024):
        x1, x2 = bf(M, H), bf(M, H)
        args = (x1, x2, wq, wu, sq, su, bq, bu, None, "gelu-tanh", 8, 0)
        lib = (((lambda: (torch.matmul(x1, wqb), torch.matmul(x2, wub))),
                "two torch.matmul, bf16 weights dequantized beforehand") if M > 32 else
               (None, "none: no one PyTorch call computes it"))
        report("fused_qkv_up", f"tp=2 int8 {H}->{3 * Ht}|{Ft} M={M}",
               lambda: fused_qkv_up(*args), lambda: fused_qkv_up_plain(*args), tol_mm, "",
               work=(nbytes(x1, x2, wq, sq, wu, su, bq, bu), 2 * M * H * (3 * Ht + Ft)),
               fn_lib=lib[0], lib_label=lib[1],
               note=tiles(M, 3 * Ht, Ft, kernel="ncat_gemm_i8") if M > 32 else "")
    del wq, wu, wqb, wub
    wp, wd, sp, sd, bd = i8(Ht, H), i8(Ft, H), scale(H), scale(H), bf(H, std=0.02)
    for M in (1, 4):
        xp, hd, res = bf(M, Ht), bf(M, Ft, std=0.5), bf(M, H)
        report("fused_proj_down", f"tp=2 proj+down {Ht}+{Ft}->{H} M={M}",
               lambda: fused_proj_down(xp, hd, wp, wd, sp, sd, bd, res),
               lambda: fused_proj_down_plain(xp, hd, wp, wd, sp, sd, bd, res), tol_mm, "",
               work=(nbytes(xp, hd, wp, wd, sp, sd, bd, res), 2 * M * (Ht + Ft) * H))
    for tag, w, s_, K in (("proj", wp, sp, Ht), ("down", wd, sd, Ft)):
        wb, x = (w.float() * s_).to(torch.bfloat16), bf(1024, K)
        report("quant_matmul", f"tp=2 {tag} {K}->{H} M=1024",
               lambda: quant_matmul(x, w, s_, None, None),
               lambda: quant_matmul_plain(x, w, s_, None, None), tol_mm, "",
               work=(nbytes(x, w, s_), 2 * 1024 * K * H), fn_lib=lambda: torch.matmul(x, wb),
               lib_label=lib_bf16, note=tiles(1024, H, kernel="gemm_i8", K=K))
        del wb
    del wp, wd
    # K4 over a rank's 20 heads: B = 2 (phase 10's batch) and 4, int8 cache
    for B, S, pos_l in ((2, 1024, [999, 1007]), (4, 1152, [10, 1151, 500, 777])):
        pos = torch.tensor(pos_l, dtype=torch.int32, device=dev)
        n_keys = int((pos + 1).sum())
        q = bf(B, nHt, dh)
        k8, v8 = i8(1, B, nHt, S, dh), i8(1, B, nHt, S, dh)
        ks = (torch.rand((1, B, nHt, S), device=dev, generator=gen) * 0.02).to(torch.bfloat16)
        vs = (torch.rand((1, B, nHt, S), device=dev, generator=gen) * 0.02).to(torch.bfloat16)
        sm = 1.0 / dh ** 0.5
        mask = (torch.arange(S, device=dev)[None, :] <= pos[:, None].long())[:, None, None, :]
        report_attn("flash_decode", f"tp=2 20 heads int8 cache B={B} S={S}",
               lambda: flash_decode_stacked(q, k8, ks, v8, vs, 0, pos, sm),
               lambda: flash_decode_stacked_plain(q, k8, ks, v8, vs, 0, pos, sm), 2e-2, "",
               work=(nbytes(q, pos) + n_keys * nHt * (2 * dh + 4), 4 * n_keys * nHt * dh),
               fn_lib=sdpa(q[:, :, None], dense_bf16(k8[0], ks[0]), dense_bf16(v8[0], vs[0]),
                           mask, sm),
               lib_label="sdpa, dense bf16 K/V of the same length")
        del k8, v8
    # K5 over a rank's 20 heads: phase 10's two ~1000-token prompts
    S, lens = 1008, [1000, 1008]
    q, k, v = bf(2, S, nHt, dh), bf(2, S, nHt, dh), bf(2, S, nHt, dh)
    ln = torch.tensor(lens, dtype=torch.int32, device=dev)
    n_pairs = sum(n * (n + 1) // 2 + (S - n) * n for n in lens)
    sm = dh ** -0.5
    report_attn("prefill_attention_flash", f"tp=2 20 heads B=2 S={S} lengths {lens}",
           lambda: prefill_attention_flash(q, k, v, ln, sm),
           lambda: prefill_attention_flash_plain(q, k, v, ln, sm), 2e-2, "",
           work=(nbytes(q, k, v, ln), 4 * n_pairs * nHt * dh),
           fn_lib=lambda: F.scaled_dot_product_attention(
               q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True, scale=sm),
           lib_label="sdpa is_causal, equal lengths")
    del q, k, v
    return ok


class tile_cache_off:
    """``FTCF_TILE_TUNE=0`` inside the ``with``: every launch takes its
    default plan."""

    def __enter__(self):
        self.was = os.environ.get("FTCF_TILE_TUNE")
        os.environ["FTCF_TILE_TUNE"] = "0"

    def __exit__(self, *exc):
        if self.was is None:
            os.environ.pop("FTCF_TILE_TUNE", None)
        else:
            os.environ["FTCF_TILE_TUNE"] = self.was


def phase_tile_cache(torch):
    """Phase 2, the tile cache (ops/tile_tuning.py): K13 at CodeFuse-13B's
    widths (M = 1024) on each of the GEMM's block tiles, in every weight
    format (20 instances), held against the plain version within 1e-2 and
    bit for bit against the default tile, and timed; then every entry of
    the shipped cache: its case (ops/tile_autotune.py ``cases``) at the
    entry's M through the kernel's wrapper, the entry served (a hit), held
    against the plain version within 1e-2; each entry's recorded default
    and tuned times logged, and where its plan is not the default both
    timed again here as the sweep times them (weights cycled past the L2).
    Returns an error message, or None."""
    from fastertransformer4codefuse_tpu_torch.ops import tile_autotune as ta
    from fastertransformer4codefuse_tpu_torch.ops import tile_tuning
    from fastertransformer4codefuse_tpu_torch.ops.quant_matmul import GEMM_TILES
    from fastertransformer4codefuse_tpu_torch.ops.quant_matmul_fused import (
        fused_qkv_up, fused_qkv_up_plain,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(77)
    H, F_, M, tol = 5120, 20480, 1024, 1e-2
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    scratch = os.path.join(REPO, "build", "tile_check.json")  # build/ is git-ignored
    os.makedirs(os.path.dirname(scratch), exist_ok=True)
    log(f"phase 2: the tile cache: the GEMM's block tiles {list(GEMM_TILES)} in every weight "
        f"format, then the shipped entries ({tile_tuning.cache_path()})")

    def i8(*shape):
        return torch.empty(shape, dtype=torch.int8, device=dev).random_(-128, 128, generator=gen)

    x1 = (torch.randn(M, H, device=dev, generator=gen)).to(torch.bfloat16)
    x2 = (torch.randn(M, H, device=dev, generator=gen)).to(torch.bfloat16)
    b1 = (torch.randn(3 * H, device=dev, generator=gen) * 0.02).to(torch.bfloat16)
    for fmt, bits, G, sdt in (("i8", 8, 0, None), ("i4", 4, 0, None),
                              ("i4g", 4, 128, torch.bfloat16), ("i8g", 8, 128, torch.float32),
                              ("i4gf", 4, 128, torch.float32)):
        pk = H // 2 if bits == 4 else H
        wq, wu = i8(pk, 3 * H), i8(pk, F_)
        qmax = 7 if bits == 4 else 127

        def sc(n):
            if G:
                return (torch.empty(H // G, n, device=dev).uniform_(0.5, 1.5, generator=gen)
                        * (0.02 / qmax)).to(sdt)
            return torch.empty(n, device=dev).uniform_(0.5, 1.5, generator=gen) * (0.02 / qmax)

        args = (x1, x2, wq, wu, sc(3 * H), sc(F_), b1, None, None, "gelu-tanh", bits, G)
        ref = torch.cat(fused_qkv_up_plain(*args), 1)
        outs, line = [], []
        for rows, cols in GEMM_TILES:
            plan = dict(bn=cols, bk=64, rows=rows, group_m=8, stages=8)
            with ta.served(scratch, {(f"ncat_gemm_{fmt}", M, H, 3 * H + F_, G): plan}, sms):
                hits = tile_tuning.hits[f"ncat_gemm_{fmt}"]
                got = torch.cat(fused_qkv_up(*args), 1)
                if tile_tuning.hits[f"ncat_gemm_{fmt}"] != hits + 1:
                    return f"the tile {rows}x{cols} was not served to K13 {fmt}"
                e = rel_err(torch, got, ref)[1]
                t = device_time_ms(torch, lambda: fused_qkv_up(*args))
            outs.append(got)
            line.append(f"{rows}x{cols} {t:.4f} ms (err {e:.2e})")
            if not (e < tol and bool(torch.isfinite(got.float()).all())):
                return f"the GEMM's {rows}x{cols} tile, K13 {fmt}: {e:.3e} from plain (tol {tol})"
        same = all(torch.equal(o, outs[0]) for o in outs[1:])
        log(f"  K13 {fmt} {H}->{3 * H}|{F_} M={M}: " + ", ".join(line)
            + f"; the tiles' outputs {'bit for bit equal' if same else 'DIFFER'}")
        if not same:
            return f"K13 {fmt}: the GEMM's block tiles give different bytes"
        del wq, wu, ref, outs

    with open(tile_tuning._DEFAULT_PATH) as f:
        shipped = json.load(f)
    jobs = {}  # key -> (case, gemv, bucket)
    for c in ta.cases(list(ta.MODELS)):
        K, N = c.key_kn()
        for gemv, buckets in ((True, (1, *ta.GEMV_JOINT)), (False, (
                (64,) if c.op == "k8" else (128, 256, 512, 1024, 2048, 4096) if c.gemm()
                else ()))):
            for b in buckets:
                jobs[tile_tuning._key(c.kernel(gemv), b, K, N, c.G)] = (c, gemv, b)
    strays = sorted(set(shipped) - set(jobs))
    if strays:
        return f"shipped tile cache entries no served case makes: {strays[:5]}"
    if {e["sms"] for e in shipped.values()} != {sms}:
        return f"the shipped tile cache was recorded on another SM count than this card's {sms}"
    tile_tuning.invalidate()
    n_tuned, worst, t0 = 0, 0.0, time.time()
    by_case = {}
    for key in sorted(shipped, key=lambda k: (jobs[k][0].note, k)):
        by_case.setdefault(jobs[key][0], []).append(key)
    for c, keys in by_case.items():
        ops = ta.Operands(c, dev, gen)
        for key in keys:
            _, gemv, b = jobs[key]
            e = shipped[key]
            Mb = ta.bucket_m(b)
            call, plain, _, _ = ops.calls(Mb)
            kernel = key.split("|")[0]
            hits = tile_tuning.hits[kernel]
            got = call(0)
            if tile_tuning.hits[kernel] != hits + 1:
                return f"{key}: the shipped entry was not served"
            err = ta.rel(got, plain())
            worst = max(worst, err)
            if not err < tol:
                return f"{key} ({c.note}, M={Mb}): {err:.3e} from plain (tol {tol})"
            plan = {k: e[k] for k in ("splits", "rows", "bn", "group_m", "stages") if k in e}
            line = (f"  {key:44s} {c.note:32s} M={Mb:4d} {plan}: recorded {e['us']:.2f} us, "
                    f"default {e['default_us']:.2f} us ({e['card']}, {e['power_limit']})")
            if e["us"] < e["default_us"]:
                n_tuned += 1
                t_tuned = ta.time_us(call)[0]
                with tile_cache_off():
                    t_def = ta.time_us(call)[0]
                line += f"; here tuned {t_tuned:.2f} us, default {t_def:.2f} us"
            log(line)
        del ops
        torch.cuda.empty_cache()
    log(f"  {len(shipped)} shipped entries held against plain (worst {worst:.2e}, tol {tol}); "
        f"{n_tuned} leave the default plan; {time.time() - t0:.1f} s")
    return None


def reference_model(torch, pkg, layers=2, **quant):
    """(config, CPU params, card params) of the ``layers``-deep model of
    CodeFuse-13B width (seed 7) with ``quant`` weights (init_params'
    weight_bits and group_size), built on the card (its generator: ~0.1 s,
    the CPU's ~11 s) and copied to the CPU."""
    from fastertransformer4codefuse_tpu_torch.models.params import params_to

    cfg = pkg.GptNeoXConfig(**{**pkg.GptNeoXConfig.codefuse_13b().__dict__,
                               "layer_num": layers})
    p_gpu = pkg.init_params(cfg, seed=7, dtype="bf16", int8_mode=1, quantize_embeddings=True,
                            device="cuda", **quant)
    return cfg, params_to(p_gpu, "cpu"), p_gpu


def first_layer(pkg, ref):
    """``ref``'s 2-layer model cut to its first layer: the stage-0 block of a
    pp = 2 mesh (the layer copied out of the stack, the other weights
    shared)."""
    from fastertransformer4codefuse_tpu_torch.parallel.distributed import Mesh
    from fastertransformer4codefuse_tpu_torch.parallel.sharding import shard_params

    cfg, p_cpu, p_gpu = ref
    one = pkg.GptNeoXConfig(**{**cfg.__dict__, "layer_num": 1})
    return one, shard_params(cfg, p_cpu, Mesh(pp=2)), shard_params(cfg, p_gpu, Mesh(pp=2))


def phase_reference(torch, ref, kv=None, fused=True, card_logits=None):
    """The reference model ``ref`` (``reference_model``): card
    (kernels) vs CPU (plain); ``kv`` the dense cache's kind (int8 when
    None); ``fused`` the route (K13 + K3, or the unfused GEMMs). Returns max
    |dlogits| / max |logits| after the prefill and after each decode step;
    ``card_logits`` (a list) receives the card's logits of each step."""
    from fastertransformer4codefuse_tpu_torch.engine import kv_cache
    from fastertransformer4codefuse_tpu_torch.models import gptneox as model

    cfg, p_cpu, p_gpu = ref
    rng = np.random.default_rng(7)
    B, S, steps = 2, 64, 3
    ids = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int64)
    lens = np.array([S, S - 17], np.int32)
    logits = {}
    for name, p, dev in (("card", p_gpu, "cuda"), ("cpu", p_cpu, "cpu")):
        cache = kv_cache.init_cache(cfg, B, S + steps + 1, kv or torch.int8, dev)
        t_ids = torch.from_numpy(ids).to(dev)
        t_lens = torch.from_numpy(lens).to(dev)
        hidden, cache = model.prefill(cfg, p, t_ids, t_lens, cache, fused=fused)
        out = [model.lm_logits(cfg, p, model.last_token_hidden(hidden, t_lens))]
        for st in range(steps):
            tok = torch.from_numpy(ids[:, st]).to(dev)  # teacher-forced tokens
            positions = (t_lens + st).to(torch.int32)
            h, cache = model.decode_step(cfg, p, tok, positions, cache, fused=fused)
            out.append(model.lm_logits(cfg, p, h))
        logits[name] = [o.float().cpu() for o in out]
    if card_logits is not None:
        card_logits.extend(logits["card"])
    rels = []
    for i, a in enumerate(logits["card"]):
        if not bool(torch.isfinite(a).all()) or a.shape != (B, cfg.vocab_size):
            raise RuntimeError(f"reference step {i}: bad logits {a.shape}")
        rels.append(rel_err(torch, a, logits["cpu"][i])[1])
    return rels


def phase_reference_paged(torch, ref, kv):
    """The int8 reference model ``ref`` on a paged ``kv`` pool:
    chunked prefill of ragged prompts through ``prefill_chunk`` (K10 on the
    card), then 3 teacher-forced ``decode_step``s (K9), card against CPU.
    Returns max |dlogits| / max |logits| after the prefill and each step."""
    from fastertransformer4codefuse_tpu_torch.engine import paged_kv
    from fastertransformer4codefuse_tpu_torch.models import gptneox as model

    cfg, p_cpu, p_gpu = ref
    rng = np.random.default_rng(8)
    B, C, ps, n_pg, steps = 2, 32, 64, 2, 3
    ids = rng.integers(0, cfg.vocab_size, (B, 2 * C)).astype(np.int64)
    lens = np.array([2 * C, 2 * C - 17], np.int32)
    pt = np.array([[3, 1], [4, 2]], np.int32)  # permuted pages; page 0 is the garbage page
    logits = {}
    for name, p, dev in (("card", p_gpu, "cuda"), ("cpu", p_cpu, "cpu")):
        cache = paged_kv.init_paged_cache(cfg, B, ps * n_pg, 5, ps, kv, dev)
        cache["pt"] = torch.from_numpy(pt).to(dev)
        last = [None] * B
        for c0 in range(0, 2 * C, C):
            tok = torch.from_numpy(ids[:, c0:c0 + C]).to(dev)
            pos = torch.full((B,), c0, dtype=torch.int32, device=dev)
            active = torch.from_numpy(lens > c0).to(dev)
            hidden, cache = model.prefill_chunk(cfg, p, tok, pos, cache, active)
            for b in range(B):
                if c0 <= lens[b] - 1 < c0 + C:
                    last[b] = hidden[b, lens[b] - 1 - c0]
        out = [model.lm_logits(cfg, p, torch.stack(last))]
        for st in range(steps):
            tok = torch.from_numpy(ids[:, st]).to(dev)  # teacher-forced tokens
            positions = torch.from_numpy(lens + st).to(dev)
            h, cache = model.decode_step(cfg, p, tok, positions, cache)
            out.append(model.lm_logits(cfg, p, h))
        logits[name] = [o.float().cpu() for o in out]
    rels = []
    for i, (a, b) in enumerate(zip(logits["card"], logits["cpu"])):
        if not bool(torch.isfinite(a).all()) or a.shape != (B, cfg.vocab_size):
            raise RuntimeError(f"paged reference step {i}: bad logits {a.shape}")
        rels.append(rel_err(torch, a, b)[1])
    return rels


def phase_reference_beam(torch, ref):
    """The int8 reference model ``ref`` on B = 2 prompts tiled
    over bw = 4 beams: one prefill of the 8 rows (K5 on the card), then 3
    teacher-forced beam decode steps (K11 on the card) over a real beam
    history: each step every row takes a random parent in its group,
    inherits its indirection and writes its own token into its own row, so
    each row's ancestors wrote the slots it reads. Card against CPU; returns
    max |dlogits| / max |logits| after the prefill and each step."""
    from fastertransformer4codefuse_tpu_torch.engine import kv_cache
    from fastertransformer4codefuse_tpu_torch.models import gptneox as model

    cfg, p_cpu, p_gpu = ref
    rng = np.random.default_rng(9)
    B, bw, S, steps = 2, 4, 64, 3
    BB, T = B * bw, S + steps + 1
    ids = np.repeat(rng.integers(0, cfg.vocab_size, (B, S)), bw, axis=0)  # beam-minor tiling
    lens = np.repeat(np.array([S, S - 17], np.int32), bw)
    tokens = rng.integers(0, cfg.vocab_size, (steps, BB))
    own = np.arange(BB) % bw
    indirs, ind = [], np.repeat(own[:, None], T, axis=1).astype(np.int32)
    for st in range(steps):
        ind = ind[np.arange(BB) // bw * bw + rng.integers(0, bw, BB)]  # each row's parent
        ind[np.arange(BB), lens + st] = own
        indirs.append(ind.copy())
    logits = {}
    for name, p, dev in (("card", p_gpu, "cuda"), ("cpu", p_cpu, "cpu")):
        cache = kv_cache.init_cache(cfg, BB, T, torch.int8, dev)
        t_lens = torch.from_numpy(lens).to(dev)
        hidden, cache = model.prefill(cfg, p, torch.from_numpy(ids).to(dev), t_lens, cache)
        out = [model.lm_logits(cfg, p, model.last_token_hidden(hidden, t_lens))]
        for st in range(steps):
            beam = (bw, torch.from_numpy(indirs[st]).to(dev))
            h, cache = model.decode_step(cfg, p, torch.from_numpy(tokens[st]).to(dev),
                                         (t_lens + st).to(torch.int32), cache, beam=beam)
            out.append(model.lm_logits(cfg, p, h))
        logits[name] = [o.float().cpu() for o in out]
    rels = []
    for i, (a, b) in enumerate(zip(logits["card"], logits["cpu"])):
        if not bool(torch.isfinite(a).all()) or a.shape != (BB, cfg.vocab_size):
            raise RuntimeError(f"beam reference step {i}: bad logits {a.shape}")
        rels.append(rel_err(torch, a, b)[1])
    return rels


# Attention shapes off the CodeFuse-13B path (tiny configs, random weights
# from seed 3, tests/test_torch_kernels_cuda.py and
# tests/test_torch_attention_routes.py serve them too): 64-wide heads (K5
# and K4 at dh 64), 16 query heads a KV head (K5, K4 at g = 16), bf16 pages
# of 4 (K10 lands them as raw rows, K9), and 32-wide heads, which no
# attention kernel takes (nor does the JAX package's: it takes XLA), so
# prefill and decode take the plain routes. (config, KV cache (None: a pool
# on bf16 pages of 4), the route each of prefill, chunk and decode must
# take: "kernel", "plain", or None where the config runs no such call)
ROUTE_CONFIGS = {
    "dh64": (dict(head_num=4, size_per_head=64, rotary_embedding_dim=16), "int8",
             ("kernel", None, "kernel")),
    "gqa16": (dict(head_num=16, kv_head_num=1, qkv_layout="concat", size_per_head=128,
                   rotary_embedding_dim=32, inter_size=512), "int8", ("kernel", None, "kernel")),
    "pages4": (dict(head_num=2, size_per_head=128, rotary_embedding_dim=32), None,
               (None, "kernel", "kernel")),
    "dh32": (dict(head_num=4, size_per_head=32, rotary_embedding_dim=16), "int8",
             ("plain", None, "plain")),
}
ROUTE_PROMPTS = [[5, 9, 3, 17, 2], [11, 4, 90], [30, 31, 32, 33, 34, 35, 36, 37, 38]]
ROUTE_TOKENS = 8  # greedy tokens a prompt
# a greedy token may part from the CPU's only where the CPU's two best logits
# lie within this share of max |logits| (phase 3 measures 3.3e-3 at 13B width)
NEAR_TIE = 1e-2


def route_tokens(pkg, cfg, params, kv, prompts=ROUTE_PROMPTS, n=ROUTE_TOKENS):
    """Greedy tokens (``n``) of ``prompts`` on the params' device: the static
    engine, or (kv None) a pool on bf16 pages of 4."""
    from fastertransformer4codefuse_tpu_torch.engine.batcher import ContinuousBatcher

    rt = pkg.RuntimeConfig(dtype="bf16", int8_mode=1, kv_cache_dtype=kv, seq_bucket=8)
    eng = pkg.GptNeoXEngine(cfg, params, rt)
    if kv is not None:
        out = eng.generate(prompts, output_len=n, top_k=1)
        return [list(map(int, r[0][len(p):len(p) + n])) for r, p in zip(out.output_ids, prompts)]
    cb = ContinuousBatcher(eng, max_slots=2, max_seq_len=32, prompt_bucket=4,
                           paged=dict(num_pages=17, page_size=4))
    uids = [cb.submit(prompt=p, output_len=n, top_k=1) for p in prompts]
    done = cb.run(max_ticks=400)
    return [list(map(int, done[u].output_ids[len(p):])) for u, p in zip(uids, prompts)]


def serve_route_config(torch, pkg, name):
    """Serve ROUTE_CONFIGS[name] on the card and on the CPU (bf16 both, the
    same params). Returns (error or None, the card's plain routes (prefill,
    chunk, decode), the near-ties where the card's greedy tokens part from
    the CPU's). Where a card token parts from the CPU's at a near-tie of the
    CPU's logits, both go on from the CPU's tokens up to and including that
    step (teacher forcing), so every step of every prompt is compared. An
    error: tokens that part elsewhere, or a route other than the config's
    (a plain route taken where a kernel should run, or the other way)."""
    from fastertransformer4codefuse_tpu_torch.engine import kv_cache
    from fastertransformer4codefuse_tpu_torch.models.params import params_to
    from fastertransformer4codefuse_tpu_torch.ops.attention import (
        prefill_attention, prefill_attention_flash,
    )
    from fastertransformer4codefuse_tpu_torch.ops.flash_decode import (
        flash_chunk_paged, flash_decode_paged, flash_decode_stacked,
    )

    over, kv, want = ROUTE_CONFIGS[name]
    routers = (prefill_attention, kv_cache.attend_chunk, kv_cache.attend_decode)
    kernels = (prefill_attention_flash, flash_chunk_paged,
               flash_decode_stacked if kv is not None else flash_decode_paged)
    cfg = pkg.GptNeoXConfig.tiny(vocab_size=128, activation="gelu-tanh", end_id=127, **over)
    p_cpu = pkg.init_params(cfg, seed=3, dtype="bf16", int8_mode=1, quantize_embeddings=True,
                            device="cpu")
    p_card = params_to(p_cpu, "cuda")
    want_tok = route_tokens(pkg, cfg, p_cpu, kv)
    for fn in routers:
        fn.plain_routes = 0
    launches = [fn.launches for fn in kernels]
    got = route_tokens(pkg, cfg, p_card, kv)
    torch.cuda.synchronize()
    plain = [fn.plain_routes for fn in routers]
    took = [fn.launches > n for fn, n in zip(kernels, launches)]
    seen = [("both" if k else "plain") if p else "kernel" if k else None
            for p, k in zip(plain, took)]
    if any(w is not None and s != w for s, w in zip(seen, want)) or (
            any(plain[i] for i in range(3) if want[i] != "plain")):
        return f"{name}: routes (prefill, chunk, decode) {seen}, expected {want}", plain, []
    err, ties = hold_to_cpu(torch, cfg, p_cpu, torch.int8 if kv else torch.bfloat16,
                            ROUTE_PROMPTS, got, want_tok, ROUTE_TOKENS,
                            lambda p, n: route_tokens(pkg, cfg, p_card, kv, [p], n)[0],
                            lambda p, n: route_tokens(pkg, cfg, p_cpu, kv, [p], n)[0])
    return (f"{name}: {err}" if err else None), plain, ties


def expert_choices(torch, cfg, p, ids, kv):
    """The experts each position of ``ids`` is routed to in a prefill on the
    params' device (an MoE model): for each MoE layer, its top-k expert ids
    [T, k] in ascending order, on the CPU."""
    from fastertransformer4codefuse_tpu_torch.engine import kv_cache
    from fastertransformer4codefuse_tpu_torch.models import gptneox as model

    real, picks = model.moe_ffn, []

    def recording(x2d, router_w, *a, **kw):
        probs = torch.softmax(x2d.float() @ router_w.float(), dim=-1)
        picks.append(probs.topk(cfg.moe_top_k, dim=-1).indices.sort(-1).values.cpu())
        return real(x2d, router_w, *a, **kw)

    dev = p["final_ln_w"].device
    model.moe_ffn = recording
    try:
        lens = torch.tensor([len(ids)], dtype=torch.int32, device=dev)
        model.prefill(cfg, p, torch.tensor([ids], device=dev), lens,
                      kv_cache.init_cache(cfg, 1, len(ids), kv, dev))
    finally:
        model.moe_ffn = real
    return picks


def routing_differs(torch, cfg, p_card, p_cpu, ids, kv):
    """Where the card routes a position of ``ids`` to other experts than the
    CPU does (``expert_choices`` of both): "layer l, position t", or ""."""
    for layer, (a, b) in enumerate(zip(expert_choices(torch, cfg, p_card, ids, kv),
                                       expert_choices(torch, cfg, p_cpu, ids, kv))):
        rows = (a != b).any(-1).nonzero()
        if len(rows):
            return f"layer {layer}, position {int(rows[0])}"
    return ""


def hold_to_cpu(torch, cfg, p_cpu, kv, prompts, got, want, n, card_more, cpu_more,
                routes=None, program_gap=None):
    """Hold the card's greedy tokens ``got`` (``n`` a prompt) to the CPU's
    ``want``. Where a card token parts from the CPU's at a near-tie of the
    CPU's logits (a CPU prefill of the context on a ``kv`` cache), both go
    on from the CPU's tokens up to and including that step
    (``card_more(context, left)`` and ``cpu_more``), so every step of every
    prompt is compared. In an MoE model, whose expert products take their
    shapes from the batch (each expert's bucket holds C = ceil(T k / E
    factor) rows), a parting past NEAR_TIE is also taken where the card
    routes a token of the context to other experts than the CPU does
    (``routes(context)``: ``routing_differs`` of the card and the CPU), or
    where the card,
    given the context alone (``card_more(context, 1)``), picks the CPU's
    token: the parting then comes from the routing or from the batch's
    roundings, not from the context's program. An MoE pool's own program
    (``program_gap(context, card token, CPU token)``: the gap in the logits
    of the CPU's pool alone on the context) routes the same tokens through
    other expert capacities than a prefill of the context does (C follows
    the chunk's rows), so a parting within NEAR_TIE there is a near-tie too.
    Returns (error or None, the near-ties)."""
    from fastertransformer4codefuse_tpu_torch.engine import kv_cache
    from fastertransformer4codefuse_tpu_torch.models import gptneox as model

    ties = []
    for prompt, a, b in zip(prompts, got, want):
        forced = []  # the CPU's tokens both sides go on from
        while True:
            i = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
            if i is None:
                if len(a) != len(b):
                    return f"card tokens {a} against the CPU's {b}", ties
                break
            ids = prompt + forced + b[:i]
            cache = kv_cache.init_cache(cfg, 1, len(ids) + 1, kv, "cpu")
            lens = torch.tensor([len(ids)], dtype=torch.int32)
            hidden, _ = model.prefill(cfg, p_cpu, torch.tensor([ids]), lens, cache)
            lg = model.lm_logits(cfg, p_cpu, model.last_token_hidden(hidden, lens))[0].float()
            gap = (lg[b[i]] - lg[a[i]]).item() / lg.abs().max().item()
            step = len(forced) + i
            ties.append(f"step {step} of a {len(prompt)}-token prompt: gap {gap:.2e}")
            if gap >= NEAR_TIE and routes is not None:
                moved = routes(ids)
                alone = card_more(ids, 1)[0]
                ties[-1] += (f", experts {'differ at ' + moved if moved else 'the same'}, the "
                             f"card alone on this context picks {alone}")
                near = False
                if program_gap is not None and not moved and alone != b[i]:
                    own = program_gap(ids, a[i], b[i])
                    ties[-1] += f", gap {own:.2e} in the CPU pool's own logits"
                    near = own < NEAR_TIE
                if moved or alone == b[i] or near:
                    gap = 0.0
            if gap >= NEAR_TIE:
                return (f"card tokens part from the CPU's at step {step} of {prompt} "
                        f"({a[i]} against {b[i]}; {ties[-1]})"), ties
            forced += b[:i + 1]
            left = n - len(forced)
            if left == 0:
                break
            a = card_more(prompt + forced, left)
            b = cpu_more(prompt + forced, left)
    return None, ties


def phase_routes(torch, pkg):
    """Phase 3's ROUTE_CONFIGS, each served on the card and the CPU
    (serve_route_config). Returns an error or None."""
    for name in ROUTE_CONFIGS:
        err, plain, ties = serve_route_config(torch, pkg, name)
        log(f"  {name}: card greedy tokens == CPU's: {err is None and not ties}"
            f"{' (near-ties, then teacher-forced: ' + '; '.join(ties) + ')' if ties else ''}; "
            f"plain routes (prefill, chunk, decode) {plain}")
        if err:
            return err
    return None


# Published encoder configurations, under HF's config names (read by the
# port's config_from_hf_*): allenai/longformer-base-4096 and bert-base-uncased.
LONGFORMER_BASE = dict(
    num_attention_heads=12, hidden_size=768, num_hidden_layers=12, intermediate_size=3072,
    vocab_size=50265, max_position_embeddings=4098, attention_window=512, pad_token_id=1,
    type_vocab_size=1, layer_norm_eps=1e-5, hidden_act="gelu")
BERT_BASE = dict(
    num_attention_heads=12, hidden_size=768, num_hidden_layers=12, intermediate_size=3072,
    vocab_size=30522, max_position_embeddings=512, type_vocab_size=2, layer_norm_eps=1e-12,
    hidden_act="gelu")


def encoder_config(family, layers=None):
    """(config, HF-style namespace) of ``family`` ("longformer" or "bert") at
    its published widths, ``layers`` deep (the published depth when None)."""
    import types

    from fastertransformer4codefuse_tpu_torch.models import registry

    hf = dict(LONGFORMER_BASE if family == "longformer" else BERT_BASE)
    if layers is not None:
        hf["num_hidden_layers"] = layers
    ns = types.SimpleNamespace(**hf)
    return registry.get(family).config_from_hf(ns), ns


def random_hf_state_dict(torch, family, ns, seed):
    """Random weights from ``seed`` under HF's parameter names for ``family``:
    N(0, 0.02) as HF initialises them, the query and key projections at 0.06
    (so the attention is not near uniform), LayerNorm weights near 1."""
    g = torch.Generator().manual_seed(seed)
    H, F_, L = ns.hidden_size, ns.intermediate_size, ns.num_hidden_layers
    shapes = {
        "embeddings.word_embeddings.weight": (ns.vocab_size, H),
        "embeddings.position_embeddings.weight": (ns.max_position_embeddings, H),
        "embeddings.token_type_embeddings.weight": (ns.type_vocab_size, H),
        "embeddings.LayerNorm.weight": (H,), "embeddings.LayerNorm.bias": (H,),
        "pooler.dense.weight": (H, H), "pooler.dense.bias": (H,),
    }
    projs = ["query", "key", "value"]
    if family == "longformer":
        projs += ["query_global", "key_global", "value_global"]
    for i in range(L):
        a = f"encoder.layer.{i}."
        for n in projs:
            shapes[a + f"attention.self.{n}.weight"] = (H, H)
            shapes[a + f"attention.self.{n}.bias"] = (H,)
        shapes.update({
            a + "attention.output.dense.weight": (H, H), a + "attention.output.dense.bias": (H,),
            a + "attention.output.LayerNorm.weight": (H,),
            a + "attention.output.LayerNorm.bias": (H,),
            a + "intermediate.dense.weight": (F_, H), a + "intermediate.dense.bias": (F_,),
            a + "output.dense.weight": (H, F_), a + "output.dense.bias": (H,),
            a + "output.LayerNorm.weight": (H,), a + "output.LayerNorm.bias": (H,),
        })
    sd = {}
    for name, shape in shapes.items():
        std = 0.06 if ("query" in name or "key" in name) and name.endswith("weight") else 0.02
        t = torch.randn(shape, generator=g) * std
        sd[name] = t + 1.0 if name.endswith("LayerNorm.weight") else t
    return sd


def encoder_params(torch, family, layers, seed, int8=False):
    """(config, CPU fp32 params, card bf16 params) of ``family`` at its
    published widths and ``layers`` deep, through the port's HF converter
    (and, for ``int8``, ``quantize_bert_params``): built in fp32 on the CPU,
    copied to the card with the float weights in bf16."""
    from fastertransformer4codefuse_tpu_torch.models import bert, registry
    from fastertransformer4codefuse_tpu_torch.models.params import params_to

    cfg, ns = encoder_config(family, layers)
    sd = random_hf_state_dict(torch, family, ns, seed)
    p_cpu = registry.get(family).params_from_hf(cfg, sd, "fp32", device="cpu")
    if int8:
        p_cpu = bert.quantize_bert_params(p_cpu)
    return cfg, p_cpu, params_to(p_cpu, "cuda", dtype="bf16")


def phase_reference_encoders(torch):
    """2-layer Longformer-base (B = 2, S = 2048, lengths 2048 and 1300: no
    global tokens, K12 on the card; then a global token at position 0 of
    each row, the dense path) and 2-layer int8 BERT-base (B = 2, S = 512,
    lengths 512 and 300, token types: K1 on the card), card (bf16) against
    CPU (fp32, plain versions). Returns [(label, max |dhidden| / max |hidden|
    over the real rows, the same for the pooled output)]."""
    from fastertransformer4codefuse_tpu_torch.models import bert, longformer

    out = []
    rng = np.random.default_rng(12)
    for family, S, lens, seed in (("longformer", 2048, [2048, 1300], 31),
                                  ("bert", 512, [512, 300], 32)):
        cfg, p_cpu, p_gpu = encoder_params(torch, family, 2, seed, int8=family == "bert")
        ids = rng.integers(2, cfg.vocab_size, (2, S)).astype(np.int32)
        ln = np.array(lens, np.int32)
        tt = (rng.random((2, S)) > 0.5).astype(np.int32)
        gm = np.zeros((2, S), bool)
        gm[:, 0] = True
        cases = [("", None)] + ([(", global token at 0 (dense path)", gm)]
                                if family == "longformer" else [])
        real = torch.from_numpy(np.arange(S)[None, :] < ln[:, None])
        for tag, glob in cases:
            res = {}
            for name, p in (("card", p_gpu), ("cpu", p_cpu)):
                if family == "longformer":
                    h, pooled = longformer.encode(cfg, p, ids, ln, global_mask=glob,
                                                  use_kernel=True)
                else:
                    h, pooled = bert.encode(cfg, p, ids, ln, tt)
                res[name] = (h.float().cpu(), pooled.float().cpu())
            (h, pooled), (h_ref, p_ref) = res["card"], res["cpu"]
            if not (bool(torch.isfinite(h).all()) and h.shape == (2, S, cfg.hidden_size)):
                raise RuntimeError(f"{family}{tag}: bad hidden states {tuple(h.shape)}")
            out.append((f"{family} {cfg.layer_num} layers S={S} lengths {lens}{tag}",
                        rel_err(torch, h[real], h_ref[real])[1], rel_err(torch, pooled, p_ref)[1]))
    return out


class TimedEngine:
    """An encoder engine whose ``encode`` also records, per batch, its rows,
    width, real tokens, host wall ms (ending in a synchronise) and the device
    span ms between CUDA events around it."""

    def __init__(self, torch, engine):
        self.torch, self.engine, self.batches = torch, engine, []

    def encode(self, ids, lens):
        torch = self.torch
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        out = self.engine.encode(ids, lens)
        e1.record()
        torch.cuda.synchronize()
        self.batches.append((ids.shape[0], ids.shape[1], int(np.sum(lens)),
                             (time.perf_counter() - t0) * 1e3, e0.elapsed_time(e1)))
        return out


def drive_encoder(srv, reqs):
    """Submit each of ``reqs`` from its own thread, all at once, to ``srv``;
    returns (results, errors, wall seconds to the last completion)."""
    results, errors = [None] * len(reqs), []

    def call(i):
        try:
            results[i] = srv.encode(reqs[i], timeout=600)
        except Exception as e:  # noqa: BLE001 -- reported by the caller
            errors.append(f"request {i}: {e!r}")

    threads = [threading.Thread(target=call, args=(i,)) for i in range(len(reqs))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    if any(r is None for r in results) and not errors:
        errors.append("a request did not finish")
    return results, errors, time.perf_counter() - t0


def serve_encoder(torch, engine, reqs, server_kw, label, tol, repeats=4, windows=3):
    """Serve ``reqs`` (token id lists) from one thread each through an
    ``EncoderBatchingServer`` over ``engine``, then encode each alone, padded
    to the same bucket; every request's hidden state and pooled output must
    equal its solo encode within ``tol`` of its max |value|. Then the rate of
    the server under load: ``windows`` timed windows, each submitting the
    mix ``repeats`` times at once (one thread a request) and ending with the
    last completion; each window's encodes/s and tokens/s are logged with
    their median and range. Returns (an error message or None, forwards
    run)."""
    from fastertransformer4codefuse_tpu_torch.engine.encoder_server import EncoderBatchingServer

    timed = TimedEngine(torch, engine)
    srv = EncoderBatchingServer(timed, **server_kw)
    try:
        torch.cuda.reset_peak_memory_stats()
        results, errors, wall = drive_encoder(srv, reqs)
        if errors:
            return f"{label}: requests failed: {errors}", 0
        batches = srv.batches_run
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"  {label}: {len(reqs)} requests of {min(map(len, reqs))}-{max(map(len, reqs))} "
            f"tokens in {batches} batches, {wall:.2f} s, peak {peak:.2f} GiB ({CARD})")
        for rows, width, toks, wall_ms, dev_ms in timed.batches:
            log(f"    batch {rows} x {width} ({toks} tokens): wall {wall_ms:.1f} ms, device "
                f"span {dev_ms:.1f} ms ({CARD})")
        if batches >= len(reqs) or srv.requests_served != len(reqs):
            return f"{label}: {batches} batches for {len(reqs)} requests", 0
        mix = list(reqs) * repeats
        n_tok = sum(map(len, mix))
        rates = []
        for _ in range(windows):
            b0 = srv.batches_run
            _, errors, wall = drive_encoder(srv, mix)
            if errors:
                return f"{label}: requests failed under load: {errors[:3]}", 0
            rates.append((len(mix) / wall, n_tok / wall, srv.batches_run - b0))
        enc = [r[0] for r in rates]
        log(f"  {label} under load: {windows} windows of the mix x{repeats} ({len(mix)} requests, "
            f"{n_tok} tokens): " + ", ".join(f"{e:.2f} encodes/s ({t:.0f} tokens/s, {n} batches)"
                                           for e, t, n in rates)
            + f"; median {statistics.median(enc):.2f} encodes/s, "
            f"{statistics.median(r[1] for r in rates):.0f} tokens/s, range "
            f"{min(enc):.2f}-{max(enc):.2f} ({CARD})")
        forwards = srv.batches_run
    finally:
        srv.close()
    bucket = server_kw["seq_bucket"]
    worst_h = worst_p = 0.0
    for i, ids in enumerate(reqs):
        W = -(-len(ids) // bucket) * bucket
        padded = np.zeros((1, W), np.int32)
        padded[0, :len(ids)] = ids
        h, p = engine.encode(padded, np.array([len(ids)], np.int32))
        h, p = h[0, :len(ids)].float().cpu(), p[0].float().cpu()
        got_h, got_p = (torch.from_numpy(a) for a in results[i])
        if got_h.shape != h.shape or not bool(torch.isfinite(got_h).all()):
            return f"{label}: request {i}: bad hidden state {tuple(got_h.shape)}", 0
        worst_h = max(worst_h, rel_err(torch, got_h, h)[1])
        worst_p = max(worst_p, rel_err(torch, got_p, p)[1])
    log(f"  {label}: every request equals its solo encode: worst max |d| / max |value| "
        f"{worst_h:.2e} (hidden), {worst_p:.2e} (pooled) (tol {tol:g})")
    if max(worst_h, worst_p) >= tol:
        return f"{label}: a batched request differs from its solo encode", 0
    return None, forwards + len(reqs)


def longformer_drift(torch, engine, reqs, seeds=3):
    """Where a Longformer request's batched-vs-solo gap comes from; logs
    three readings and returns an error message if (a) is not exact, or
    None. Request 1 (3500 tokens in phase 6), at its bucket's width W (3584):
    (a) in two batches of one shape (4 x W) with other companions and at
        another row: the same kernels run, so any gap is a dependence on the
        batch inside the path;
    (b) layer 0's dense GEMMs on random bf16 rows: the first W rows' fp32
        products at M = W and at M = 4 W (other cuBLAS kernels), each
        rounded to bf16: the share of outputs whose bf16 values differ, and
        by how many ulps at most;
    (c) alone, with that share of every dense GEMM's bf16 outputs moved by
        one ulp (``seeds`` draws): the drift that such roundings grow into
        through 12 layers, against the clean solo encode."""
    from fastertransformer4codefuse_tpu_torch.models import longformer
    from fastertransformer4codefuse_tpu_torch.models.params import layer_slice
    from fastertransformer4codefuse_tpu_torch.ops.linear import apply_act

    n = len(reqs[1])
    W = -(-n // 128) * 128

    def run(rows):
        ids = np.zeros((len(rows), W), np.int32)
        for i, r in enumerate(rows):
            ids[i, :len(reqs[r])] = reqs[r]
        h, p = engine.encode(ids, np.array([len(reqs[r]) for r in rows], np.int32))
        return h.float(), p.float()

    def gap(x, row_x, y, row_y):
        return max(rel_err(torch, x[0][row_x, :n], y[0][row_y, :n])[1],
                   rel_err(torch, x[1][row_x], y[1][row_y])[1])

    solo, batch_a, batch_b = run([1]), run([1, 2, 3, 4]), run([5, 6, 1, 7])
    same_shape, alone = gap(batch_a, 0, batch_b, 2), gap(batch_a, 0, solo, 0)

    lp = layer_slice(engine.params["layers"], 0)
    gen = torch.Generator(device="cuda").manual_seed(5)
    shares, max_ulps = [], 0
    for name in ("q_w", "proj_w", "up_w", "down_w"):
        w = lp[name].float()
        x = torch.randn(4 * W, w.shape[0], device="cuda", generator=gen).to(torch.bfloat16)
        full = (x.float() @ w).to(torch.bfloat16)[:W]
        part = (x[:W].float() @ w).to(torch.bfloat16)
        diff = full != part
        shares.append(diff.float().mean().item())
        same_sign = (full.float() * part.float()) > 0
        d = (full.view(torch.int16).int() - part.view(torch.int16).int()).abs()
        max_ulps = max(max_ulps, int(d[same_sign].max()) if bool(same_sign.any()) else 0)
    share = max(shares)

    dense = longformer.linear

    def flipped(x, w, b=None, act=None):
        y = dense(x, w)
        moved = torch.rand(y.shape, device=y.device, generator=gen) < share
        y = (y.view(torch.int16) + moved.to(torch.int16)).view(y.dtype)
        if b is not None:
            y = y + b.to(y.dtype)
        return y if act is None else apply_act(y, act)

    drifts = []
    longformer.linear = flipped
    try:
        for s in range(seeds):
            gen.manual_seed(100 + s)
            drifts.append(gap(run([1]), 0, solo, 0))
    finally:
        longformer.linear = dense
    log(f"  longformer batch drift, request 1 ({n} tokens) at width {W} (max |d| / max |value|"
        f" over hidden and pooled): (a) rows 0 and 2 of two 4 x {W} batches with other "
        f"companions {same_shape:.2e}; alone vs in a batch of 4 {alone:.2e}; (b) layer 0's "
        f"GEMMs at M = {W} vs 4 x {W}: bf16 outputs differing "
        f"{', '.join(f'{x:.2e}' for x in shares)} (q, proj, up, down), at most {max_ulps} ulp; "
        f"(c) alone with {share:.2e} of every dense GEMM's outputs moved by one bf16 ulp, "
        f"{seeds} draws: {', '.join(f'{x:.2e}' for x in drifts)}")
    if same_shape != 0.0:
        return "longformer: a request's result depends on its batch companions at one shape"
    return None


def check_encoder_counts(torch, kernels, launched, expect, label):
    """The counters (zeroed just before ``label``) against ``expect``; add
    them to ``launched``."""
    torch.cuda.synchronize()
    counts = read_counts(kernels)
    want = {n: 0 for n in counts}
    want.update(expect)
    log(f"  {label}: launches {({n: c for n, c in counts.items() if c})}, expected "
        f"{({n: c for n, c in want.items() if c})}")
    if counts != want:
        return f"{label}: kernel launch counts do not match the forwards run"
    for n in kernels:
        launched[n] += counts[n]
    return None


def encoder_profile(torch, engine, ids, lens, label):
    """Device time by kernel of one encode under torch.profiler."""
    from fastertransformer4codefuse_tpu_torch.utils.profiling import summarize_trace, trace

    engine.encode(ids, lens)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with trace(cpu=False) as prof:
        engine.encode(ids, lens)
    wall = (time.perf_counter() - t0) * 1e3
    rows = [r[:3] for r in summarize_trace(prof, top=0)]
    dev = sum(r[1] for r in rows)
    log(f"  {label}: wall {wall:.1f} ms (profiled), device kernels {dev:.1f} ms "
        f"({dev / wall:.0%} busy; {CARD}); by kernel:")
    for name, ms, n in rows[:6]:
        log(f"    {ms:9.3f} ms {n:5d}x  {name[:90]}")
    log_named(rows, dev)


def phase_encoders(torch, kernels, launched):
    """Phase 6: encoder serving at full depth. Longformer-base (12 layers,
    bf16) behind an EncoderBatchingServer (max_batch 4, seq_bucket 128,
    max_seq_len 4096) takes 8 requests of 300-4096 tokens (K12, 12 launches
    a forward), then that mix x4 in three timed windows; where its
    batched-vs-solo gap comes from (``longformer_drift``); a batch with a global token at position 0 takes the dense
    path (no K12); int8 BERT-base (12 layers) behind the same server class
    (max_batch 8, seq_bucket 32, max_seq_len 512) takes 16 requests of
    32-512 tokens (K1, 48 launches a forward), then that mix x4 in three
    timed windows. Returns an error message, or None."""
    import gc

    from fastertransformer4codefuse_tpu_torch.models import registry

    # bf16 rounding through 12 post-LN layers: a batched row's fp32 GEMMs
    # (another cuBLAS kernel at another M) sum in another order than the same
    # row alone, and the bf16 roundings after them drift apart layer by
    # layer; longformer_drift below shows it (one shape: exact; one-ulp
    # flips injected at the measured share drift as far as batching does).
    # Phase 3 holds the card to the CPU with the same 5e-2
    tol = 5e-2
    rng = np.random.default_rng(13)
    log("phase 6: encoder serving: Longformer-base (12 layers, K12) and int8 BERT-base "
        "(12 layers, K1) behind EncoderBatchingServer")
    t0 = time.time()
    cfg, _, params = encoder_params(torch, "longformer", None, 41)
    eng = registry.get("longformer").make_engine(cfg, params)
    V = cfg.vocab_size
    log(f"  Longformer-base params built in {time.time() - t0:.1f} s")
    lens = (4096, 3500, 2900, 2048, 1500, 1024, 700, 300)
    reqs = [rng.integers(2, V, n).tolist() for n in lens]
    eng.encode(np.array([reqs[-1]], np.int32), np.array([lens[-1]], np.int32))  # warm-up
    zero_counts(kernels)
    err, forwards = serve_encoder(torch, eng, reqs, dict(max_batch=4, seq_bucket=128,
                                                         max_seq_len=4096), "longformer", tol)
    if err:
        return err
    err = check_encoder_counts(torch, kernels, launched,
                               {"sliding_window_attention": cfg.layer_num * forwards},
                               f"longformer, {forwards} forwards without global tokens")
    if err:
        return err
    err = longformer_drift(torch, eng, reqs)
    if err:
        return err
    # one batch with a global token at position 0 takes the dense path
    S = 4096
    ids = np.stack([np.array(reqs[0], np.int32), np.pad(np.array(reqs[2], np.int32),
                                                        (0, S - lens[2]))])
    ln = np.array([S, lens[2]], np.int32)
    gm = np.zeros((2, S), bool)
    gm[:, 0] = True
    zero_counts(kernels)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    h_g, p_g = eng.encode(ids, ln, global_mask=gm)
    torch.cuda.synchronize()
    t_g = (time.perf_counter() - t1) * 1e3
    err = check_encoder_counts(torch, kernels, launched, {},
                               "longformer, one forward with a global token (dense path)")
    if err:
        return err
    h_l, _ = eng.encode(ids, ln)  # the same batch without the global token (K12)
    torch.cuda.synchronize()
    if not (bool(torch.isfinite(h_g.float()).all()) and h_g.shape == (2, S, cfg.hidden_size)
            and bool(torch.isfinite(p_g.float()).all())):
        return "longformer with a global token: bad hidden states"
    moved = (h_g[:, 0].float() - h_l[:, 0].float()).abs().max().item()
    log(f"  longformer, B=2 S=4096 with a global token at position 0 (dense path): "
        f"{t_g:.1f} ms, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({CARD}); "
        f"position 0 moves by {moved:.3f} against the local-only encode")
    if moved == 0.0:
        return "longformer: the global token changed nothing"
    encoder_profile(torch, eng, np.array([reqs[0]], np.int32), np.array([lens[0]], np.int32),
                    "longformer encode of 4096 tokens, B=1")
    del eng, params, h_g, h_l, p_g
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.time()
    cfg, _, params = encoder_params(torch, "bert", None, 42, int8=True)
    eng = registry.get("bert").make_engine(cfg, params)
    log(f"  int8 BERT-base params built in {time.time() - t0:.1f} s")
    lens = [32, 512] + rng.integers(32, 513, 14).tolist()
    reqs = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]
    eng.encode(np.array([reqs[0]], np.int32), np.array([lens[0]], np.int32))  # warm-up
    zero_counts(kernels)
    err, forwards = serve_encoder(torch, eng, reqs, dict(max_batch=8, seq_bucket=32,
                                                         max_seq_len=512), "int8 bert", tol)
    if err:
        return err
    err = check_encoder_counts(torch, kernels, launched, bert_launches(cfg.layer_num, forwards),
                               f"int8 bert, {forwards} forwards")
    if err:
        return err
    encoder_profile(torch, eng, np.array([reqs[1]] * 8, np.int32), np.array([512] * 8, np.int32),
                    "int8 bert encode of 8 x 512 tokens")
    return None


def bert_launches(L, forwards):
    """Launches an int8 BERT must count for ``forwards`` encodes of L layers:
    K1's GEMM for QKV, the attention output, the intermediate and the output
    products."""
    return {"quant_matmul": 4 * L * forwards}


def kernel_table():
    """The kernel wrappers: name -> (wrapper, its counter, source, the TPU
    kernel it replaces)."""
    from fastertransformer4codefuse_tpu_torch.ops.attention import (
        prefill_attention_flash, prefill_flash_bwd_dkv, prefill_flash_bwd_dq,
    )
    from fastertransformer4codefuse_tpu_torch.ops.flash_decode import (
        flash_chunk_paged, flash_decode_beam_stacked, flash_decode_paged, flash_decode_stacked,
    )
    from fastertransformer4codefuse_tpu_torch.ops.quant_matmul import quant_matmul
    from fastertransformer4codefuse_tpu_torch.ops.quant_matmul_fused import (
        fused_proj_down, fused_qkv_up, fused_up_proj_down,
    )
    from fastertransformer4codefuse_tpu_torch.ops.quant_matmul_w4 import (
        quant_matmul_w4, quant_matmul_w4_group, quant_matmul_w4_head,
    )
    from fastertransformer4codefuse_tpu_torch.ops.sliding_window import sliding_window_attention

    src = "fastertransformer4codefuse_tpu_torch/csrc/"
    tpu = "fastertransformer4codefuse_tpu/ops/"
    lib = "jax/experimental/pallas/ops/tpu/"
    # name -> (wrapper, its counter, source, the TPU kernel it replaces: the
    # line of its pl.pallas_call, or of the library flash_attention call for
    # K5). A packed-int4 form counts its launches apart (``launches_packed``)
    # and within the wrapper's ``launches``.
    return {
        "quant_matmul": (quant_matmul, "launches", src + "quant_matmul.cu",
                         tpu + "quant_matmul.py:221"),
        "fused_up_proj_down": (fused_up_proj_down, "launches", src + "quant_matmul_fused.cu",
                               tpu + "quant_matmul_fused.py:571"),
        "fused_proj_down": (fused_proj_down, "launches", src + "quant_matmul_fused.cu",
                            tpu + "quant_matmul_fused.py:360"),
        "fused_qkv_up": (fused_qkv_up, "launches", src + "quant_matmul_fused.cu",
                         tpu + "quant_matmul_fused.py:226"),
        "flash_decode": (flash_decode_stacked, "launches", src + "flash_decode.cu",
                         tpu + "flash_decode.py:674"),
        "quant_matmul_w4": (quant_matmul_w4, "launches", src + "quant_matmul_w4.cu",
                            tpu + "quant_matmul_w4.py:262"),
        "quant_matmul_w4_group": (quant_matmul_w4_group, "launches", src + "quant_matmul_w4.cu",
                                  tpu + "quant_matmul_w4.py:376"),
        "quant_matmul_w4_head": (quant_matmul_w4_head, "launches", src + "quant_matmul_w4.cu",
                                 tpu + "quant_matmul_w4.py:124"),
        "flash_decode_paged": (flash_decode_paged, "launches", src + "flash_decode_paged.cu",
                               tpu + "flash_decode.py:458"),
        "flash_chunk_paged": (flash_chunk_paged, "launches", src + "flash_chunk.cu",
                              tpu + "flash_decode.py:567"),
        "prefill_attention_flash": (prefill_attention_flash, "launches", src + "prefill_flash.cu",
                                    tpu + "attention.py:61"),
        "flash_decode_int4": (flash_decode_stacked, "launches_packed", src + "flash_decode.cu",
                              tpu + "flash_decode.py:674"),
        "flash_decode_paged_int4": (flash_decode_paged, "launches_packed",
                                    src + "flash_decode_paged.cu", tpu + "flash_decode.py:458"),
        "flash_chunk_paged_int4": (flash_chunk_paged, "launches_packed", src + "flash_chunk.cu",
                                   tpu + "flash_decode.py:567"),
        "flash_decode_beam": (flash_decode_beam_stacked, "launches",
                              src + "flash_decode_beam.cu", tpu + "flash_decode.py:349"),
        "sliding_window_attention": (sliding_window_attention, "launches",
                                     src + "sliding_window.cu", tpu + "sliding_window.py:141"),
        # the int4 instances with fp32 group scales (FTCF_GSCALE_BF16=0),
        # counted apart and within their wrappers' ``launches``
        "quant_matmul_w4_group_f32": (quant_matmul_w4_group, "launches_f32",
                                      src + "quant_matmul_w4.cu", tpu + "quant_matmul_w4.py:376"),
        "fused_qkv_up_f32": (fused_qkv_up, "launches_f32", src + "quant_matmul_fused.cu",
                             tpu + "quant_matmul_fused.py:226"),
        "fused_proj_down_f32": (fused_proj_down, "launches_f32", src + "quant_matmul_fused.cu",
                                tpu + "quant_matmul_fused.py:360"),
        "fused_up_proj_down_f32": (fused_up_proj_down, "launches_f32",
                                   src + "quant_matmul_fused.cu",
                                   tpu + "quant_matmul_fused.py:571"),
        # the group-wise forms no served model makes (ROADMAP item 11): K1 and
        # K13 on int8 weights with group scales, K7 as the group-wise
        # transposed head; counted apart and within their wrappers' launches
        "quant_matmul_g8": (quant_matmul, "launches_g8", src + "quant_matmul.cu",
                            tpu + "quant_matmul.py:221"),
        "fused_qkv_up_g8": (fused_qkv_up, "launches_g8", src + "quant_matmul_fused.cu",
                            tpu + "quant_matmul_fused.py:226"),
        "quant_matmul_w4_group_head": (quant_matmul_w4_group, "launches_head",
                                       src + "quant_matmul_w4.cu",
                                       tpu + "quant_matmul_w4.py:376"),
        # training (phase 12): K5's fp32 instance, counted apart and within
        # its wrapper's launches, and the library kernel's backward (its
        # custom_vjp's dK/dV and dQ pallas_calls, in the installed JAX)
        "prefill_attention_flash_f32": (prefill_attention_flash, "launches_f32",
                                        src + "prefill_flash_f32.cu", tpu + "attention.py:61"),
        "prefill_flash_bwd_dkv": (prefill_flash_bwd_dkv, "launches", src + "prefill_flash_bwd.cu",
                                  lib + "flash_attention.py:1121"),
        "prefill_flash_bwd_dq": (prefill_flash_bwd_dq, "launches", src + "prefill_flash_bwd.cu",
                                 lib + "flash_attention.py:1456"),
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    sys.path.insert(0, REPO)
    try:
        import fastertransformer4codefuse_tpu_torch as pkg
    except ImportError as e:
        return fail(f"the port's package is not beside this script: {e}")
    from fastertransformer4codefuse_tpu_torch.engine import kv_cache
    from fastertransformer4codefuse_tpu_torch.ops import _cuda
    from fastertransformer4codefuse_tpu_torch.ops.attention import prefill_attention

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    global CARD, ROUTERS
    CARD = smi
    ROUTERS = (prefill_attention, kv_cache.attend_chunk, kv_cache.attend_decode)
    log("phase 1: device")
    log(f"  device {kind} x{torch.cuda.device_count()}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    log(f"  nvidia-smi: {smi}")
    t0 = time.time()
    lib_path = _cuda.build()
    _cuda.lib()
    log(f"  kernels built in {time.time() - t0:.1f} s -> {os.path.relpath(lib_path, REPO)}")
    log("  compile time per source: " + ", ".join(
        line[3:] for line in _cuda.build_log.splitlines()
        if line.startswith("== ") and "(" in line))
    entries = ptxas_entries(_cuda.build_log)
    for src_name, kern, args, regs, st, ld in entries:
        if st or ld:
            log(f"    spills: {src_name} {kern}<{args}>: {regs} registers, {st} B spill stores, "
                f"{ld} B spill loads")
    # The TMA + wgmma instances (the prefill attention body <dh, policy>: K5
    # CausalPrefix from prefill_flash.cu, K12 Band from sliding_window.cu;
    # K10 <dh, K format, V format>, the GEMM <format, rows, columns> (its
    # four block tiles, each from gemm_<rows>x<columns>.cu); ptxas reports
    # the launch bound's 168, and setmaxnreg gives the consumers 232-240) and
    # every GEMV partial instance <NB, format>: NB 0 is the M = 1 loop, NB
    # 1/2/4 the tensor-core body's 8-row B tiles; formats W_I8 = 0, W_I4 = 1,
    # W_I4G = 2, W_I8G = 3, W_I4GF = 4
    wgmma_kernels = ("prefill_flash_kernel", "flash_chunk_kernel", "qmm_gemm_kernel")

    def instance(src_name, kern, args):
        if kern == "prefill_flash_kernel":
            return f"{kern}<{args}, {'Band' if src_name.startswith('sliding') else 'CausalPrefix'}>"
        return f"{kern}<{args}>"

    log("  registers (spill stores/loads, bytes): " + ", ".join(
        f"{instance(src_name, kern, args)} {regs} ({st}/{ld})"
        for src_name, kern, args, regs, st, ld in entries
        if kern in wgmma_kernels or kern.startswith("gemv")))
    band = sorted(args for src_name, kern, args, *_ in entries
                  if kern == "prefill_flash_kernel" and src_name.startswith("sliding"))
    if band != ["128", "64"]:
        return fail(f"K12's Band instances of the prefill body (dh 64, 128) not built: {band}")
    from fastertransformer4codefuse_tpu_torch.ops.quant_matmul import FORMAT_NAMES, GEMM_TILES

    gemm = sorted(args for _, kern, args, *_ in entries if kern == "qmm_gemm_kernel")
    want = sorted(f"{f},{r},{c}" for f in FORMAT_NAMES for r, c in GEMM_TILES)
    if gemm != want:
        return fail(f"the GEMM's instances <format, rows, columns> built: {gemm}, not {want}")
    gemv_over = [f"{kern}<{args}>" for _, kern, args, regs, st, ld in entries
                 if "partial_kernel" in kern and (regs > 128 or st or ld)]
    if gemv_over:
        return fail(f"GEMV instances over 128 registers or spilling: {gemv_over}")
    wgmma_spills = [instance(src_name, kern, args) for src_name, kern, args, regs, st, ld
                    in entries if kern in wgmma_kernels and (st or ld)]
    if wgmma_spills:
        return fail(f"TMA + wgmma instances spilling: {wgmma_spills}")
    # the decode attention body (K4, K9, K11: <dh, K format, V format> in
    # each entry file; formats KV_BF16 = 0, KV_I8 = 1, KV_I4 = 2) and its
    # combine <dh>: none may spill
    decode_kernels = ("flash_decode_kernel", "flash_decode_combine_kernel")
    log("  decode attention registers (spill stores/loads, bytes): " + ", ".join(
        f"{src_name.split('.')[0]} {kern.split('_kernel')[0]}<{args}> {regs} ({st}/{ld})"
        for src_name, kern, args, regs, st, ld in entries if kern in decode_kernels))
    decode_spills = [f"{src_name} {kern}<{args}>" for src_name, kern, args, regs, st, ld in entries
                     if kern in decode_kernels and (st or ld)]
    if decode_spills:
        return fail(f"decode attention instances spilling: {decode_spills}")
    # K5's fp32 instances and its backward (prefill_flash_f32.cu,
    # prefill_flash_bwd.cu): <dh> of each of the three kernels
    f32 = sorted((kern.split("prefill_f32_")[-1], args, regs, st, ld)
                 for _, kern, args, regs, st, ld in entries if "prefill_f32_" in kern)
    log("  K5 fp32 and backward registers (spill stores/loads, bytes): " + ", ".join(
        f"{kern}<{args}> {regs} ({st}/{ld})" for kern, args, regs, st, ld in f32))
    want = sorted((k, d) for k in ("bwd_dkv_kernel", "bwd_dq_kernel", "fwd_kernel")
                  for d in ("128", "256", "64"))
    if sorted((k, a) for k, a, *_ in f32) != want:
        return fail(f"K5's fp32 and backward instances built: {f32}")
    bwd_spills = [f"{kern}<{args}>" for kern, args, regs, st, ld in f32
                  if kern.startswith("bwd_") and (st or ld)]
    if bwd_spills:
        return fail(f"K5's backward (3xTF32) instances spilling: {bwd_spills}")

    kernels = kernel_table()
    records = {
        n: {"name": n, "route": "cuda", "source": s, "replaces": r, "launches": 0,
            "max_abs_err": 0.0, "ms": None, "plain_ms": None, "bound_ms": None,
            "bound_by": None, "library_ms": None}
        for n, (_, _, s, r) in kernels.items()
    }
    if not phase_kernels(torch, records):
        return fail("a kernel disagrees with its plain version")
    err = phase_tile_cache(torch)
    if err:
        return fail(f"tile cache: {err}")

    log("phase 3: CodeFuse-13B-width (int8 2 layers, int4 1), Longformer-base and BERT-base "
        "models, card (kernels) vs CPU (plain); tiny configs of 64-wide heads, g = 16, bf16 "
        "pages of 4 and 32-wide heads served on both")
    tol_ref = 5e-2
    launched = {n: 0 for n in kernels}
    int8_ref = None  # built once, shared by the int8 cases below
    for fn in ROUTERS:
        fn.plain_routes = 0
    t_models = time.time()
    for label, quant in CONFIGS:
        ref = reference_model(torch, pkg, layers=REF_LAYERS[label], **quant)
        int8_ref = ref if label == "int8" else int8_ref
        card = {}
        for fused in (True, False) if label in ("int8", "int4 g128") else (True,):
            card[fused] = []
            rels = phase_reference(torch, ref, fused=fused, card_logits=card[fused])
            route = "K13 + K3" if fused else "fused_decode=False: unfused GEMMs"
            log(f"  {label} ({route}): max |dlogits| / max |logits| after prefill (K5) and 3 "
                f"teacher-forced decode steps: {', '.join(f'{r:.2e}' for r in rels)} "
                f"(tol {tol_ref:g})")
            if max(rels) >= tol_ref:
                return fail(f"{label}: card and CPU logits disagree")
        if False in card:
            # the two routes on the card: the same weights, other roundings
            # (bf16 proj and down outputs added apart, and the merged kernels)
            gaps = [rel_err(torch, a, b)[1] for a, b in zip(card[True], card[False])]
            log(f"  {label}: card logits, K13 + K3 route vs unfused, after prefill and each "
                f"step: {', '.join(f'{g:.2e}' for g in gaps)} (tol {tol_ref:g})")
            if max(gaps) >= tol_ref:
                return fail(f"{label}: the fused and unfused routes disagree on the card")
    err = phase_f32_scales(torch, pkg, kernels, launched, tol_ref)
    if err:
        return fail(err)
    int8_ref = first_layer(pkg, int8_ref)
    rels = phase_reference(torch, int8_ref, kv="int4")
    log(f"  int8 on an int4 dense cache (packed K4): {', '.join(f'{r:.2e}' for r in rels)} "
        f"(tol {tol_ref:g})")
    if max(rels) >= tol_ref:
        return fail("int4 dense cache: card and CPU logits disagree")
    for kv in (torch.int8, "int4"):
        rels = phase_reference_paged(torch, int8_ref, kv)
        log(f"  int8 on a paged {kv} pool (chunked prefill of ragged prompts, K10; decode, "
            f"K9): {', '.join(f'{r:.2e}' for r in rels)} (tol {tol_ref:g})")
        if max(rels) >= tol_ref:
            return fail(f"paged {kv}: card and CPU logits disagree")
    rels = phase_reference_beam(torch, int8_ref)
    log(f"  int8, 2 prompts tiled over 4 beams (prefill of 8 rows, K5; 3 teacher-forced beam "
        f"steps through a random beam history, K11): {', '.join(f'{r:.2e}' for r in rels)} "
        f"(tol {tol_ref:g})")
    if max(rels) >= tol_ref:
        return fail("beam decode: card and CPU logits disagree")
    del ref, int8_ref
    t_models, t_enc = time.time() - t_models, time.time()
    for label, rel_h, rel_p in phase_reference_encoders(torch):
        log(f"  {label}: max |dhidden| / max |hidden| {rel_h:.2e}, pooled {rel_p:.2e} "
            f"(tol {tol_ref:g})")
        if max(rel_h, rel_p) >= tol_ref:
            return fail(f"{label}: card and CPU hidden states disagree")
    plain = [fn.plain_routes for fn in ROUTERS]
    log(f"  plain attention routes over the CodeFuse-13B-width, Longformer and BERT models: "
        f"{plain} (prefill, chunk, decode; must be 0)")
    if any(plain):
        return fail("a CodeFuse-13B, Longformer or BERT path took a plain attention route")
    t_enc, t_routes = time.time() - t_enc, time.time()
    err = phase_routes(torch, pkg)
    if err:
        return fail(err)
    t_routes = time.time() - t_routes
    log(f"  phase 3 in {t_models + t_enc + t_routes:.1f} s: the 13B-width models "
        f"{t_models:.1f} s, the encoders {t_enc:.1f} s, the tiny configs {t_routes:.1f} s")

    for label, quant in CONFIGS:
        log(f"phase 4: CodeFuse-13B {label} ({SERVE_LAYERS[label]} layers, int8 KV) on the card")
        # the long-prompt runs on packed caches and phase 5's pools use the
        # int8 model phase 4 builds
        err = phase_serve(torch, pkg, quant, kernels, launched,
                          then=phase_int8_model if label == "int8" else None)
        if err:
            return fail(f"{label}: {err}")
    err = phase_w8a8(torch, pkg, kernels, launched)
    if err:
        return fail(err)
    err = phase_encoders(torch, kernels, launched)
    if err:
        return fail(err)
    err = phase_cli(torch, pkg, kernels, launched)
    if err:
        return fail(f"checkpoint -> CLI: {err}")
    err = phase_families(torch, pkg, kernels, launched)
    if err:
        return fail(f"decoder families: {err}")
    err = phase_seq2seq(torch, pkg, kernels, launched)
    if err:
        return fail(f"encoder-decoder, vision and audio families: {err}")
    err = phase_tp(torch, pkg, kernels, launched)
    if err:
        return fail(f"tensor parallelism: {err}")
    err = phase_pp(torch, pkg, kernels, launched)
    if err:
        return fail(f"pipeline parallelism: {err}")
    err = phase_train(torch, pkg, kernels, launched, records)
    if err:
        return fail(f"training: {err}")
    for n in records:
        records[n]["launches"] = launched[n]
    # K2 is off the served routes: K13 + K3 replace it (phase 2 holds it);
    # no served model makes the group-wise int8 weights or head (phase 2
    # holds those instances too)
    off_path = ("fused_up_proj_down", "fused_up_proj_down_f32", "quant_matmul_g8",
                "fused_qkv_up_g8", "quant_matmul_w4_group_head")
    for n in off_path:
        records[n]["on_main_path"] = False
    if not all(c for n, c in launched.items() if n not in off_path):
        return fail(f"a kernel of the main path was never launched by it: {launched}")
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
# phase 3's card-vs-CPU depth of each: the CPU's plain products (each int8
# or int4 weight dequantized to fp32 a call) take most of phase 3, so the
# int4 models, whose graph is the int8 model's, check 1 layer; the int8
# model keeps 2 (a layer fed by another, the cache and the stacked weights
# indexed past layer 0), and its int4-cache, paged and beam checks run its
# first layer (``first_layer``)
REF_LAYERS = {"int8": 2, "int4 per-channel": 1, "int4 g128": 1}
# phase 4's depth of each (the int8 model serves phases 4 and 5): 10 of the
# 40 layers, the int4 models 6, to keep the run within its time limit with
# phases 8, 9 and 12 (the decode paths are host-bound, their time in
# proportion to the depth)
SERVE_LAYERS = {"int8": 10, "int4 per-channel": 6, "int4 g128": 6}


def gemm_of(weight_bits, group_size):
    """The unfused GEMM wrapper of a weight format: K1, K6 or K7."""
    if group_size:
        return "quant_matmul_w4_group"
    return {8: "quant_matmul", 4: "quant_matmul_w4"}[weight_bits]


def expected_launches(L, prefills, forwards, weight_bits, group_size, packed_kv=False,
                      beam=False, fused=True, head=None):
    """Launches each kernel wrapper must count for a run of ``prefills``
    prefills and ``forwards`` decode forwards of an L-layer CodeFuse model
    (parallel residual, biases, the four big kernels quantized alike).
    ``fused`` (RuntimeConfig.fused_decode): a prefill runs QKV and up as K13's
    GEMM form and proj and down as GEMMs, a decode forward K13's GEMV and K3;
    unfused, all four are GEMMs (K1, K6 or K7) in both. Attention is K5 in
    prefill, K4 in decode (its packed form on an int4 cache; K11 for
    ``beam`` search). Every prefill and forward ends in one LM head call:
    K8 when ``head`` (default: the int4 weights' quantized head)."""
    gemm = gemm_of(weight_bits, group_size)
    attn = "flash_decode_beam" if beam else "flash_decode"
    out = {attn: L * forwards, "prefill_attention_flash": L * prefills}
    if packed_kv:
        out["flash_decode_int4"] = L * forwards
    if fused:
        out["fused_qkv_up"] = L * (prefills + forwards)
        out[gemm] = L * 2 * prefills
        out["fused_proj_down"] = L * forwards
    else:
        out[gemm] = L * 4 * (prefills + forwards)
    if (weight_bits == 4) if head is None else head:
        out["quant_matmul_w4_head"] = prefills + forwards
    return out


def add_counts(*counts):
    out = {}
    for c in counts:
        for n, v in c.items():
            out[n] = out.get(n, 0) + v
    return out


def phase_serve(torch, pkg, quant, kernels, launched, then=None):
    """Serve CodeFuse-13B with ``quant`` weights through engine and handler;
    returns an error message, or None. Adds this run's launches to
    ``launched``. ``then(torch, engine, kernels, launched)`` runs next on the
    same engine."""
    import gc

    from fastertransformer4codefuse_tpu_torch.api.handler import CodeFuseHandler
    from fastertransformer4codefuse_tpu_torch.api.trie import VocabTrie
    from fastertransformer4codefuse_tpu_torch.models.params import param_bytes

    cfg = pkg.GptNeoXConfig.codefuse_13b()
    label = next(n for n, q in CONFIGS if q == quant)
    cfg = pkg.GptNeoXConfig(**{**cfg.__dict__, "layer_num": SERVE_LAYERS[label]})
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

    zero_counts(kernels)
    clear_tile_counts()
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

    run([prompt[:100]], 1, top_k=1)  # the first call's set-up is not prefill time
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

    err = check_static_counts(torch, kernels, launched, cfg.layer_num, prefills, forwards, quant)
    if err:
        return err
    if not tile_hits(f"{label} engine and handler"):
        return "no launch of the served routes took its plan from the tile cache"
    err = fused_ab(torch, engine, prompt, kernels, launched, quant)
    if err:
        return err
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  peak device memory {peak:.2f} GiB; decode {step_ms:.2f} ms/step at B=1, "
        f"{step4_ms:.2f} ms/step at B=4; prefill {t_pre * 1e3:.1f} ms (1000 tokens)")
    if then is not None:
        return then(torch, engine, kernels, launched)
    return None  # the model is freed with this frame, before the next one is built


def fused_ab(torch, engine, prompt, kernels, launched, quant, out_len=33):
    """The ``fused_decode`` A/B on one engine's weights: the 1000-token
    prompt, a 1-token and an ``out_len``-token greedy run for each route,
    in turns (fused, unfused, unfused, fused); decode ms/step is the
    difference over the decode forwards. Logs both routes' ms/step and how
    many greedy tokens agree; checks the counts. Returns an error message,
    or None."""
    import dataclasses

    cfg = engine.config
    unfused = type(engine)(cfg, engine.params,
                           dataclasses.replace(engine.runtime, fused_decode=False))
    zero_counts(kernels)
    ms = {True: [], False: []}
    toks = {}
    expect, forwards = [], 0
    for fused in (True, False, False, True):
        e = engine if fused else unfused
        walls = []
        for n in (1, out_len):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = e.generate([prompt], n, top_k=1)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            forwards += e.decode_forwards
            expect.append(expected_launches(cfg.layer_num, 1, e.decode_forwards, fused=fused,
                                            **quant))
        ms[fused].append((walls[1] - walls[0]) / max(e.decode_forwards, 1) * 1e3)
        toks[fused] = out.output_ids[0, 0, len(prompt):out.sequence_lengths[0, 0]]
    same = int(np.sum(toks[True][:len(toks[False])] == toks[False][:len(toks[True])]))
    log(f"  fused_decode A/B (turns: fused, unfused, unfused, fused; {out_len - 1} decode "
        f"forwards each): K13 + K3 {', '.join(f'{m:.2f}' for m in ms[True])} ms/step, "
        f"unfused GEMMs {', '.join(f'{m:.2f}' for m in ms[False])} ms/step; greedy tokens "
        f"equal {same} of {len(toks[True])} ({CARD})")
    return check_static_counts(torch, kernels, launched, cfg.layer_num, len(expect), forwards,
                               quant, expect_runs=add_counts(*expect))


def with_kv(engine, kind):
    """An engine over the same weights with another KV cache kind."""
    import dataclasses

    return type(engine)(engine.config, engine.params,
                        dataclasses.replace(engine.runtime, kv_cache_dtype=kind))


def prefill_profile(torch, engine, prompt, label):
    """Wall time (best of two) of one prefill (``generate`` with output_len
    1) and the device time by kernel of a third under torch.profiler."""
    from fastertransformer4codefuse_tpu_torch.utils.profiling import summarize_trace, trace

    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.generate([prompt], 1, top_k=1)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with trace(cpu=False) as prof:
        engine.generate([prompt], 1, top_k=1)
    rows = [r[:3] for r in summarize_trace(prof, top=0)]
    dev = sum(r[1] for r in rows)
    log(f"  prefill of {len(prompt)} tokens, {label}: wall {min(walls):.1f} ms (best of 2), "
        f"device kernels {dev:.1f} ms ({CARD}); by kernel:")
    for name, ms, n in rows[:6]:
        log(f"    {ms:9.3f} ms {n:5d}x  {name[:90]}")
    log_named(rows, dev)
    return min(walls), dev, rows


# the kernels the profiles name: (label, a piece of the kernel's symbol)
PROFILED = (("K5 (prefill_flash_kernel, CausalPrefix)", "ftcf::CausalPrefix>"),
            ("K12 (prefill_flash_kernel, Band)", "ftcf::Band>"),
            ("K10 (flash_chunk_kernel)", "flash_chunk_kernel"),
            ("K4/K9/K11 splits (flash_decode_kernel)", "flash_decode_kernel"),
            ("K4/K9/K11 combine (flash_decode_combine_kernel)", "flash_decode_combine_kernel"),
            ("the GEMM (qmm_gemm_kernel: K1/K6/K7/K8/K13 at M > 32)", "qmm_gemm_kernel"),
            ("K13's GEMV partials (gemv_ncat_partial_kernel)", "gemv_ncat_partial_kernel"),
            ("K13's GEMV epilogue (gemv_ncat_epilogue_kernel)", "gemv_ncat_epilogue_kernel"),
            ("K3's / K1's GEMV partials (gemv_partial_kernel)", "gemv_partial_kernel"),
            ("K3's / K1's GEMV epilogue (gemv_epilogue_kernel)", "gemv_epilogue_kernel"))


def log_named(rows, dev, unit="ms"):
    """One line for each kernel of ``PROFILED`` in a profile's ``rows``
    (name, ms, launches): its device ms, launches and share of ``dev``."""
    for label, key in PROFILED:
        hit = [(ms, n) for name, ms, n in rows if key in name]
        if hit:
            ms = sum(m for m, _ in hit)
            log(f"    {label}: {ms:.3f} {unit} in {sum(n for _, n in hit):.0f} launches, "
                f"{ms / dev:.1%} of the device time")


def named_ms(rows, key):
    """The device ms of a profile's ``rows`` whose kernel names hold ``key``."""
    return sum(ms for name, ms, _ in rows if key in name)


def clear_tile_counts():
    from fastertransformer4codefuse_tpu_torch.ops import tile_tuning

    tile_tuning.hits.clear()
    tile_tuning.misses.clear()


def tile_hits(label):
    """Log the tile cache's hits and misses since ``clear_tile_counts``;
    returns the hits (launches whose plan came from a shipped entry)."""
    from fastertransformer4codefuse_tpu_torch.ops import tile_tuning

    h, m = sum(tile_tuning.hits.values()), sum(tile_tuning.misses.values())
    log(f"  tile cache, {label}: {h} launches took a shipped entry's plan, {m} the default "
        f"({', '.join(f'{k} {n}' for k, n in sorted(tile_tuning.hits.items()))})")
    return h


def phase_long(torch, engine, kernels, launched):
    """Long prompts on packed int4 KV caches, on the int8 CodeFuse-13B
    ``engine``'s weights: "int4" with a ~3000-token prompt (B = 1, 64 greedy
    tokens twice and once streamed), its prefill with K5 and once with the
    plain prefill attention forced in, then "int8k_int4v" with prompts of
    2048 and 1300 tokens (32 sampled tokens, twice). Returns an error
    message, or None."""
    from fastertransformer4codefuse_tpu_torch.models import gptneox
    from fastertransformer4codefuse_tpu_torch.ops.attention import prefill_attention_flash_plain

    cfg = engine.config
    L, V = cfg.layer_num, cfg.vocab_size
    quant = dict(weight_bits=8, group_size=0)
    rng = np.random.default_rng(11)
    eng = with_kv(engine, "int4")
    log("phase 4: CodeFuse-13B int8, long prompts on packed int4 KV caches")
    prompt = rng.integers(0, V, 3000).tolist()
    zero_counts(kernels)
    torch.cuda.reset_peak_memory_stats()
    forwards = prefills = 0

    def run(e, *a, **kw):
        nonlocal forwards, prefills
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = e.generate(*a, **kw)
        torch.cuda.synchronize()
        forwards += e.decode_forwards
        prefills += 1
        return out, time.perf_counter() - t, e.decode_forwards

    _, t_pre, _ = run(eng, [prompt], 1, top_k=1)
    g1, t1, f1 = run(eng, [prompt], 64, top_k=1, return_cum_log_probs=True)
    g2, _, _ = run(eng, [prompt], 64, top_k=1, return_cum_log_probs=True)
    streamed = []
    g3, _, _ = run(eng, [prompt], 64, top_k=1,
                   callback=lambda m: streamed.append(m["last_tokens"][0][0]))
    gen = g1.output_ids[0, 0, 3000:g1.sequence_lengths[0, 0]]
    if not (np.array_equal(g1.output_ids, g2.output_ids)
            and np.array_equal(g1.output_ids, g3.output_ids)):
        return "int4 KV: greedy runs of one long prompt differ"
    if streamed != gen[:len(streamed)].tolist() or (gen < 0).any() or (gen >= V).any():
        return "int4 KV: streamed tokens differ or ids out of range"
    if not np.isfinite(g1.cum_log_probs).all():
        return "int4 KV: non-finite logits"
    log(f"  int4 KV, B=1 3000-token prompt (3072 wide), 64 greedy tokens x2 + streamed: "
        f"identical, {f1} decode forwards, prefill {t_pre * 1e3:.1f} ms, decode "
        f"{(t1 - t_pre) / max(f1, 1) * 1e3:.2f} ms/step, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({CARD})")
    err = check_static_counts(torch, kernels, launched, L, prefills, forwards, quant,
                              packed_kv=True)
    if err:
        return f"int4 KV: {err}"

    # the first prefill breakdown: K5, then the plain prefill attention
    # forced in at the model's call site (K5 is not launched there); the
    # first one in turns with the GEMMs' and GEMVs' default plans (the tile
    # cache off, FTCF_TILE_TUNE=0): off, on, off
    gemm = []
    for label, off in (("attention by K5, default plans", True), ("attention by K5", False),
                       ("attention by K5, default plans again", True)):
        if off:
            with tile_cache_off():
                rows = prefill_profile(torch, eng, prompt, label)[2]
        else:
            rows = prefill_profile(torch, eng, prompt, label)[2]
        gemm.append(named_ms(rows, "qmm_gemm_kernel"))
    base = (gemm[0] + gemm[2]) / 2
    log(f"  the GEMM in the 3000-token prefill ({L} layers): default plans {gemm[0]:.3f} / "
        f"{gemm[2]:.3f} ms, the tile cache's {gemm[1]:.3f} ms ({gemm[1] / base - 1:+.1%}) "
        f"({CARD})")
    orig = gptneox.prefill_attention
    gptneox.prefill_attention = (
        lambda q, k, v, mask, sm, lens=None: prefill_attention_flash_plain(q, k, v, lens, sm))
    try:
        prefill_profile(torch, eng, prompt, "plain prefill attention (fp32 scores)")
    finally:
        gptneox.prefill_attention = orig

    eng = with_kv(engine, "int8k_int4v")
    prompts = [rng.integers(0, V, n).tolist() for n in (2048, 1300)]
    kw = dict(top_k=40, top_p=0.9, temperature=0.8, repetition_penalty=1.1,
              random_seed=[5, 6], return_cum_log_probs=True)
    zero_counts(kernels)
    forwards = prefills = 0
    s1, ts, fs = run(eng, prompts, 32, **kw)
    s2, _, _ = run(eng, prompts, 32, **kw)
    if not np.array_equal(s1.output_ids, s2.output_ids):
        return "int8k_int4v KV: sampling with per-row seeds is not reproducible"
    for b, n in enumerate((2048, 1300)):
        gen = s1.output_ids[b, 0, n:s1.sequence_lengths[b, 0]]
        if (gen < 0).any() or (gen >= V).any() or not np.isfinite(s1.cum_log_probs).all():
            return f"int8k_int4v KV: bad output in row {b}"
    log(f"  int8k_int4v KV, B=2 prompts of 2048 and 1300 tokens, 32 sampled tokens x2: "
        f"reproducible, {fs} decode forwards, {ts:.2f} s a run ({CARD})")
    return check_static_counts(torch, kernels, launched, L, prefills, forwards, quant,
                               packed_kv=True)


def phase_beam(torch, engine, kernels, launched):
    """Beam search on the int8 CodeFuse-13B ``engine`` (int8 KV): prompts of
    1000 and 600 tokens, beam_width 4, 64 tokens, len_penalty 0.6 on the
    first; twice (identical) and once streamed (identical, 4 beams a prompt
    in every message); beams sorted best-first; every hypothesis rescored
    teacher-forced on the card through a B = 1 prefill against its per-step
    log-probs; the same beams on a bf16 cache and greedy decoding (K4)
    rescored alike, to tell the int8 KV codes' share of the gap from K11's.
    Returns an error message, or None."""
    cfg = engine.config
    L, V = cfg.layer_num, cfg.vocab_size
    quant = dict(weight_bits=8, group_size=0)
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, V, n).tolist() for n in (1000, 600)]
    bw, out_len, lp = 4, 64, np.array([0.6, 0.0], np.float32)
    kw = dict(beam_width=bw, len_penalty=lp.tolist(), output_log_probs=True)
    log("phase 4: CodeFuse-13B int8, beam search (K11): prompts of 1000 and 600 tokens, "
        "beam_width 4, 64 tokens")
    zero_counts(kernels)
    torch.cuda.reset_peak_memory_stats()
    forwards = prefills = 0

    def run(*a, **k):
        nonlocal forwards, prefills
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = engine.generate(*a, **k)
        torch.cuda.synchronize()
        forwards += engine.decode_forwards
        prefills += 1
        return out, time.perf_counter() - t, engine.decode_forwards

    _, t_pre, _ = run(prompts, 1, **kw)
    b1, t1, f1 = run(prompts, out_len, **kw)
    b2, _, _ = run(prompts, out_len, **kw)
    msgs = []
    b3, _, _ = run(prompts, out_len, callback=msgs.append, **kw)
    if not all(np.array_equal(x, y) for x, y in zip(b1, b2)):
        return "beam search: two runs differ"
    if not (np.array_equal(b1.output_ids, b3.output_ids)
            and np.array_equal(b1.sequence_lengths, b3.sequence_lengths)):
        return "beam search: the streamed run differs"
    if not msgs or any(len(m["last_tokens"]) != 2 or any(len(t) != bw for t in m["last_tokens"])
                       for m in msgs):
        return "beam search: a streamed message does not carry 4 beams per prompt"
    for b, p in enumerate(prompts):
        gen = b1.output_ids[b, :, len(p):]
        if b1.output_ids[b, :, :len(p)].tolist() != [p] * bw or (gen < 0).any() or (gen >= V).any():
            return f"beam search: bad ids for prompt {b}"
        score = b1.cum_log_probs[b] / ((5.0 + b1.sequence_lengths[b] - len(p)) / 6.0) ** lp[b]
        if not np.isfinite(score).all() or (np.diff(score) > 1e-6 * np.abs(score).max()).any():
            return f"beam search: beams of prompt {b} are not best-first: {score}"
    step_ms = (t1 - t_pre) / max(f1, 1) * 1e3
    log(f"  B=2 x 4 beams, 64 tokens x2 + streamed ({len(msgs)} messages of 2 x 4 tokens): "
        f"identical, best-first; {f1} decode forwards, prefill of 8 rows {t_pre * 1e3:.1f} ms, "
        f"decode {step_ms:.2f} ms/step ({CARD})")

    # teacher-forced rescoring of every hypothesis: one B = 1 prefill each
    d, n = rescore(torch, engine, b1, prompts)
    prefills += n
    log(f"  teacher-forced rescoring of the 8 hypotheses ({d.size} tokens, B = 1 prefill): "
        f"|dlogprob| mean {d.mean():.2e}, max {d.max():.2e} nats per token (limit 0.05 mean); "
        f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({CARD})")
    if not np.isfinite(d).all() or d.mean() > 0.05:
        return "beam search: the hypotheses' log-probs disagree with their rescoring"
    # the same beams on a bf16 cache: what the int8 KV codes add to the gap
    eng16 = with_kv(engine, "bf16")
    b16 = eng16.generate(prompts, out_len, **kw)
    d16, n = rescore(torch, eng16, b16, prompts)
    forwards += eng16.decode_forwards
    prefills += 1 + n
    log(f"  the same on a bf16 KV cache: |dlogprob| mean {d16.mean():.2e}, max {d16.max():.2e} "
        f"nats per token")
    err = check_static_counts(torch, kernels, launched, L, prefills, forwards, quant, beam=True)
    if err:
        return err
    # and greedy decoding (K4) on the int8 cache, prompt 0 alone, rescored alike
    zero_counts(kernels)
    g = engine.generate(prompts[:1], out_len, top_k=1, output_log_probs=True)
    dg, n = rescore(torch, engine, g, prompts[:1])
    log(f"  greedy on the int8 cache (K4), prompt 0, rescored alike: |dlogprob| mean "
        f"{dg.mean():.2e}, max {dg.max():.2e} nats per token")
    return check_static_counts(torch, kernels, launched, L, 1 + n, engine.decode_forwards, quant)


def rescore(torch, engine, out, prompts):
    """(|log-prob under a teacher-forced B = 1 prefill - the run's per-step
    log-prob| for every generated token of every returned sequence of
    ``out``, a GenerationOutput with ``output_log_probs``; the number of
    prefills run)."""
    from fastertransformer4codefuse_tpu_torch.engine import kv_cache
    from fastertransformer4codefuse_tpu_torch.models import gptneox as model

    cfg, deltas = engine.config, []
    for b, p in enumerate(prompts):
        for j in range(out.output_ids.shape[1]):
            n = int(out.sequence_lengths[b, j])
            seq = torch.tensor(out.output_ids[b, j, :n][None], device="cuda")
            cache = kv_cache.init_cache(cfg, 1, n, torch.int8, "cuda")
            hidden, _ = model.prefill(cfg, engine.params, seq,
                                      torch.tensor([n], dtype=torch.int32, device="cuda"), cache)
            logp = torch.log_softmax(model.lm_logits(cfg, engine.params,
                                                     hidden[0, len(p) - 1: n - 1]), dim=-1)
            want = logp.gather(1, seq[0, len(p): n, None].long())[:, 0].cpu().numpy()
            deltas.append(np.abs(want - out.output_log_probs[b, j, : n - len(p)]))
    return np.concatenate(deltas), len(deltas)


def forced_check(torch, engine, context, gen):
    """Hold greedy tokens ``gen``, generated after ``context``, to the
    concatenated sequence's greedy run on the engine's KV cache kind,
    teacher-forced: a prefill of ``context`` (K5), then a decode step (K13 +
    K3, K4) on each token of ``gen`` but the last. A token that is not its
    step's argmax must be a near-tie (its gap to the argmax under NEAR_TIE
    of max |logits|). Returns (error or None, the near-ties as (step,
    gap), each token's log-prob there); runs one prefill and len(gen) - 1
    decode forwards."""
    from fastertransformer4codefuse_tpu_torch.engine import kv_cache
    from fastertransformer4codefuse_tpu_torch.models import gptneox as model

    cfg, params = engine.config, engine.params
    n = len(context)
    cache = kv_cache.init_cache(cfg, 1, n + len(gen), engine._cache_dtype(), "cuda")
    lens = torch.tensor([n], dtype=torch.int32, device="cuda")
    hidden, _ = model.prefill(cfg, params, torch.tensor([list(context)], device="cuda"), lens,
                              cache)
    steps = [model.lm_logits(cfg, params, model.last_token_hidden(hidden, lens))]
    toks = torch.tensor(list(gen), dtype=torch.int32, device="cuda")
    for i in range(len(gen) - 1):
        h, _ = model.decode_step(cfg, params, toks[i: i + 1], lens + i, cache)
        steps.append(model.lm_logits(cfg, params, h))
    lg = torch.cat(steps).float()
    best = lg.argmax(-1, keepdim=True)
    gap = ((lg.gather(1, best) - lg.gather(1, toks[:, None].long()))[:, 0]
           / lg.abs().amax(-1)).cpu().numpy()
    off = [(int(i), round(float(gap[i]), 5)) for i in np.nonzero(gap > 0)[0]]
    far = [(i, x) for i, x in off if x >= NEAR_TIE]
    logp = torch.log_softmax(lg, -1).gather(1, toks[:, None].long())[:, 0].cpu().numpy()
    if far:
        return f"greedy step {far[0][0]} is no argmax of the concatenated run's teacher-forced " \
               f"logits (gap {far[0][1]:.2e})", off, logp
    return None, off, logp


def prompted_launches(L, chunk_prefills, forwards, beam=False):
    """Launches of the int8 CodeFuse model's prompted runs: each prompted
    prefill is the chunk program (K13 and the proj and down GEMMs, K1;
    plain dense chunk attention over the prompt's cache slots), each decode
    forward K13 + K3 and K4 (K11 for beams)."""
    return {"fused_qkv_up": L * (chunk_prefills + forwards), "quant_matmul": 2 * L * chunk_prefills,
            "fused_proj_down": L * forwards,
            "flash_decode_beam" if beam else "flash_decode": L * forwards}


def check_run_counts(torch, kernels, launched, expect, label):
    """Compare the counters (zeroed just before ``label`` ran) with
    ``expect``; add them to ``launched``. Returns an error or None."""
    torch.cuda.synchronize()
    counts = read_counts(kernels)
    want = {n: 0 for n in counts}
    want.update(expect)
    log(f"  {label}: launches {({n: c for n, c in counts.items() if c})}, expected "
        f"{({n: c for n, c in want.items() if c})}")
    if counts != want:
        return f"{label}: kernel launch counts do not match the run"
    for n in kernels:
        launched[n] += counts[n]
    return None


# Phase 4's prompt learning: the tasks' prefix lengths, the inputs after them
PROMPT_PREFIX = (128, 96)
PROMPT_TAILS = (300, 200, 150)
PROMPT_OUT = 32


def phase_prompt(torch, engine, kernels, launched):
    """Prompt learning and the DEBUG sweep on the int8 CodeFuse-13B
    ``engine`` (SERVE_LAYERS deep, int8 KV): prefix tables made of the model's own
    K/V of a 128- and a 96-token prefix; a prefix-prompted greedy run and a
    soft prompt of 64 x 5120 embeddings (real tokens' embedding rows), each
    held to the model's greedy on the concatenated sequence, teacher-forced;
    prefix-prompted beams (2 prompts x 4 beams, x2, every hypothesis
    rescored teacher-forced); a dense pool on a bf16 cache with the two-task
    table serving prompted and plain requests mid-flight, each against its
    solo static run; then the DEBUG sweep on clean weights and with a NaN planted in one
    layer's scales. Returns an error message, or None."""
    import dataclasses

    from fastertransformer4codefuse_tpu_torch.engine import kv_cache
    from fastertransformer4codefuse_tpu_torch.engine.server import BatchingServer
    from fastertransformer4codefuse_tpu_torch.models import gptneox as model
    from fastertransformer4codefuse_tpu_torch.utils.debug import (
        DebugCheckError, checked_forward, debug_verify, scan_params,
    )

    cfg, params = engine.config, engine.params
    L, V = cfg.layer_num, cfg.vocab_size
    quant = dict(weight_bits=8, group_size=0)
    rng = np.random.default_rng(17)
    log("phase 4: CodeFuse-13B int8, prompt learning (prefix and soft prompts, beams, a dense "
        "pool) and the DEBUG sweep")
    zero_counts(kernels)
    prefixes, table = {}, {}
    for task, n in zip((1, 2), PROMPT_PREFIX):
        ids = rng.integers(0, V, n).tolist()
        cache = kv_cache.init_cache(cfg, 1, n, torch.bfloat16, "cuda")
        model.prefill(cfg, params, torch.tensor([ids], device="cuda"),
                      torch.tensor([n], dtype=torch.int32, device="cuda"), cache)
        table[task] = (torch.stack([cache["k"][:, 0], cache["v"][:, 0]], 1).float(), n)
        prefixes[task] = ids
    engine.set_prompt_learning_table(table)
    err = check_static_counts(torch, kernels, launched, L, 2, 0, quant)
    if err:
        return f"prefix tables: {err}"
    log(f"  prefix tables [L, 2, 40, P, 128] fp32 of {PROMPT_PREFIX} tokens from the model's own "
        "prefill (bf16 cache)")

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = engine.generate(*a, **kw)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    def gen_of(out, b, n_in, j=0):
        return out.output_ids[b, j, n_in:out.sequence_lengths[b, j]].tolist()

    tails = [rng.integers(0, V, n).tolist() for n in PROMPT_TAILS]
    zero_counts(kernels)
    forced = 0
    out, t_pre = timed([tails[0]], PROMPT_OUT, top_k=1, prompt_learning_task_name_ids=[1])
    again, _ = timed([tails[0]], PROMPT_OUT, top_k=1, prompt_learning_task_name_ids=[1])
    if not np.array_equal(out.output_ids, again.output_ids):
        return "prefix prompt: two greedy runs differ"
    gen = gen_of(out, 0, len(tails[0]))
    fw = 2 * engine.decode_forwards
    err, ties, _ = forced_check(torch, engine, prefixes[1] + tails[0], gen)
    forced, forced_fw = 1, len(gen) - 1
    if err:
        return f"prefix prompt: {err}"
    log(f"  prefix prompt (task of {PROMPT_PREFIX[0]} tokens) + {PROMPT_TAILS[0]}-token input, "
        f"{len(gen)} greedy tokens x2: identical, {t_pre:.2f} s a run; every token the "
        f"concatenated sequence's greedy, teacher-forced ({len(ties)} near-ties: {ties[:3]})")

    soft_ids = rng.integers(0, V, 64).tolist()
    e = params["embed"]
    sid = torch.tensor(soft_ids, device="cuda")
    soft = (e.q[sid].float() * e.scale[sid].float()[:, None])[None]  # [1, 64, 5120]
    out, t_soft = timed([tails[1]], PROMPT_OUT, top_k=1, request_prompt_embedding=soft.cpu(),
                        request_prompt_lengths=[64])
    fw += engine.decode_forwards
    gen = gen_of(out, 0, len(tails[1]))
    err, ties, _ = forced_check(torch, engine, soft_ids + tails[1], gen)
    forced, forced_fw = forced + 1, forced_fw + len(gen) - 1
    if err:
        return f"soft prompt: {err}"
    log(f"  soft prompt of 64 x {cfg.hidden_size} embeddings (64 tokens' rows) + "
        f"{PROMPT_TAILS[1]}-token input, {len(gen)} greedy tokens in {t_soft:.2f} s: the "
        f"concatenated sequence's greedy, teacher-forced ({len(ties)} near-ties)")
    expect = add_counts(prompted_launches(L, 4, fw),
                        expected_launches(L, forced, forced_fw, **quant))
    err = check_run_counts(torch, kernels, launched, expect,
                           "prefix x2 and soft prompts (chunk program; soft: 2 chunks)")
    if err:
        return err

    zero_counts(kernels)
    bw = 4
    kw = dict(beam_width=bw, output_log_probs=True, prompt_learning_task_name_ids=[1, 2])
    b1, t_b = timed(tails[1:3], PROMPT_OUT, **kw)
    fw = engine.decode_forwards
    b2, _ = timed(tails[1:3], PROMPT_OUT, **kw)
    fw += engine.decode_forwards
    if not all(np.array_equal(x, y) for x, y in zip(b1, b2)):
        return "prefix-prompted beams: two runs differ"
    deltas, n_resc = [], 0
    for b, (task, tail) in enumerate(zip((1, 2), tails[1:3])):
        ctx = prefixes[task] + tail
        score = b1.cum_log_probs[b]
        if not np.isfinite(score).all() or (np.diff(score) > 1e-6 * np.abs(score).max()).any():
            return f"prefix-prompted beams of prompt {b} are not best-first: {score}"
        for j in range(bw):
            hyp = gen_of(b1, b, len(tail), j)
            ids = ctx + hyp
            n = len(ids)
            cache = kv_cache.init_cache(cfg, 1, n, torch.int8, "cuda")
            hidden, _ = model.prefill(cfg, params, torch.tensor([ids], device="cuda"),
                                      torch.tensor([n], dtype=torch.int32, device="cuda"), cache)
            logp = torch.log_softmax(model.lm_logits(cfg, params, hidden[0, len(ctx) - 1: n - 1]),
                                     dim=-1)
            want = logp.gather(1, torch.tensor(hyp, device="cuda")[:, None])[:, 0].cpu().numpy()
            deltas.append(np.abs(want - b1.output_log_probs[b, j, :len(hyp)]))
            n_resc += 1
    d = np.concatenate(deltas)
    log(f"  prefix-prompted beams, 2 prompts x {bw} beams (tasks 1, 2), {PROMPT_OUT} tokens x2: "
        f"identical, best-first, {t_b:.2f} s a run; every hypothesis rescored teacher-forced "
        f"over prefix + input: |dlogprob| mean {d.mean():.2e}, max {d.max():.2e} nats (limit "
        f"0.05 mean) ({CARD})")
    if not np.isfinite(d).all() or d.mean() > 0.05:
        return "prefix-prompted beams: the hypotheses' log-probs disagree with their rescoring"
    expect = add_counts(prompted_launches(L, 2, fw, beam=True),
                        expected_launches(L, n_resc, 0, **quant))
    err = check_run_counts(torch, kernels, launched, expect, "prefix-prompted beams (K11)")
    if err:
        return err

    # a dense pool with the two-task table: prompted and plain requests, two
    # of them arriving mid-flight, each against its solo static run. A
    # pool's program (128-row chunks, the last prompt token by a decode
    # tick) is not the static one (one prefill), so a request that parts
    # from its static run is rescored: its per-step log-probs against the
    # concatenated sequence's, teacher-forced, within 0.05 nats a token on
    # average (the beam limit). Greedy flips above NEAR_TIE occur (1.2-1.3e-2
    # of max |logits| on CodeFuse-13B's random weights, on an int8 and on a
    # bf16 cache): the programs' roundings, not a prompt fault, which would
    # move whole distributions. On a bf16 cache.
    peng = with_kv(engine, "bf16")
    peng.set_prompt_learning_table(table)
    zero_counts(kernels)
    lens = (300, 500, 200, 700, 150, 400)
    tasks = (1, None, 2, 1, None, 2)
    reqs = [(rng.integers(0, V, n).tolist(), PROMPT_OUT, dict(top_k=1, prompt_task_id=t))
            for n, t in zip(lens, tasks)]
    srv = BatchingServer(peng, max_slots=4, max_seq_len=2048, prompt_bucket=128,
                         pipeline_ticks=True, prompt_table=table, return_log_probs=True)
    b = srv.batcher
    try:
        res, wall = drive_mix(srv, reqs, late=2)
    finally:
        srv.close()
    err = bad_length(res, reqs, cfg.end_id, V)
    if err:
        return f"prompt-learning pool: {err}"
    err = check_counts(kernels, launched, [b], L, "prompt-learning dense pool (4 slots, 2 tasks)")
    if err:
        return err
    zero_counts(kernels)
    same, fw, ties_all, forced_fw, deltas = 0, 0, [], 0, []
    for (p, o, kw_), r in zip(reqs, res):
        t = kw_["prompt_task_id"]
        ptk = {} if t is None else dict(prompt_learning_task_name_ids=[t])
        solo = peng.generate([p], o, top_k=1, **ptk)
        fw += peng.decode_forwards
        pooled = r.output_ids[len(p):]
        if pooled == gen_of(solo, 0, len(p)):
            same += 1
            continue
        _, ties, logp = forced_check(torch, peng, (prefixes[t] if t else []) + p, pooled)
        forced_fw += len(pooled) - 1
        d = np.abs(logp - np.asarray(r.step_log_probs))
        if not np.isfinite(d).all() or d.mean() > 0.05:
            return f"prompt-learning pool, task {t}: its log-probs part from the concatenated " \
                   f"run's, teacher-forced, by {d.mean():.2e} nats a token"
        ties_all += ties
        deltas.append(d)
    n_forced = len(reqs) - same
    n_prompted = sum(t is not None for t in tasks)
    expect = add_counts(prompted_launches(L, n_prompted, 0),
                        expected_launches(L, len(reqs) - n_prompted + n_forced, forced_fw,
                                          **quant),
                        {"fused_qkv_up": L * fw, "fused_proj_down": L * fw,
                         "flash_decode": L * fw})
    err = check_run_counts(torch, kernels, launched, expect, "the pool's requests alone")
    if err:
        return err
    d = np.concatenate(deltas) if deltas else np.zeros(1)
    log(f"  prompt-learning pool, bf16 KV: 6 requests (tasks {tasks}), 2 mid-flight, {wall:.2f} "
        f"s; {same} of 6 token for token their solo static run; the others rescored "
        f"teacher-forced over the concatenated sequence: |dlogprob| mean {d.mean():.2e}, max "
        f"{d.max():.2e} nats (limit 0.05 mean), greedy flips at {ties_all} ({CARD})")

    # the DEBUG sweep: clean weights pass; a NaN planted in one layer's
    # scales is named by the sweep and, layer for layer, by checked_forward
    dbg = type(engine)(cfg, params, dataclasses.replace(engine.runtime, debug_level="DEBUG"))
    prompt = rng.integers(0, V, 1000).tolist()
    zero_counts(kernels)
    out = dbg.generate([prompt], 8, top_k=1)
    fw = dbg.decode_forwards
    ids, lens_ = np.array([prompt], np.int32), np.array([1000], np.int32)
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        debug_verify(dbg, ids, lens_)
        walls.append((time.perf_counter() - t0) * 1e3)
    err = check_run_counts(torch, kernels, launched,
                           expected_launches(L, 4, fw + 3, **quant),
                           "DEBUG generate (the sweep, then the run) and two sweeps")
    if err:
        return err
    layer, col = L - 3, 5
    s = params["layers"]["up_w"].scale
    old = s[layer, col].clone()
    s[layer, col] = float("nan")
    try:
        zero_counts(kernels)
        try:
            dbg.generate([prompt], 8, top_k=1)
            return f"DEBUG: a NaN in layer {layer}'s up_w scales passed the sweep"
        except DebugCheckError as e:
            swept = str(e)
        try:
            checked_forward(cfg, params, ids, lens_, torch.int8)
            return f"DEBUG: checked_forward passed a NaN in layer {layer}'s up_w scales"
        except DebugCheckError as e:
            staged = str(e)
    finally:
        s[layer, col] = old
    if "layers.up_w.scale (1 bad)" not in swept or staged != \
            f"non-finite activation after layer {layer} (prefill)":
        return f"DEBUG: the planted NaN was named {swept!r} / {staged!r}"
    err = check_run_counts(torch, kernels, launched, expected_launches(L, 1, 0, **quant),
                           "DEBUG with the NaN: the sweep (no launch), then the checked prefill")
    if err:
        return err
    if scan_params(params):
        return "DEBUG: the planted NaN was not restored"
    log(f"  DEBUG sweep (weights swept, then a checked prefill of 1000 tokens + a decode step, "
        f"one sync each): {min(walls):.1f} ms (best of 2) ({CARD}); clean weights pass, "
        f"{out.sequence_lengths[0, 0] - 1000} tokens after it; a NaN in layer {layer}'s up_w "
        f"scales: {swept!r}, then {staged!r}; restored")
    return None


def phase_f32_scales(torch, pkg, kernels, launched, tol_ref):
    """The int4 g128 model of CodeFuse-13B width (``REF_LAYERS``) with fp32
    group scales (``FTCF_GSCALE_BF16=0``): card vs CPU logits on both routes
    (K13 + K3, and the unfused K7), each with exact counts of the fp32
    instances. Returns an error or None."""
    os.environ["FTCF_GSCALE_BF16"] = "0"
    try:
        ref = reference_model(torch, pkg, layers=REF_LAYERS["int4 g128"], weight_bits=4,
                              group_size=128)
    finally:
        os.environ.pop("FTCF_GSCALE_BF16")
    if ref[2]["layers"]["up_w"].scale.dtype != torch.float32:
        return "fp32 group scales: the quantizer kept bf16"
    for fused in (True, False):
        zero_counts(kernels)
        rels = phase_reference(torch, ref, fused=fused)
        expect = expected_launches(ref[0].layer_num, 1, 3, 4, 128, fused=fused)
        for base in ("quant_matmul_w4_group", "fused_qkv_up", "fused_proj_down"):
            if base in expect:
                expect[base + "_f32"] = expect[base]
        err = check_run_counts(torch, kernels, launched, expect,
                               f"int4 g128 fp32 scales, {'K13 + K3' if fused else 'unfused K7'}")
        if err:
            return err
        log(f"  int4 g128 with fp32 group scales (FTCF_GSCALE_BF16=0; "
            f"{'K13 + K3' if fused else 'fused_decode=False: K7'}): "
            f"{', '.join(f'{r:.2e}' for r in rels)} (tol {tol_ref:g})")
        if max(rels) >= tol_ref:
            return "fp32 group scales: card and CPU logits disagree"
    return None


def phase_w8a8(torch, pkg, kernels, launched):
    """SmoothQuant W8A8 (phase 4b). At 2 layers of CodeFuse-13B width:
    calibration stats on the card and the CPU, the AWQ fold (fp-exact) and
    its int4 g128 error against round-to-nearest, the SmoothQuant fold, and
    an ``act_int8`` model's logits on the card against the CPU. At 40
    layers: the float model built on the card for the stats only, folded,
    quantized and freed; the 1000- and 3000-token prefills with act_int8
    beside weight-only (turns a8, wo, wo, a8); ``torch._int_mm`` against the
    port's GEMM at M = 3072; decode steps launch K13 + K3 and no
    ``_int_mm``; peak memory. Returns an error or None."""
    import dataclasses
    import gc

    from fastertransformer4codefuse_tpu_torch.ckpt.calibrate import (
        apply_awq_scaling, collect_activation_stats,
    )
    from fastertransformer4codefuse_tpu_torch.ckpt.quantize import quantize_params
    from fastertransformer4codefuse_tpu_torch.ckpt.smoothquant import apply_smoothquant_scaling
    from fastertransformer4codefuse_tpu_torch.engine import kv_cache
    from fastertransformer4codefuse_tpu_torch.models import gptneox as model
    from fastertransformer4codefuse_tpu_torch.models.params import params_to
    from fastertransformer4codefuse_tpu_torch.ops import linear
    from fastertransformer4codefuse_tpu_torch.ops.quant_matmul import quant_matmul
    from fastertransformer4codefuse_tpu_torch.utils.profiling import summarize_trace, trace

    log("phase 4b: SmoothQuant W8A8 and AWQ on CodeFuse-13B width")
    tol = 5e-2
    cfg2 = pkg.GptNeoXConfig(**{**pkg.GptNeoXConfig.codefuse_13b().__dict__, "layer_num": 2})
    rng = np.random.default_rng(23)
    V = cfg2.vocab_size
    calib = [[rng.integers(0, V, 256).tolist() for _ in range(2)]]
    p = pkg.init_params(cfg2, seed=9, dtype="bf16", device="cuda")
    p_cpu = params_to(p, "cpu")
    t0 = time.time()
    st = collect_activation_stats(cfg2, p, calib)
    st_cpu = collect_activation_stats(cfg2, p_cpu, calib)
    gaps = {k: float(np.abs(st[k] - st_cpu[k]).max() / np.abs(st_cpu[k]).max()) for k in st}
    log(f"  calibration stats (2 x 256 tokens, unfused route), card vs CPU, max |d| / max: "
        f"{', '.join(f'{k} {v:.2e}' for k, v in gaps.items())} (tol {tol:g}); {time.time() - t0:.1f} s")
    if max(gaps.values()) >= tol or set(st) != {"qkv", "proj", "up", "down"}:
        return "W8A8: calibration stats disagree between card and CPU"

    ids = torch.from_numpy(rng.integers(0, V, (2, 64))).to("cuda")
    lens = torch.full((2,), 64, dtype=torch.int32, device="cuda")

    def logits_of(params, a8=False, steps=0, fused=True):
        cache = kv_cache.init_cache(cfg2, 2, 64 + steps, torch.int8, params["final_ln_w"].device)
        dev = params["final_ln_w"].device
        h, cache = model.prefill(cfg2, params, ids.to(dev), lens.to(dev), cache, fused=fused,
                                 a8=a8)
        out = [model.lm_logits(cfg2, params, h[:, -1]).float().cpu()]
        for s_ in range(steps):
            hd, cache = model.decode_step(cfg2, params, ids[:, s_].to(dev),
                                          (lens + s_).to(dev), cache)
            out.append(model.lm_logits(cfg2, params, hd).float().cpu())
        return out

    t0 = time.time()
    awq = apply_awq_scaling(cfg2, p, st, weight_bits=4, group_size=128)
    t_awq = time.time() - t0
    base = logits_of(p, fused=False)[0]
    fold_gap = rel_err(torch, logits_of(awq, fused=False)[0], base)[1]
    errs = {}
    for label, src in (("round-to-nearest", p), ("AWQ", awq)):
        q4 = quantize_params(src, weight_bits=4, group_size=128)
        errs[label] = rel_err(torch, logits_of(q4)[0], base)[1]
        del q4
    log(f"  AWQ fold (grid of 20 on the card, {t_awq:.1f} s): float logits of the folded model vs "
        f"the unfolded {fold_gap:.2e} (bf16 weights; tol {tol:g}); int4 g128 logits vs float: "
        f"round-to-nearest {errs['round-to-nearest']:.3e}, AWQ {errs['AWQ']:.3e}")
    if fold_gap >= tol:
        return "AWQ: the fold changed the float model"
    del awq

    sq = apply_smoothquant_scaling(cfg2, p, st)
    fold_gap = rel_err(torch, logits_of(sq, fused=False)[0], base)[1]
    q = quantize_params(sq, include_embeddings=True)
    del sq
    zero_counts(kernels)
    linear.w8a8_matmul.launches = 0
    card = logits_of(q, a8=True, steps=3)
    torch.cuda.synchronize()
    n_int_mm = linear.w8a8_matmul.launches
    err = check_run_counts(torch, kernels, launched,
                           {"prefill_attention_flash": 2, "fused_qkv_up": 6,
                            "fused_proj_down": 6, "flash_decode": 6},
                           "act_int8, 2 layers: a W8A8 prefill, 3 decode steps (K13 + K3)")
    if err:
        return err
    if n_int_mm != 8:
        return f"W8A8: {n_int_mm} torch._int_mm calls for a 2-layer prefill (expected 8)"
    cpu = logits_of(params_to(q, "cpu"), a8=True, steps=3)
    wo = logits_of(q, steps=0)[0]
    rels = [rel_err(torch, a, b)[1] for a, b in zip(card, cpu)]
    log(f"  SmoothQuant fold: float logits vs unfolded {fold_gap:.2e}; act_int8 (W8A8 prefill "
        f"of 2 x 64 rows: 8 torch._int_mm calls; 3 decode steps) card vs CPU: "
        f"{', '.join(f'{r:.2e}' for r in rels)} (tol {tol:g}); W8A8 vs weight-only prefill "
        f"logits on the card {rel_err(torch, card[0], wo)[1]:.2e}")
    if max(rels) >= tol or fold_gap >= tol:
        return "W8A8: card and CPU logits disagree, or the fold changed the model"
    del p, p_cpu, q, card, cpu
    gc.collect()
    torch.cuda.empty_cache()

    # 40 layers: the float model on the card for the stats, then freed
    cfg = pkg.GptNeoXConfig.codefuse_13b()
    L = cfg.layer_num
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    pf = pkg.init_params(cfg, seed=0, dtype="bf16", device="cuda")
    torch.cuda.synchronize()
    t_build = time.time() - t0
    calib = [[rng.integers(0, V, 512).tolist() for _ in range(2)]]
    t0 = time.time()
    st = collect_activation_stats(cfg, pf, calib)
    t_stats = time.time() - t0
    t0 = time.time()
    sq = apply_smoothquant_scaling(cfg, pf, st)
    del pf
    q = quantize_params(sq, include_embeddings=True)
    del sq
    gc.collect()
    torch.cuda.synchronize()
    t_fold = time.time() - t0
    torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  40 layers: float bf16 model built in {t_build:.1f} s, stats of 2 x 512 tokens in "
        f"{t_stats:.1f} s, SmoothQuant fold + int8 quantization on the card in {t_fold:.1f} s, "
        f"the float model freed; peak device memory {peak:.2f} GiB ({CARD})")
    if peak >= 80:
        return f"W8A8: peak device memory {peak:.2f} GiB"
    rt = pkg.RuntimeConfig(dtype="bf16", int8_mode=1, kv_cache_dtype="int8")
    a8 = pkg.GptNeoXEngine(cfg, q, dataclasses.replace(rt, act_int8=True))
    wo = pkg.GptNeoXEngine(cfg, q, rt)
    for n in (1000, 3000):
        prompt = rng.integers(0, V, n).tolist()
        walls = {"a8": [], "wo": []}
        for name in ("a8", "wo", "wo", "a8"):
            e = a8 if name == "a8" else wo
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            e.generate([prompt], 1, top_k=1)
            torch.cuda.synchronize()
            walls[name].append((time.perf_counter() - t0) * 1e3)
        dev = {}
        for name, e in (("a8", a8), ("wo", wo)):
            with trace(cpu=False) as prof:
                e.generate([prompt], 1, top_k=1)
            dev[name] = sum(r[1] for r in summarize_trace(prof, top=0))
        log(f"  {n}-token prefill: act_int8 wall {min(walls['a8']):.1f} ms, device "
            f"{dev['a8']:.1f} ms; weight-only wall {min(walls['wo']):.1f} ms, device "
            f"{dev['wo']:.1f} ms (turns a8, wo, wo, a8; best of 2) ({CARD})")
    # torch._int_mm against the port's GEMM at M = 3072, on layer 0's weights
    M = 3072
    x = (torch.randn(M, cfg.hidden_size, device="cuda") * 0.5).to(torch.bfloat16)
    x8, _ = linear.quantize_per_token(x)
    rows = []
    for name in ("qkv_w", "up_w", "proj_w", "down_w"):
        w = q["layers"][name][0]
        K = w.q.shape[0]
        q2, s2 = w.q.reshape(K, -1), w.scale.reshape(-1)
        xk = x if K == cfg.hidden_size else (torch.randn(M, K, device="cuda") * 0.5).to(
            torch.bfloat16)
        xk8 = x8 if K == cfg.hidden_size else linear.quantize_per_token(xk)[0]
        qt = q2.t().contiguous().t()
        rows.append((name, q2.shape[1], K,
                     device_time_ms(torch, lambda: torch._int_mm(xk8, qt)),
                     device_time_ms(torch, lambda: linear.w8a8_matmul(xk, q2, s2)),
                     device_time_ms(torch, lambda: quant_matmul(xk, q2, s2))))
    for name, N, K, t_mm, t_full, t_k1 in rows:
        log(f"  M = {M}, {name} {K}->{N}: torch._int_mm {t_mm:.4f} ms (K-major weight), "
            f"w8a8_matmul {t_full:.4f} ms (per-token quantization and the weight's K-major copy "
            f"included), the port's GEMM (K1) {t_k1:.4f} ms ({CARD})")
    # decode steps: K13 + K3, no _int_mm
    zero_counts(kernels)
    linear.w8a8_matmul.launches = 0
    prompt = rng.integers(0, V, 1000).tolist()
    out = a8.generate([prompt], 16, top_k=1, return_cum_log_probs=True)
    fw = a8.decode_forwards
    n_int_mm = linear.w8a8_matmul.launches
    ref = wo.generate([prompt], 16, top_k=1)
    fw_wo = wo.decode_forwards
    if not np.isfinite(out.cum_log_probs).all():
        return "W8A8: non-finite logits"
    expect = add_counts({"prefill_attention_flash": L, "fused_qkv_up": L * fw,
                         "fused_proj_down": L * fw, "flash_decode": L * fw},
                        expected_launches(L, 1, fw_wo, 8, 0))
    err = check_run_counts(torch, kernels, launched, expect,
                           "act_int8 generate (W8A8 prefill; decode K13 + K3) and weight-only")
    if err:
        return err
    if n_int_mm != 4 * L:
        return f"W8A8: {n_int_mm} torch._int_mm calls for one prefill (expected {4 * L}: " \
               "no decode step may take one)"
    same = int(np.sum(out.output_ids[0, 0, 1000:1016] == ref.output_ids[0, 0, 1000:1016]))
    log(f"  act_int8 generate, 1000-token prompt, 16 greedy tokens: {n_int_mm} torch._int_mm "
        f"calls (the prefill's {4 * L}; none in {fw} decode steps); tokens equal to "
        f"weight-only's at {same} of 16 positions (random weights)")
    return None


def phase_int8_model(torch, engine, kernels, launched):
    return (phase_long(torch, engine, kernels, launched)
            or phase_beam(torch, engine, kernels, launched)
            or phase_prompt(torch, engine, kernels, launched)
            or phase_pool(torch, engine, kernels, launched)
            or phase_spec(torch, engine, kernels, launched))


# Phase 5's speculative decoding: code with repeated lines, as completions
# repeat their context; a row's prompt is its first SPEC_LENS[i] tokens
SPEC_CODE = "".join(
    f"def {name}(self, x):\n    if x is None:\n        return self.{name}_default\n"
    f"    y = self.layer_{i}(x)\n    return y + self.bias_{i}\n\n"
    for i, name in enumerate(("forward", "encode", "decode", "project", "score", "update",
                              "reset", "step", "sample", "merge", "split", "pool") * 4))
SPEC_LENS = (1000, 700, 1300, 400)
SPEC_K, SPEC_NGRAM, SPEC_OUT = 8, 3, 128


def spec_reference(torch, engine, seqs, prompts, rows, S, chunk=0, k=SPEC_K):
    """Hold ``seqs`` (each prompt and its generated tokens) to greedy decoding
    through the same chunked program on the card, teacher-forced: the
    prompts' prefill as the path ran it (one shot, or with ``chunk`` > 0 in
    chunks of that width over [0, n - 1), as a pool admits them), then the
    tokens fed k + 1 at a time through ``prefill_chunk`` on a dense cache of
    ``S`` positions, ``rows`` rows a forward (the path's batch, so each
    product runs at the path's width: the kernels' rows do not depend on
    the other rows, at one width). At every generated position the argmax
    given the tokens before it must be the token there, or the two must be
    a near-tie of these logits (within NEAR_TIE of max |logits|). Returns
    (error or None, the near-ties)."""
    from fastertransformer4codefuse_tpu_torch.engine import kv_cache
    from fastertransformer4codefuse_tpu_torch.models import gptneox as model

    cfg, C, dev = engine.config, k + 1, engine.device
    ns = [len(p) for p in prompts] + [1] * (rows - len(seqs))
    cache = kv_cache.init_cache(cfg, rows, S, engine._cache_dtype(), dev)
    ids = torch.full((rows, S), cfg.end_id, dtype=torch.int32, device=dev)
    for b, seq in enumerate(seqs):
        ids[b, :len(seq)] = torch.tensor(seq, dtype=torch.int32, device=dev)
    real = torch.tensor([b < len(seqs) for b in range(rows)], device=dev)
    pred = {}  # (row, position) -> the logits that predict it

    def run(pos, width, active, keep):
        cols = torch.clamp(torch.tensor(pos, device=dev)[:, None]
                           + torch.arange(width, device=dev)[None, :], max=S - 1)
        h, _ = model.prefill_chunk(cfg, engine.params, ids.gather(1, cols),
                                   torch.tensor(pos, dtype=torch.int32, device=dev), cache,
                                   active)
        if keep:
            lg = model.lm_logits(cfg, engine.params, h)
            for b, seq in enumerate(seqs):
                for i in range(width):
                    if ns[b] <= pos[b] + i + 1 < len(seq):
                        pred[(b, pos[b] + i + 1)] = lg[b, i]

    if chunk:
        for j in range(max(-(-(n - 1) // chunk) for n in ns)):
            run([min(j * chunk, S - chunk)] * rows, chunk,
                real & torch.tensor([j * chunk < n - 1 for n in ns], device=dev), False)
        p = [n - 1 for n in ns]
    else:
        lens = torch.tensor(ns, dtype=torch.int32, device=dev)
        hidden, _ = model.prefill(cfg, engine.params, ids, lens, cache)
        lg = model.lm_logits(cfg, engine.params, model.last_token_hidden(hidden, lens))
        for b in range(len(seqs)):
            pred[(b, ns[b])] = lg[b]
        p = list(ns)
    while any(p[b] + 1 < len(seq) for b, seq in enumerate(seqs)):
        live = [b < len(seqs) and p[b] + 1 < len(seqs[b]) for b in range(rows)]
        run([min(x, S - 1) for x in p], C, torch.tensor(live, device=dev), True)
        p = [x + C if on else x for x, on in zip(p, live)]
    ties = []
    for b, seq in enumerate(seqs):
        for i in range(ns[b], len(seq)):
            lg = pred[(b, i)].float()
            a, want = seq[i], int(lg.argmax())
            if a == want:
                continue
            gap = (lg[want] - lg[a]).item() / lg.abs().max().item()
            if gap >= NEAR_TIE:
                return (f"row {b}, token {i - ns[b]} is {a}, the chunked program's greedy {want} "
                        f"(gap {gap:.2e})"), ties
            ties.append(f"row {b} token {i - ns[b]}: gap {gap:.2e}")
    return None, ties


def spec_expected(L, prefills, verifies, pools=()):
    """Launches of ``prefills`` prefills (K13's GEMM form, K1 proj and down,
    K5) and ``verifies`` verify forwards (k + 1 rows a sequence: K13, K1 proj
    and down; attention over the dense cache in plain PyTorch, no kernel),
    plus the ticks of ``pools``; the int8 head is a plain matmul."""
    out = {"prefill_attention_flash": L * prefills, "fused_qkv_up": L * (prefills + verifies),
           "quant_matmul": 2 * L * (prefills + verifies)}
    return add_counts(out, *(pool_launches(L, b) for b in pools))


def phase_spec(torch, engine, kernels, launched):
    """Phase 5, speculative decoding on the int8 CodeFuse-13B ``engine``
    (int8 KV): ``speculative_generate`` and its batched form, a
    MultiPoolServer with a speculative and a sampling class taking requests
    from threads, and the handler's speculative route; each path's launches
    checked exactly and its tokens held to the chunked program's greedy
    (``spec_reference``). Returns an error message, or None."""
    import gc

    from fastertransformer4codefuse_tpu_torch.api.detok import trim_garbage
    from fastertransformer4codefuse_tpu_torch.api.handler import CodeFuseHandler
    from fastertransformer4codefuse_tpu_torch.engine.server import MultiPoolServer
    from fastertransformer4codefuse_tpu_torch.engine.speculative import (
        _buffer_len, speculative_generate, speculative_generate_batched,
    )

    cfg = engine.config
    L, V, end_id = cfg.layer_num, cfg.vocab_size, cfg.end_id
    tok = ByteTokenizer()
    code = tok.encode(SPEC_CODE)
    prompts = [code[:n] for n in SPEC_LENS]
    log(f"phase 5 (speculative): prompt-lookup speculative decoding of CodeFuse-13B int8, k = "
        f"{SPEC_K}, n-gram {SPEC_NGRAM}, on code prompts with repeated lines ({CARD})")

    def fresh():
        gc.collect()
        torch.cuda.empty_cache()
        zero_counts(kernels)

    def check(label, expect, ref=None):
        torch.cuda.synchronize()
        counts = read_counts(kernels)
        want = {n: 0 for n in counts}
        want.update(expect)
        log(f"  {label}: launches {({n: c for n, c in counts.items() if c})}, expected "
            f"{({n: c for n, c in want.items() if c})}")
        if counts != want:
            return f"{label}: kernel launch counts do not match the forwards run"
        for n in kernels:
            launched[n] += counts[n]
        if ref is not None:
            err, ties = spec_reference(torch, engine, **ref)
            if err:
                return f"{label}: {err}"
            log(f"  {label}: every token the chunked program's greedy, teacher-forced; "
                f"near-ties {ties or 'none'}")
        return None

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    # static greedy decode on the same prompt, the yardstick
    fresh()
    g, t_greedy = timed(lambda: engine.generate([prompts[0]], output_len=SPEC_OUT, top_k=1))
    n_greedy = int(g.sequence_lengths[0, 0]) - SPEC_LENS[0]
    # B = 1: the prompt's prefill alone, then the whole run
    fresh()
    (_, st1), t_pre = timed(lambda: speculative_generate(engine, prompts[0], 1, SPEC_K,
                                                         SPEC_NGRAM))
    (out, st), t_spec = timed(lambda: speculative_generate(engine, prompts[0], SPEC_OUT, SPEC_K,
                                                           SPEC_NGRAM))
    err = check(f"speculative_generate, B = 1 (x2: prefill alone, then {SPEC_OUT} tokens)",
                spec_expected(L, 2, st.iterations - 1),
                dict(seqs=[out], prompts=prompts[:1], rows=1,
                     S=_buffer_len(engine, SPEC_LENS[0], SPEC_OUT, SPEC_K + 1)))
    if err:
        return err
    if out[:SPEC_LENS[0]] != prompts[0] or any(t < 0 or t >= V for t in out[SPEC_LENS[0]:]):
        return "speculative_generate: bad output"
    if not (len(out) - SPEC_LENS[0] == SPEC_OUT or out[-1] == end_id):
        return f"speculative_generate: {len(out) - SPEC_LENS[0]} tokens for {SPEC_OUT}"
    verify_ms = (t_spec - t_pre) / max(st.iterations - 1, 1) * 1e3
    same = sum(a == b for a, b in zip(out[SPEC_LENS[0]:], g.output_ids[0, 0, SPEC_LENS[0]:]))
    log(f"  B = 1, {SPEC_LENS[0]}-token prompt, {st.emitted} tokens: {st.iterations} "
        f"iterations (the prefill one), {st.tokens_per_step:.2f} tokens per step, accepted "
        f"{st.accepted} of {st.drafted} drafted (random weights: the acceptance says little "
        f"about real code); prefill {t_pre * 1e3:.1f} ms, {verify_ms:.1f} ms per verify "
        f"iteration; wall {st.emitted / t_spec:.1f} tokens/s against static greedy decode's "
        f"{n_greedy / t_greedy:.1f} ({t_greedy * 1e3:.0f} ms for {n_greedy} tokens; "
        f"{same} of its tokens equal, another program)")

    # B = 4: ragged prompts in one loop
    fresh()
    _, t_pre4 = timed(lambda: speculative_generate_batched(engine, prompts, 1, SPEC_K,
                                                           SPEC_NGRAM))
    (outs, stats), t_b = timed(lambda: speculative_generate_batched(engine, prompts, SPEC_OUT,
                                                                    SPEC_K, SPEC_NGRAM))
    it4 = stats[0].iterations - 1
    err = check(f"speculative_generate_batched, B = 4 (x2: prefill alone, then {SPEC_OUT} "
                "tokens)",
                spec_expected(L, 2, it4),
                dict(seqs=outs, prompts=prompts, rows=len(prompts),
                     S=_buffer_len(engine, max(SPEC_LENS), SPEC_OUT, SPEC_K + 1)))
    if err:
        return err
    emitted = sum(s.emitted for s in stats)
    log(f"  B = 4, prompts {list(SPEC_LENS)}: {it4 + 1} iterations, tokens per step "
        f"{[round(s.tokens_per_step, 2) for s in stats]}, {emitted} tokens in {t_b * 1e3:.0f} ms "
        f"({emitted / t_b:.1f} tokens/s); prefill {t_pre4 * 1e3:.1f} ms, "
        f"{(t_b - t_pre4) / max(it4, 1) * 1e3:.1f} ms per verify iteration")

    # pooled: a speculative class and a sampling class; 8 requests from threads
    fresh()
    pool = dict(max_slots=4, max_seq_len=2048, prompt_bucket=128, pipeline_ticks=True)
    srv = MultiPoolServer(engine, [dict(pool, max_slots=8, speculative=True, spec_k=SPEC_K,
                                        spec_ngram=SPEC_NGRAM), pool])
    spec_b = next(s.batcher for s in srv.servers if s.batcher.speculative)
    samp_b = next(s.batcher for s in srv.servers if not s.batcher.speculative)
    ticks, commits = [], []
    instrument(torch, spec_b, ticks)
    # the sync check is one mode for the process: the two drivers take turns
    # a step each, so that no step of the sampling class runs while a
    # speculative tick is dispatched under it
    turns = threading.Lock()
    for b in (spec_b, samp_b):
        def in_turn(step=b.step):
            with turns:
                return step()
        b.step = in_turn
    process = spec_b._process_results

    def counted(fetched):  # committed tokens and ready slots of each verify tick
        commits.append((int(fetched[1].sum()), int(fetched[4].sum())))
        return process(fetched)

    spec_b._process_results = counted
    reqs = []
    for i in range(8):
        if i % 2 == 0:
            reqs.append((code[100 * i: 100 * i + SPEC_LENS[i // 2 % 4]], SPEC_OUT,
                         dict(speculative=True)))
        else:
            reqs.append((code[50 * i: 50 * i + 600], 64,
                         dict(top_k=1) if i % 4 == 1 else dict(SAMPLED, random_seed=300 + i)))
    try:
        res, wall = drive_mix(srv, reqs)
    finally:
        srv.close()
    err = bad_length(res, reqs, end_id, V)
    if err:
        return f"pooled speculative: {err}"
    torch.cuda.synchronize()
    counts = read_counts(kernels)
    want = {n: 0 for n in counts}
    want.update(spec_expected(L, 0, 0, (spec_b, samp_b)))
    log(f"  MultiPoolServer (a speculative class of 8 dense slots and a sampling class of 4, "
        f"2048 positions each), "
        f"8 requests from threads (4 speculative, 2 greedy, 2 sampled): {spec_b.decode_ticks} "
        f"verify ticks ({spec_b.chunk_ticks} with a chunk), {samp_b.decode_ticks} sampling "
        f"ticks; launches {({n: c for n, c in counts.items() if c})}, expected "
        f"{({n: c for n, c in want.items() if c})}")
    if counts != want:
        return "pooled speculative: kernel launch counts do not match the ticks run"
    for n in kernels:
        launched[n] += counts[n]
    spec_res = [(p, r.output_ids) for r, (p, _, kw) in zip(res, reqs) if kw.get("speculative")]
    err, ties = spec_reference(torch, engine, [o for _, o in spec_res], [p for p, _ in spec_res],
                               spec_b.rows, spec_b.max_seq_len, spec_b.prompt_bucket)
    if err:
        return f"pooled speculative requests: {err}"
    log(f"  pooled speculative requests: every token the chunked program's greedy (prompts in "
        f"{spec_b.prompt_bucket}-token chunks, {spec_b.rows} rows a forward), teacher-forced; "
        f"near-ties {ties or 'none'}")
    tok_n = sum(c for c, _ in commits)
    slots = sum(r for _, r in commits)
    spec_wall = [w for w, _ in ticks]
    log(f"  pooled: {tok_n} tokens committed over {slots} slot-ticks, {tok_n / max(slots, 1):.2f} "
        f"tokens per verify step; {statistics.median(spec_wall) * 1e3:.1f} ms median wall a "
        f"verify tick ({len(spec_wall)} ticks; dispatch never synchronised, "
        f"set_sync_debug_mode error); the mix in {wall:.2f} s")

    # the handler's speculative route, once through predict
    fresh()
    handler = CodeFuseHandler(engine=engine, tokenizer=tok, warmup=False)
    req = {"prompts": [{"prompt": SPEC_CODE[:SPEC_LENS[0]], "top_k": 1}],
           "out_seq_length": SPEC_OUT, "speculative": True}
    rcode, msg, res = handler.predict(req, "spec")
    if rcode != 0:
        return f"speculative handler request failed: {msg}"
    r = json.loads(res["res"])
    if "speculative" not in r or r["length"][0][0] > SPEC_OUT:
        return f"bad speculative handler response {r}"
    err = check("handler, speculative", spec_expected(L, 1, r["speculative"]["iterations"] - 1))
    if err:
        return err
    gen = [t for t in out[SPEC_LENS[0]:] if t != end_id]  # the output ends at its end id
    if r["generated_code"][0][0] != trim_garbage(tok.decode(gen)):
        return "speculative handler: text differs from speculative_generate's tokens"
    log(f"  handler: {r['speculative']} (the B = 1 run's tokens, same program)")
    return None


# Phase 5's mix: prompt lengths, output lengths; even requests greedy, odd
# ones sampled with their own seeds
POOL_PROMPTS = (1800, 130, 900, 1500, 400, 1100, 700, 250, 1650, 520)
POOL_OUTS = (128, 32, 64, 96, 48, 128, 32, 80, 64, 40)
SAMPLED = dict(top_k=40, top_p=0.9, temperature=0.8, repetition_penalty=1.1)
POOL = dict(max_slots=8, max_seq_len=2048, prompt_bucket=128, pipeline_ticks=True)
PAGES = dict(num_pages=65, page_size=256)  # 8 slots x 2048 positions + the garbage page


def check_static_counts(torch, kernels, launched, L, prefills, forwards, quant, packed_kv=False,
                        beam=False, expect_runs=None):
    """Compare the counters (zeroed just before the run) with what
    ``prefills`` prefills and ``forwards`` decode forwards must give (or,
    ``expect_runs``, the sum of those counts given); add them to
    ``launched``."""
    torch.cuda.synchronize()
    counts = read_counts(kernels)
    expect = {n: 0 for n in counts}
    expect.update(expect_runs if expect_runs is not None else
                  expected_launches(L, prefills, forwards, packed_kv=packed_kv, beam=beam,
                                    **quant))
    log(f"  {prefills} prefills, {forwards} decode forwards; launches "
        f"{({n: c for n, c in counts.items() if c})}, expected "
        f"{({n: c for n, c in expect.items() if c})}")
    if counts != expect:
        return "kernel launch counts do not match the forwards run"
    for n in kernels:
        launched[n] += counts[n]
    return None


def pool_launches(L, b, gemm="quant_matmul"):
    """Launches each kernel wrapper must count for the ticks the CodeFuse
    pool ``b`` ran (int8 weights, or ``gemm``'s format): a decode tick runs
    QKV and up as K13 and the proj + down block as K3, a chunk tick K13 and
    the proj and down GEMMs; attention is K9 / K10 on pages (their packed
    forms on int4 pages), K4 (K11 in a beam pool) and plain chunk attention
    on dense slabs; a dense LM head is a plain matmul."""
    from fastertransformer4codefuse_tpu_torch.engine import paged_kv

    d, c = b.decode_ticks, b.chunk_ticks
    if b.speculative:  # a verify tick is a (k + 1)-wide chunk: K13, then K1 proj and down
        return {gemm: L * 2 * (c + d), "fused_qkv_up": L * (d + c)}
    out = {gemm: L * 2 * c, "fused_qkv_up": L * (d + c), "fused_proj_down": L * d}
    if b.paged is not None:
        out.update(flash_decode_paged=L * d, flash_chunk_paged=L * c)
        if paged_kv.packed4(b._state["cache"], "pv"):
            out.update(flash_decode_paged_int4=L * d, flash_chunk_paged_int4=L * c)
    elif getattr(b, "beam_width", 1) > 1:
        out["flash_decode_beam"] = L * d
    else:
        out["flash_decode"] = L * d
    return out


def check_counts(kernels, launched, pools, L, label, extra=None, gemm="quant_matmul"):
    """Compare the counters (zeroed just before ``label`` was driven) with
    the counts the ticks of ``pools`` (batchers) must give, plus ``extra``
    (static-path launches of the same run); add them to ``launched``."""
    counts = read_counts(kernels)
    expect = {n: 0 for n in counts}
    for n, c in add_counts(extra or {}, *(pool_launches(L, b, gemm) for b in pools)).items():
        expect[n] += c
    ticks = ", ".join(f"{b.decode_ticks} decode ticks ({b.chunk_ticks} with a chunk)"
                      for b in pools)
    log(f"  {label}: {ticks}; launches {({n: c for n, c in counts.items() if c})}, expected "
        f"{({n: c for n, c in expect.items() if c})}")
    if counts != expect:
        return f"{label}: kernel launch counts do not match the ticks run"
    for n in kernels:
        launched[n] += counts[n]
    return None


def zero_counts(kernels):
    for fn, attr, _, _ in kernels.values():
        setattr(fn, attr, 0)
    for fn in ROUTERS:
        fn.plain_routes = 0


def read_counts(kernels):
    """Each kernel's launches, and ``plain_routes``: the attention calls the
    dispatchers sent to a plain version for want of a kernel instance,
    which every CodeFuse-13B, Longformer and BERT path must keep at 0."""
    out = {n: getattr(fn, attr) for n, (fn, attr, _, _) in kernels.items()}
    out["plain_routes"] = sum(fn.plain_routes for fn in ROUTERS)
    return out


def instrument(torch, b, ticks):
    """Dispatch ``b``'s ticks under set_sync_debug_mode("error"), so a
    synchronisation inside a tick's dispatch raises (the driver dies and
    every waiter reports it), and log each step's wall time and whether it
    ran a chunk."""
    dispatch, step = b._dispatch_tick, b.step

    def guarded():
        torch.cuda.set_sync_debug_mode("error")
        try:
            return dispatch()
        finally:
            torch.cuda.set_sync_debug_mode("default")

    def timed():
        c0, t0 = b.chunk_ticks, time.perf_counter()
        out = step()
        ticks.append((time.perf_counter() - t0, b.chunk_ticks > c0))
        return out

    b._dispatch_tick, b.step = guarded, timed


def drive_mix(srv, reqs, late=0, gap=1.0):
    """Submit each request from its own thread: all but the last ``late`` at
    once, those ``gap`` s apart while the others decode. Returns the finished
    requests and the wall time from the first submission to the last
    completion."""
    uids = [None] * len(reqs)
    n0 = len(reqs) - late

    def submit(i, delay):
        time.sleep(delay)
        p, o, kw = reqs[i]
        uids[i] = srv.submit(p, o, **kw)

    threads = [threading.Thread(target=submit, args=(i, 0 if i < n0 else gap * (i - n0 + 1)))
               for i in range(len(reqs))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if None in uids:
        raise RuntimeError("a request was not accepted")
    results = [srv.wait(u, timeout=900) for u in uids]
    return results, time.perf_counter() - t0


def bad_length(results, reqs, end_id, V):
    """None if every request kept its prompt and generated its output_len
    tokens (fewer only when it ended on end_id), all in the vocabulary."""
    for i, (r, (p, o, _)) in enumerate(zip(results, reqs)):
        gen = r.output_ids[len(p):]
        if r.output_ids[:len(p)] != p:
            return f"request {i} lost its prompt"
        if not (len(gen) == o or (1 <= len(gen) < o and gen[-1] == end_id)):
            return f"request {i}: {len(gen)} tokens for output_len {o}"
        if any(t < 0 or t >= V for t in gen):
            return f"request {i}: token ids out of range"
    return None


def tick_profile(torch, engine, ContinuousBatcher, n_chunk=3, n_decode=10):
    """Where a tick's time goes: a paged pool (the phase's layout) driven on
    this thread with 8 requests of 1000-token prompts. The first
    ``n_chunk`` ticks (every slot chunk-prefilling) and, once all 8 decode,
    ``n_decode`` decode ticks run under torch.profiler (kernel activity
    only); the same number of each runs unprofiled for the wall time."""
    from fastertransformer4codefuse_tpu_torch.utils.profiling import summarize_trace, trace

    V = engine.config.vocab_size
    rng = np.random.default_rng(9)
    b = ContinuousBatcher(engine, paged=PAGES, **POOL)
    for _ in range(8):
        b.submit(rng.integers(0, V, 1000).tolist(), 64, top_k=1, min_length=64)

    def timed(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            b.step()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    def profiled(n):
        with trace(cpu=False) as prof:
            for _ in range(n):
                b.step()
        rows = [(name, ms / n, count / n) for name, ms, count, _ in summarize_trace(prof, top=0)]
        return sum(r[1] for r in rows), rows

    out = {}
    c_dev, c_rows = profiled(n_chunk)
    c_wall = timed(n_chunk)
    if b.chunk_ticks != 2 * n_chunk:
        raise RuntimeError("tick profile: the chunk ticks did not run as planned")
    while any(r._chunks_left for r in b.running.values()):
        b.step()
    timed(2)  # every slot decodes from here
    d_wall = timed(n_decode)
    d_dev, d_rows = profiled(n_decode)
    out["chunk"] = (c_wall, c_dev, c_rows)
    out["decode"] = (d_wall, d_dev, d_rows)
    return out


def phase_http(torch, engine, kernels, launched, tok):
    """Length-classed pools (``CodeFuseHandler(pool=[classA, classB])``: a
    paged class of 512 positions and a dense class of 2048) behind the HTTP
    front end on localhost: /healthz, and a short and a long request posted
    at once, each routed to its class."""
    import http.client

    from fastertransformer4codefuse_tpu_torch.api.handler import CodeFuseHandler
    from fastertransformer4codefuse_tpu_torch.api.http_server import make_server
    from fastertransformer4codefuse_tpu_torch.api.trie import VocabTrie

    multi = CodeFuseHandler(
        engine=engine, tokenizer=tok, trie=VocabTrie(tok.get_vocab()), warmup=False,
        pool=[dict(POOL, max_slots=2, max_seq_len=512, paged=dict(num_pages=5, page_size=256)),
              dict(POOL, max_slots=2)])
    srv = make_server(multi, "127.0.0.1", 0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    port = srv.server_address[1]

    def call(method, path, body=None):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        try:
            conn.request(method, path, body=None if body is None else json.dumps(body).encode(),
                         headers={"Content-Type": "application/json"})
            r = conn.getresponse()
            return r.status, json.loads(r.read())
        finally:
            conn.close()

    try:
        if call("GET", "/healthz") != (200, "ok"):
            return "http: /healthz did not answer"
        line = "def quick_sort(arr):\n    "
        reqs = {"short": (line * 4, 32), "long": (line * 40, 64)}  # 100 / 1000 tokens
        got = {}

        def post(name):
            text, n = reqs[name]
            got[name] = call("POST", "/predict", {
                "prompts": [{"prompt": text, "top_k": 1, "min_length": n}], "out_seq_length": n})

        threads = [threading.Thread(target=post, args=(n,)) for n in reqs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        for name, (_, n) in reqs.items():
            status, body = got.get(name, (None, None))
            if status != 200 or body["res"]["length"] != [[n]]:
                return f"http {name} request: {status} {body}"
        pools = [s.batcher for s in multi.server.servers]
        if not all(b.decode_ticks for b in pools):
            return "http: a length class served no request"
        torch.cuda.synchronize()
        err = check_counts(kernels, launched, pools, engine.config.layer_num,
                           "pooled handler, 2 length classes (paged 512, dense 2048), over HTTP")
        if err:
            return err
        log("  HTTP on localhost: /healthz, a 100-token and a 1000-token request posted at once, "
            "each served by its length class")
        return None
    finally:
        srv.shutdown()
        srv.server_close()
        multi.close()


def pool_mix(torch, engine, reqs, kernels, launched, label, alone=False):
    """Phase 5's mix of ``reqs`` on a paged ``BatchingServer`` (PAGES, POOL)
    over ``engine``, run twice from threads; the tokens must repeat, and with
    ``alone`` greedy request 0 run alone must equal itself in the mix.
    Checks the launch counts; returns an error message, or None."""
    from fastertransformer4codefuse_tpu_torch.engine.server import BatchingServer

    cfg = engine.config
    srv = BatchingServer(engine, return_log_probs=True, paged=PAGES, **POOL)
    b = srv.batcher
    pages_gib = sum(nbytes(t) for t in b._state["cache"].values()) / 2**30
    ticks = []
    instrument(torch, b, ticks)
    try:
        runs = []
        for rep in range(2):
            d0, c0, n0 = b.decode_ticks, b.chunk_ticks, len(ticks)
            res, wall = drive_mix(srv, reqs, late=4)
            err = bad_length(res, reqs, cfg.end_id, cfg.vocab_size)
            if err:
                return f"{label} pool mix {rep + 1}: {err}"
            gen = sum(len(r.output_ids) - len(p) for r, (p, _, _) in zip(res, reqs))
            with_c = [t * 1e3 for t, c in ticks[n0:] if c] or [float("nan")]
            no_c = [t * 1e3 for t, c in ticks[n0:] if not c] or [float("nan")]
            log(f"  {label} mix {rep + 1}: 10 requests (prompts {min(POOL_PROMPTS)}-"
                f"{max(POOL_PROMPTS)}, outputs {min(POOL_OUTS)}-{max(POOL_OUTS)}, 5 greedy, 5 "
                f"sampled, 4 arriving 1-4 s in): {gen} tokens in {wall:.2f} s = "
                f"{gen / wall:.1f} tokens/s; {b.decode_ticks - d0} ticks, {b.chunk_ticks - c0} "
                f"with a chunk: {statistics.median(with_c):.1f} ms median per tick with a "
                f"chunk, {statistics.median(no_c):.1f} ms without ({CARD})")
            runs.append([r.output_ids for r in res])
        if runs[0] != runs[1]:
            return f"{label}: the pool mix run twice gave different tokens"
        if alone:
            one = srv.generate(reqs[0][0], reqs[0][1], **reqs[0][2])
            if one.output_ids != runs[0][0]:
                return f"{label}: a greedy request alone differs from itself inside the mix"
        log(f"  {label} mix x2: identical tokens"
            + ("; greedy request 0 alone == inside the mix" if alone else "")
            + "; tick dispatch never synchronised (set_sync_debug_mode error)")
        torch.cuda.synchronize()
        err = check_counts(kernels, launched, [b], cfg.layer_num,
                           f"paged pool on {label}, mix x2" + (" + alone" if alone else ""))
        if err:
            return err
        log(f"  {label}: peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
            f"GiB ({pages_gib:.2f} GiB of pages) ({CARD})")
        return None
    finally:
        srv.close()


def phase_pool(torch, engine, kernels, launched):
    """Phase 5: pooled serving on the int8 CodeFuse-13B ``engine``; returns an
    error message, or None."""
    import gc

    from fastertransformer4codefuse_tpu_torch.api.handler import CodeFuseHandler
    from fastertransformer4codefuse_tpu_torch.api.trie import VocabTrie
    from fastertransformer4codefuse_tpu_torch.engine.batcher import ContinuousBatcher
    from fastertransformer4codefuse_tpu_torch.engine.server import BatchingServer

    cfg = engine.config
    L, V, end_id = cfg.layer_num, cfg.vocab_size, cfg.end_id
    rng = np.random.default_rng(5)
    reqs = [(rng.integers(0, V, n).tolist(), o,
             dict(top_k=1) if i % 2 == 0 else dict(SAMPLED, random_seed=100 + i))
            for i, (n, o) in enumerate(zip(POOL_PROMPTS, POOL_OUTS))]

    def fresh():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        zero_counts(kernels)

    log("phase 5: pooled serving of CodeFuse-13B int8 (8 slots, 2048 positions, paged: "
        "65 pages of 256; int8 KV, then int4 KV)")
    fresh()
    clear_tile_counts()
    err = pool_mix(torch, engine, reqs, kernels, launched, "int8 pages", alone=True)
    if err:
        return err
    fresh()
    err = pool_mix(torch, with_kv(engine, "int4"), reqs, kernels, launched, "int4 pages")
    if err:
        return err

    if not tile_hits("the paged pools' mixes"):
        return "no launch of the pools took its plan from the tile cache"
    # the host and device split of the ticks on int8 and on int4 pages: the
    # int4 pair-byte writes add small ops to every layer of a tick; on int8
    # pages first with the default plans (FTCF_TILE_TUNE=0), then the tile
    # cache's
    profs = {}
    for label, eng in (("int8 pages, default plans", engine), ("int8 pages", engine),
                       ("int4 pages", with_kv(engine, "int4"))):
        fresh()
        if label.endswith("default plans"):
            with tile_cache_off():
                prof = tick_profile(torch, eng, ContinuousBatcher)
        else:
            prof = tick_profile(torch, eng, ContinuousBatcher)
        profs[label] = prof
        if label == "int8 pages":
            sampling_tick_ms = prof["decode"][0]
        for kind, (wall, dev, rows) in prof.items():
            log(f"  {label}, {kind} tick (8 slots at ~1000 positions; profiled): wall "
                f"{wall:.1f} ms, device kernels {dev:.1f} ms, busy {100 * dev / wall:.1f}%, "
                f"{sum(r[2] for r in rows):.0f} device ops (kernels, copies) ({CARD}); per tick:")
            for name, ms, n in rows[:8]:
                log(f"    {ms:8.3f} ms {n:7.1f}x  {name[:90]}")
            log_named(rows, dev, "ms a tick")
    off, on = profs["int8 pages, default plans"], profs["int8 pages"]
    parts = [("chunk", "the GEMM", ("qmm_gemm_kernel",)),
             ("decode", "K13's GEMV", ("gemv_ncat_",)),
             ("decode", "K3's GEMV", ("gemv_partial_kernel", "gemv_epilogue_kernel"))]
    log("  int8 pages, default plans -> the tile cache's, ms a tick: " + "; ".join(
        f"{what} in a {kind} tick {sum(named_ms(off[kind][2], k) for k in keys):.3f} -> "
        f"{sum(named_ms(on[kind][2], k) for k in keys):.3f}" for kind, what, keys in parts)
        + f" ({CARD})")

    fresh()
    tok = ByteTokenizer()
    streamed = []
    handler = CodeFuseHandler(engine=engine, tokenizer=tok, trie=VocabTrie(tok.get_vocab()),
                              warmup=False, on_stream_text=lambda b_, j, s: streamed.append(s),
                              pool=dict(POOL, paged=PAGES))
    try:
        req = {"prompts": [{"prompt": "def quick_sort(arr):\n    " * 20, "top_k": 1,
                            "random_seed": 5}], "out_seq_length": 32}
        responses = []
        for stream in (False, True):
            code, msg, res = handler.predict(dict(req, stream=stream), f"pool-{int(stream)}")
            if code != 0:
                return f"pooled handler request failed: {msg}"
            responses.append(json.loads(res["res"]))
        for key in ("generated_code", "length", "cum_log_prob"):
            if responses[0][key] != responses[1][key]:
                return f"pooled handler: streamed response differs in {key}"
        if "".join(streamed) != responses[0]["generated_code"][0][0]:
            return "pooled handler: streamed text differs from the response"
        torch.cuda.synchronize()
        err = check_counts(kernels, launched, [handler.server.batcher], L,
                           "pooled CodeFuseHandler, streamed and not")
        if err:
            return err
    finally:
        handler.close()
    del handler

    fresh()
    err = phase_http(torch, engine, kernels, launched, tok)
    if err:
        return err

    fresh()
    srv = BatchingServer(engine, paged=dict(PAGES, num_pages=17, lazy=True), **POOL)
    b = srv.batcher
    lazy_reqs = [(rng.integers(0, V, 500).tolist(), 96,
                  dict(top_k=1) if i % 2 == 0 else dict(SAMPLED, random_seed=200 + i))
                 for i in range(8)]
    try:
        res, wall = drive_mix(srv, lazy_reqs)
        err = bad_length(res, lazy_reqs, end_id, V)
        if err:
            return f"lazy pool: {err}"
        if b.preemptions < 1:
            return "the lazy pool never preempted"
        if b.allocator.free_pages != 16:
            return f"the lazy pool leaked pages: {b.allocator.free_pages} of 16 free"
        gen = sum(len(r.output_ids) - 500 for r in res)
        log(f"  lazy pool, 17 pages: 8 requests of 500 + 96 tokens, {b.preemptions} "
            f"preemptions, all finished: {gen} tokens in {wall:.2f} s")
        torch.cuda.synchronize()
        err = check_counts(kernels, launched, [b], L, "lazy paged pool")
        if err:
            return err
    finally:
        srv.close()
    del srv, b

    fresh()
    srv = BatchingServer(engine, **dict(POOL, max_slots=4))
    b = srv.batcher
    dense_reqs = reqs[1:5]
    try:
        res, wall = drive_mix(srv, dense_reqs)
        err = bad_length(res, dense_reqs, end_id, V)
        if err:
            return f"dense pool: {err}"
        gen = sum(len(r.output_ids) - len(p) for r, (p, _, _) in zip(res, dense_reqs))
        log(f"  dense pool, 4 slots x 2048: 4 requests, {gen} tokens in {wall:.2f} s; peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        torch.cuda.synchronize()
        err = check_counts(kernels, launched, [b], L, "dense pool (K4)")
        if err:
            return err
    finally:
        srv.close()
    del srv, b

    fresh()
    err = beam_pool(torch, engine, kernels, launched, sampling_tick_ms)
    if err:
        return err
    fresh()
    return beam_handler(torch, engine, kernels, launched, tok)


# Phase 5's beam requests: prompt lengths, output lengths, length penalties;
# the last two arrive while the first two decode
BEAM_PROMPTS = (900, 130, 600, 350)
BEAM_OUTS = (64, 32, 48, 40)
BEAM_LP = (0.6, 0.0, 1.0, 0.0)


def beam_pool(torch, engine, kernels, launched, sampling_tick_ms):
    """A dense beam pool (``BatchingServer(beam_width=4)``, 2 slots x 4 rows
    x 2048 positions) takes phase 5's 4 beam requests from threads, two of
    them mid-flight; each request's beams must equal its beams alone. Tick
    dispatch runs under set_sync_debug_mode("error"). Returns an error
    message, or None."""
    from fastertransformer4codefuse_tpu_torch.engine.server import BatchingServer

    cfg = engine.config
    L, V, end_id = cfg.layer_num, cfg.vocab_size, cfg.end_id
    rng = np.random.default_rng(17)
    reqs = [(rng.integers(0, V, n).tolist(), o, dict(len_penalty=lp, min_length=o // 2))
            for n, o, lp in zip(BEAM_PROMPTS, BEAM_OUTS, BEAM_LP)]
    srv = BatchingServer(engine, beam_width=4, max_slots=2, max_seq_len=2048, prompt_bucket=128,
                         pipeline_ticks=True)
    b = srv.batcher
    kv_gib = sum(nbytes(t) for t in b._state["cache"].values()) / 2**30
    ticks = []
    instrument(torch, b, ticks)
    try:
        res, wall = drive_mix(srv, reqs, late=2)
        for i, (r, (p, o, _)) in enumerate(zip(res, reqs)):
            if len(r.beam_output_ids) != 4 or r.output_ids != r.beam_output_ids[0]:
                return f"beam pool: request {i} did not return 4 beams"
            for beam in r.beam_output_ids:
                gen = beam[len(p):]
                if beam[:len(p)] != p or not (len(gen) == o or (o // 2 < len(gen) < o
                                                               and gen[-1] == end_id)):
                    return f"beam pool: request {i} has a beam of {len(gen)} tokens for {o}"
                if any(t < 0 or t >= V for t in gen):
                    return f"beam pool: request {i}: token ids out of range"
        gen = sum(len(beam) - len(p) for r, (p, _, _) in zip(res, reqs)
                  for beam in r.beam_output_ids)
        no_c = [t * 1e3 for t, c in ticks if not c] or [float("nan")]
        with_c = [t * 1e3 for t, c in ticks if c] or [float("nan")]
        log(f"  beam pool, 2 slots x 4 beams x 2048 (dense, {kv_gib:.2f} GiB of int8 KV): 4 "
            f"requests "
            f"(prompts {min(BEAM_PROMPTS)}-{max(BEAM_PROMPTS)}, outputs {min(BEAM_OUTS)}-"
            f"{max(BEAM_OUTS)}, 2 arriving 1-2 s in): {gen} beam tokens in {wall:.2f} s; "
            f"{b.decode_ticks} ticks, {b.chunk_ticks} with a chunk: "
            f"{statistics.median(no_c):.1f} ms "
            f"median per decode tick (8 rows; the sampling pool's decode tick at 8 rows "
            f"{sampling_tick_ms:.1f} ms), {statistics.median(with_c):.1f} ms with a chunk ({CARD})")
        for i, (p, o, kw) in enumerate(reqs):
            one = srv.generate(p, o, **kw)
            if one.beam_output_ids != res[i].beam_output_ids:
                return f"beam pool: request {i} alone differs from itself inside the mix"
        log("  beam pool: every request's beams alone == inside the mix; tick dispatch never "
            f"synchronised (set_sync_debug_mode error); peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        torch.cuda.synchronize()
        return check_counts(kernels, launched, [b], L, "dense beam pool (K11), mix + alone")
    finally:
        srv.close()


def beam_handler(torch, engine, kernels, launched, tok):
    """A pooled handler with a sampling class (paged, 512 positions) and a
    width-4 beam class (dense, 2048) routes a beam request to the beam
    class, by that class's tick counter. Returns an error message, or None."""
    from fastertransformer4codefuse_tpu_torch.api.handler import CodeFuseHandler
    from fastertransformer4codefuse_tpu_torch.api.trie import VocabTrie

    h = CodeFuseHandler(
        engine=engine, tokenizer=tok, trie=VocabTrie(tok.get_vocab()), warmup=False,
        pool=[dict(POOL, max_slots=2, max_seq_len=512, paged=dict(num_pages=5, page_size=256)),
              dict(max_slots=1, max_seq_len=2048, prompt_bucket=128, beam_width=4)])
    try:
        samp, beam = (s.batcher for s in h.server.servers)
        req = {"prompts": [{"prompt": "def quick_sort(arr):\n    " * 10, "len_penalty": 0.6}],
               "out_seq_length": 32, "beam_width": 4}
        code, msg, res = h.predict(req, "beam-pooled")
        if code != 0:
            return f"pooled beam request failed: {msg}"
        r = json.loads(res["res"])
        if len(r["generated_code"][0]) != 4 or beam.decode_ticks == 0 or samp.decode_ticks != 0:
            return (f"pooled beam request: {len(r['generated_code'][0])} beams, beam class "
                    f"{beam.decode_ticks} ticks, sampling class {samp.decode_ticks}")
        log(f"  two-class handler (sampling 512 paged, beam width 4 dense): the beam request "
            f"rode the beam class ({beam.decode_ticks} ticks; the sampling class ran none), "
            f"lengths {r['length'][0]}")
        torch.cuda.synchronize()
        return check_counts(kernels, launched, [samp, beam], engine.config.layer_num,
                            "pooled handler, sampling + beam classes")
    finally:
        h.close()


# Phase 7: a CodeFuse-13B-width checkpoint of CLI_LAYERS layers, through the
# CLI (1: writing, quantizing and reading the 13B-width layers took most of
# the phase at 2; the loader's per-layer files and stacking are held by the
# CPU tests at 2 layers)
CLI_LAYERS = 1
# Prompt lengths (bytes) of the 4 greedy requests, and their output length
CLI_PROMPTS = (20, 150, 333, 600)
CLI_OUT = 32
# the --serve pool: 4 slots of 1024 positions on pages of 128 (+ the garbage page)
CLI_POOL = dict(max_slots=4, max_seq_len=1024, prompt_bucket=128)
CLI_PAGES = dict(num_pages=33, page_size=128)
# (label, CLI flags, the weights' quantization, the KV cache kind)
CLI_RUNS = [
    ("int8", ["--int8_mode", "1"], dict(weight_bits=8, group_size=0), None),
    ("int4 g128, int8 KV", ["--int8_mode", "1", "--weight_bits", "4", "--group_size", "128",
                            "--kv_cache_dtype", "int8"], dict(weight_bits=4, group_size=128),
     "int8"),
]


class IdTokenizer(ByteTokenizer):
    """Bytes in; every id spelled out on the way back (``<id>``), so a
    printed response shows each generated token."""

    def decode(self, ids):
        return "".join(f"<{int(i)}>" for i in ids)


def neox_stand_in(torch, cfg, seed, dev="cuda"):
    """What ``convert_hf_to_bin`` reads of an HF GPTNeoXForCausalLM: a
    ``.config`` with HF's field names and a ``.state_dict()`` of random fp16
    weights at ``cfg``'s widths, made on ``dev`` from ``seed`` and held on
    the CPU. The attention output bias is zero, so the checkpoint's summed
    bias (written in fp16) is the down bias exactly."""
    import types

    gen = torch.Generator(device=dev).manual_seed(seed)
    H, F, V = cfg.hidden_size, cfg.inter_size, cfg.vocab_size

    def rnd(*shape, std=0.02, mean=0.0):
        t = torch.empty(shape, device=dev).normal_(mean, std, generator=gen)
        return t.half().cpu()

    sd = {"gpt_neox.embed_in.weight": rnd(V, H), "embed_out.weight": rnd(V, H),
          "gpt_neox.final_layer_norm.weight": rnd(H, std=0.1, mean=1.0),
          "gpt_neox.final_layer_norm.bias": rnd(H)}
    for i in range(cfg.layer_num):
        p = f"gpt_neox.layers.{i}."
        for ln in ("input_layernorm", "post_attention_layernorm"):
            sd[p + ln + ".weight"], sd[p + ln + ".bias"] = rnd(H, std=0.1, mean=1.0), rnd(H)
        sd[p + "attention.query_key_value.weight"] = rnd(3 * H, H)
        sd[p + "attention.query_key_value.bias"] = rnd(3 * H)
        sd[p + "attention.dense.weight"] = rnd(H, H)
        sd[p + "attention.dense.bias"] = torch.zeros(H, dtype=torch.float16)
        sd[p + "mlp.dense_h_to_4h.weight"], sd[p + "mlp.dense_h_to_4h.bias"] = rnd(F, H), rnd(F)
        sd[p + "mlp.dense_4h_to_h.weight"], sd[p + "mlp.dense_4h_to_h.bias"] = rnd(H, F), rnd(H)
    hf_cfg = types.SimpleNamespace(
        num_attention_heads=cfg.head_num, hidden_size=H, intermediate_size=F,
        num_hidden_layers=cfg.layer_num, rotary_pct=cfg.rotary_embedding_dim / cfg.size_per_head,
        vocab_size=V, bos_token_id=cfg.start_id, eos_token_id=cfg.end_id,
        use_parallel_residual=cfg.use_gptj_residual, layer_norm_eps=cfg.layernorm_eps,
        rotary_emb_base=cfg.rotary_base, hidden_act="gelu")
    return types.SimpleNamespace(config=hf_cfg, state_dict=lambda: sd)


def cli_reference(torch, cfg, sd, quant, dev="cuda"):
    """The parameters the loader must give for ``sd`` written as fp16 and
    ``quant``'s payloads: float leaves in bf16; the four big kernels
    quantized from their fp16 values (``quantize_array``, as
    ``quant_and_save`` does), each scale rounded through fp16 (the disk's
    dtype) back to its own dtype."""
    import dataclasses

    from fastertransformer4codefuse_tpu_torch.ckpt.convert import params_from_hf_state_dict
    from fastertransformer4codefuse_tpu_torch.ckpt.quantize import quantize_array

    ref = params_from_hf_state_dict(cfg, sd, dtype="bf16", device=dev)
    layers = dict(ref["layers"])
    for key, name in (("qkv_w", "attention.query_key_value.weight"),
                      ("proj_w", "attention.dense.weight"),
                      ("up_w", "mlp.dense_h_to_4h.weight"),
                      ("down_w", "mlp.dense_4h_to_h.weight")):
        # HF's [out, in] -> the engine's [in, out] (QKV in HF's column order)
        w = torch.stack([sd[f"gpt_neox.layers.{i}.{name}"].to(dev).float().t()
                         for i in range(cfg.layer_num)])
        qt = quantize_array(w, k_axis=-2, bits=quant["weight_bits"],
                            group_size=quant["group_size"])
        layers[key] = dataclasses.replace(
            qt, scale=qt.scale.to(torch.float16).to(qt.scale.dtype))
        del w
    return dict(ref, layers=layers)


def params_diff(torch, a, b, path="params"):
    """None if two parameter dicts are equal leaf for leaf, bit for bit,
    dtypes included; else the path of the first leaf that differs."""
    from fastertransformer4codefuse_tpu_torch.models.params import QuantizedTensor

    if isinstance(a, dict):
        if set(a) != set(b):
            return f"{path} keys"
        return next((d for k in a if (d := params_diff(torch, a[k], b[k], f"{path}.{k}"))),
                    None)
    if isinstance(a, QuantizedTensor):
        if (not isinstance(b, QuantizedTensor)
                or (a.bits, a.group_size, a.k_axis) != (b.bits, b.group_size, b.k_axis)):
            return f"{path} format"
        return params_diff(torch, a.q, b.q, path + ".q") or params_diff(torch, a.scale, b.scale,
                                                                        path + ".scale")
    if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b):
        n = int((a != b).sum()) if a.shape == b.shape else -1
        return f"{path} ({a.dtype} {tuple(a.shape)} vs {b.dtype} {tuple(b.shape)}, {n} differ)"
    return None


def response_blocks(out):
    """Printed responses (``api.cli.print_response``) keyed by request index,
    the latency line dropped."""
    blocks = {}
    for block in out.split("#" * 50 + "\n")[1:]:
        lines = [ln for ln in block.splitlines() if not ln.startswith("- latency")]
        blocks[int(lines[0].split()[-1])] = lines
    return blocks


def phase_cli(torch, pkg, kernels, launched, cfg=None, dev="cuda"):
    """Phase 7, checkpoint -> CLI at CodeFuse-13B widths, CLI_LAYERS deep:
    random weights under HF GPT-NeoX names written by ``convert_hf_to_bin``
    (fp16), ``config.ini`` from ``GptNeoXConfig.codefuse_13b()``, int8 and
    int4 g128 payloads from ``quant_and_save``; for each served form (a) the
    loaded parameters equal ``cli_reference`` bit for bit; (b) ``api.cli.main``
    over a JSONL file of 4 greedy requests prints what a ``CodeFuseHandler``
    on an engine over the reference parameters gives; (c) ``--serve
    --paged_pages`` with the requests on stdin prints what a pooled handler
    over the reference parameters gives (the same route; the static run's
    answers are compared and logged); (d) exact launch counts of every run.
    The directory is removed at the end. ``cfg`` and ``dev`` serve a
    rehearsal at a tiny width on the CPU. Returns an error message, or None."""
    import contextlib
    import dataclasses
    import gc
    import io
    import shutil

    from fastertransformer4codefuse_tpu_torch.api import cli, generate
    from fastertransformer4codefuse_tpu_torch.api import handler as handler_mod
    from fastertransformer4codefuse_tpu_torch.api.trie import VocabTrie
    from fastertransformer4codefuse_tpu_torch.ckpt import loader
    from fastertransformer4codefuse_tpu_torch.ckpt.convert import convert_hf_to_bin
    from fastertransformer4codefuse_tpu_torch.ckpt.quantize import quant_and_save

    cfg = dataclasses.replace(cfg or pkg.GptNeoXConfig.codefuse_13b(), layer_num=CLI_LAYERS,
                              weight_data_type="fp16")
    L = cfg.layer_num
    path = os.path.join(REPO, "build", "phase7_ckpt")
    log(f"phase 7: checkpoint -> CLI, CodeFuse-13B widths, {L} layer{'s' * (L > 1)} (H 5120, "
        "40 x 128 heads, FFN 20480, vocab 100831), fp16 on disk")
    tok = IdTokenizer()
    text = "def quick_sort(arr):\n    if not arr:\n        return arr\n" * 20  # no "<"
    reqs = [{"prompts": [{"prompt": text[:n], "top_k": 1, "random_seed": i}],
             "out_seq_length": CLI_OUT} for i, n in enumerate(CLI_PROMPTS)]
    runs = []  # decode forwards of each GptNeoXEngine.generate call
    engine_generate = pkg.GptNeoXEngine.generate
    handlers = []

    def counted_generate(self, *a, **kw):
        out = engine_generate(self, *a, **kw)
        runs.append(self.decode_forwards)
        return out

    class Recorded(handler_mod.CodeFuseHandler):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            handlers.append(self)

    saved = (generate.load_tokenizer, handler_mod.CodeFuseHandler)
    generate.load_tokenizer = lambda p: tok
    handler_mod.CodeFuseHandler = Recorded
    pkg.GptNeoXEngine.generate = counted_generate
    try:
        shutil.rmtree(path, ignore_errors=True)
        t0 = time.time()
        model = neox_stand_in(torch, cfg, seed=17, dev=dev)
        t1 = time.time()
        convert_hf_to_bin(model, path, weight_data_type="fp16")
        cfg.to_ini(path)
        t2 = time.time()
        quant_and_save(path)
        quant_and_save(path, weight_bits=4, group_size=128)
        t3 = time.time()
        size = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
        log(f"  random weights {t1 - t0:.1f} s; convert_hf_to_bin {t2 - t1:.1f} s; "
            f"quant_and_save int8 + int4 g128 {t3 - t2:.1f} s; directory {size / 1e9:.2f} GB")
        jsonl = os.path.join(path, "requests.jsonl")
        with open(jsonl, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in reqs)

        for label, flags, quant, kv in CLI_RUNS:
            gemm = gemm_of(**quant)

            def static_expect():
                return add_counts(*(expected_launches(L, 1, fw, fused=True, head=False, **quant)
                                    for fw in runs))

            # (a) the loaded parameters
            gc.collect()
            torch.cuda.empty_cache()
            ref = cli_reference(torch, cfg, model.state_dict(), quant, dev)
            t0 = time.time()
            lcfg, loaded = loader.load_bin_checkpoint(path, dtype="bf16", int8_mode=1,
                                                      device=dev, **quant)
            if dev == "cuda":
                torch.cuda.synchronize()
            t_load = time.time() - t0
            rd = dict(loader.last_read)
            if lcfg != cfg:
                return f"{label}: the loaded config.ini differs: {lcfg} vs {cfg}"
            diff = params_diff(torch, loaded, ref)
            if diff:
                return f"{label} (a): the loaded parameters differ from the reference: {diff}"
            del loaded
            log(f"  {label} (a): loaded == quantize_array of the fp16 weights (scales through "
                f"fp16), bit for bit; load {t_load:.2f} s, of it reading {rd['bytes'] / 1e9:.2f} "
                f"GB in {rd['seconds']:.2f} s = {rd['bytes'] / 1e9 / rd['seconds']:.2f} GB/s "
                f"({rd['files']} files, {rd['reader']} reader)")
            engine = pkg.GptNeoXEngine(cfg, ref, pkg.RuntimeConfig(
                dtype="bf16", int8_mode=1, kv_cache_dtype=kv))
            trie = VocabTrie(tok.get_vocab())

            # (b) the JSONL loop against a handler on the reference engine
            zero_counts(kernels)
            runs.clear()
            buf = io.StringIO()
            t0 = time.time()
            with contextlib.redirect_stdout(buf):
                cli.main(["--ckpt_path", path, "--tokenizer_path", "bytes", "--input_file",
                          jsonl, "--device", dev, *flags])
            t_cli = time.time() - t0
            err = check_static_counts(torch, kernels, launched, L, len(runs), sum(runs),
                                      quant, expect_runs=static_expect())
            if err:
                return f"{label} (d), the CLI's JSONL loop: {err}"
            got = response_blocks(buf.getvalue())
            zero_counts(kernels)
            runs.clear()
            h = handler_mod.CodeFuseHandler(engine=engine, tokenizer=tok, trie=trie, warmup=False)
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                for i, r in enumerate(reqs):
                    code, msg, res = h.predict(r, f"ref-{i}")
                    if code != 0:
                        return f"{label}: the reference handler failed: {msg}"
                    cli.print_response(i, r, json.loads(res["res"]))
            err = check_static_counts(torch, kernels, launched, L, len(runs), sum(runs),
                                      quant, expect_runs=static_expect())
            if err:
                return f"{label} (d), the reference handler: {err}"
            want = response_blocks(buf.getvalue())
            if got != want or len(got) != len(reqs):
                return f"{label} (b): the CLI printed other responses than the handler"
            n_tok = [sum(ln.count("<") for ln in got[i]) for i in range(len(reqs))]
            log(f"  {label} (b): api.cli.main, {len(reqs)} greedy requests (prompts "
                f"{min(CLI_PROMPTS)}-{max(CLI_PROMPTS)} bytes, {CLI_OUT} tokens): printed "
                f"== the handler on the reference engine; tokens {n_tok}; {t_cli:.1f} s with "
                f"the load and the warm-up")

            # (c) --serve --paged_pages, the requests on stdin
            zero_counts(kernels)
            runs.clear()
            handlers.clear()
            lines = "".join(json.dumps(r) + "\n" for r in reqs)
            stdin, sys.stdin = sys.stdin, io.StringIO(lines)
            buf = io.StringIO()
            t0 = time.time()
            try:
                with contextlib.redirect_stdout(buf):
                    cli.main(["--ckpt_path", path, "--tokenizer_path", "bytes", "--device", dev,
                              *flags, "--serve",
                              "--pool_slots", str(CLI_POOL["max_slots"]), "--pool_seq_len",
                              str(CLI_POOL["max_seq_len"]), "--prompt_bucket",
                              str(CLI_POOL["prompt_bucket"]), "--paged_pages",
                              str(CLI_PAGES["num_pages"]), "--page_size",
                              str(CLI_PAGES["page_size"])])
            finally:
                sys.stdin = stdin
            t_serve = time.time() - t0
            b = handlers[-1].server.batcher
            err = check_counts(kernels, launched, [b], L, f"{label}, the CLI's --serve pool",
                               extra=static_expect(), gemm=gemm)
            if err:
                return f"{label} (d): {err}"
            served = response_blocks(buf.getvalue())
            zero_counts(kernels)
            runs.clear()
            hp = handler_mod.CodeFuseHandler(engine=engine, tokenizer=tok, trie=trie,
                                             warmup=False, pool=dict(CLI_POOL, paged=CLI_PAGES))
            buf = io.StringIO()
            try:
                with contextlib.redirect_stdout(buf):
                    for i, r in enumerate(reqs):
                        code, msg, res = hp.predict(r, f"pool-{i}")
                        if code != 0:
                            return f"{label}: the reference pooled handler failed: {msg}"
                        cli.print_response(i, r, json.loads(res["res"]))
            finally:
                hp.close()
            err = check_counts(kernels, launched, [hp.server.batcher], L,
                               f"{label}, the reference pooled handler", gemm=gemm)
            if err:
                return f"{label} (d): {err}"
            if served != response_blocks(buf.getvalue()) or len(served) != len(reqs):
                return f"{label} (c): --serve printed other responses than the pooled handler"
            as_static = [i for i in range(len(reqs)) if served[i] == got[i]]
            log(f"  {label} (c): --serve --paged_pages {CLI_PAGES['num_pages']} (page "
                f"{CLI_PAGES['page_size']}), requests on stdin: == the pooled handler on the "
                f"reference engine; requests answered as the static run did: {as_static} "
                f"(chunked prefill attends by K10, the static prefill by K5); {t_serve:.1f} s "
                f"with the load and the warm-up ({CARD})")
            del engine, h, hp, ref
        return None
    finally:
        generate.load_tokenizer, handler_mod.CodeFuseHandler = saved
        pkg.GptNeoXEngine.generate = engine_generate
        shutil.rmtree(path, ignore_errors=True)


# The decoder families at their published widths, under the attribute names
# of their HF config classes (the port's config_from_hf_* read them; no file
# is read and nothing is fetched): bigcode/starcoder (GPTBigCodeConfig),
# Qwen/Qwen2.5-Coder-7B (Qwen2Config), codellama/CodeLlama-7b-hf
# (LlamaConfig), EleutherAI/gpt-j-6b (GPTJConfig), gpt2-xl (GPT2Config),
# facebook/opt-6.7b (OPTConfig), mistralai/Mixtral-8x7B-v0.1 (MixtralConfig)
STARCODER = dict(n_embd=6144, n_head=48, n_layer=40, n_inner=24576, n_positions=8192,
                 vocab_size=49152, multi_query=True, activation_function="gelu_pytorch_tanh",
                 layer_norm_epsilon=1e-5, bos_token_id=0, eos_token_id=0)
CODELLAMA_7B = dict(hidden_size=4096, num_attention_heads=32, num_key_value_heads=32,
                    intermediate_size=11008, num_hidden_layers=32, vocab_size=32016,
                    rope_theta=1e6, rms_norm_eps=1e-5, hidden_act="silu", bos_token_id=1,
                    eos_token_id=2)
INT8 = dict(weight_bits=8, group_size=0)
# (label, registry family, HF config, weights, pool served beside the static
# engine: None, or the batcher's keywords)
FAMILIES = [
    # StarCoder's pool on int8 pages of 256: a 270-token prompt's third
    # chunk attends across a page boundary (K10 at g = 48)
    ("StarCoder", "starcoder", STARCODER, INT8,
     dict(max_slots=3, max_seq_len=512, prompt_bucket=128,
          paged=dict(num_pages=7, page_size=256))),
    ("Qwen2.5-Coder-7B", "qwen2", dict(
        hidden_size=3584, num_attention_heads=28, num_key_value_heads=4, intermediate_size=18944,
        num_hidden_layers=28, vocab_size=152064, rope_theta=1e6, rms_norm_eps=1e-6,
        hidden_act="silu", attention_bias=True, bos_token_id=151643, eos_token_id=151643),
     INT8, None),
    ("CodeLlama-7B", "llama", CODELLAMA_7B, INT8, None),
    ("CodeLlama-7B int4 g128", "llama", CODELLAMA_7B, dict(weight_bits=4, group_size=128), None),
    ("GPT-J-6B", "gptj", dict(
        n_embd=4096, n_head=16, n_layer=28, rotary_dim=64, n_inner=None, vocab_size=50400,
        activation_function="gelu_new", layer_norm_epsilon=1e-5, bos_token_id=50256,
        eos_token_id=50256), INT8, None),
    ("GPT-2 XL", "gpt", dict(
        n_embd=1600, n_head=25, n_layer=48, n_positions=1024, n_inner=None, vocab_size=50257,
        activation_function="gelu_new", layer_norm_epsilon=1e-5, bos_token_id=50256,
        eos_token_id=50256), INT8,
     dict(max_slots=2, max_seq_len=64, prompt_bucket=8, paged=dict(num_pages=17, page_size=8))),
    ("OPT-6.7B", "opt", dict(
        hidden_size=4096, num_attention_heads=32, num_hidden_layers=32, ffn_dim=16384,
        vocab_size=50272, max_position_embeddings=2048, activation_function="relu",
        do_layer_norm_before=True, word_embed_proj_dim=4096, bos_token_id=2, eos_token_id=2),
     INT8, None),
    ("Mixtral-8x7B", "mixtral", dict(
        hidden_size=4096, num_attention_heads=32, num_key_value_heads=8, intermediate_size=14336,
        num_hidden_layers=32, vocab_size=32000, num_local_experts=8, num_experts_per_tok=2,
        rope_theta=1e6, rms_norm_eps=1e-5, hidden_act="silu", bos_token_id=1, eos_token_id=2),
     INT8, dict(max_slots=2, max_seq_len=64, prompt_bucket=8)),
]
FAMILY_PROMPTS = [[5, 9, 3, 17, 2, 40, 41], [11, 4, 90], [30, 31, 32, 33, 34, 35, 36, 37, 38, 39]]
FAMILY_TOKENS = 8
# the depth of phase 8b's card-vs-CPU checks: 1 layer, as the CPU's plain
# bf16 products take most of the phase (~165 s at 2 layers beside one H100;
# phase 3's 2-layer 13B-width models hold the layer loop of the same graph to
# the CPU). Mixtral keeps its 2: at 1 layer (seed 11) its batched card greedy
# parted from the CPU's past NEAR_TIE on the same experts (gap 1.14e-1, the
# card alone picking a third token), which expert capacity cut by the batch's
# shape may explain. At 2 layers a pool parting of the same kind was traced:
# the CPU pool's own logits held the two tokens 4.67e-3 apart while a
# prefill of the context (other capacities) held them 1.33e-1 apart
# (``pool_gap``)
FAMILY_LAYERS = {"Mixtral-8x7B": 2}
# a pool on pages of 256 takes prompts of these lengths (random ids, seed 5):
# the longest chunked across a page boundary
LONG_FAMILY_PROMPTS = (270, 9, 140)


def family_prompts(pool, vocab):
    """The prompts of a family check: FAMILY_PROMPTS, or, where the pool's
    pages are 256 long, LONG_FAMILY_PROMPTS' lengths."""
    if pool is None or pool.get("paged", {}).get("page_size", 0) < 256:
        return FAMILY_PROMPTS
    rng = np.random.default_rng(5)
    return [rng.integers(0, vocab, n).tolist() for n in LONG_FAMILY_PROMPTS]


def family_config(pkg, family, hf, layers=None):
    """The port's config of a published HF configuration (``hf``, attribute
    names as HF's config class), through the registry's parser; ``layers``
    cuts the depth."""
    import types

    from fastertransformer4codefuse_tpu_torch.models import registry

    cfg = registry.get(family).config_from_hf(types.SimpleNamespace(**hf))
    if layers:
        cfg = pkg.GptNeoXConfig(**{**cfg.__dict__, "layer_num": layers})
    return cfg


def family_params(torch, pkg, cfg, hf, seed, device, quant):
    """Random int8 (or ``quant``) weights and int8 embeddings, as each
    family's converter lays them out: the learned position table as long as
    ``n_positions`` (the converters install the checkpoint's whole table);
    GPT-J with no QKV bias (its q, k and v are bias-free, and the port's
    converter stores none)."""
    p = pkg.init_params(cfg, seed=seed, dtype="bf16", int8_mode=1, quantize_embeddings=True,
                        device=device, **quant)
    if "pos_embed" in p:
        rows = hf.get("n_positions") or hf.get("max_position_embeddings")
        gen = torch.Generator(device=device).manual_seed(seed + 1)
        p["pos_embed"] = (torch.randn(rows, cfg.hidden_size, device=device, generator=gen)
                          * 0.01).to(torch.bfloat16)
    if cfg.rotary_style == "gptj":
        del p["layers"]["qkv_b"]
    return p


def family_launches(cfg, quant, prefills=0, forwards=0, beam=False, pools=()):
    """Launches each kernel wrapper must count for ``prefills`` prefills and
    ``forwards`` decode forwards of a decoder family's static engine, plus
    the ticks of ``pools``, with every big kernel quantized as ``quant``. A
    layer whose FFN K13 can compute (parallel residual, ungated, dense:
    GPT-J) runs K13 and the proj and down GEMMs in a sequence-wide forward
    (prefill, chunk tick), K13 and K3 in decode; any other layer one GEMM
    (K1, or K7 for int4 g128) for each of QKV and proj, and for each of
    up and down (and gate, gated) unless its FFN is an MoE, whose experts
    are batched products outside the kernels. Attention: K5 in prefill, K4
    in decode (K11 for beams); on pages K9, and K10 at dh 128 or 256 (other
    head dims count in ``plain_routes``, as the JAX package takes XLA);
    dense pools attend chunks in plain PyTorch. The int4 head is K8, one a
    prefill and a decode forward or tick."""
    from fastertransformer4codefuse_tpu_torch.ops.flash_decode import chunk_kernel_takes

    L = cfg.layer_num
    gemm = gemm_of(**quant)
    fused = cfg.use_gptj_residual and not cfg.gated_ffn and not cfg.moe_experts
    per_layer = 2 + (0 if cfg.moe_experts else 3 if cfg.gated_ffn else 2)
    out = {}

    def add(n, c):
        out[n] = out.get(n, 0) + c

    def forward(n, wide):
        if fused:
            add("fused_qkv_up", L * n)
            add(gemm, 2 * L * n) if wide else add("fused_proj_down", L * n)
        else:
            add(gemm, per_layer * L * n)

    forward(prefills, True)
    forward(forwards, False)
    add("prefill_attention_flash", L * prefills)
    add("flash_decode_beam" if beam else "flash_decode", L * forwards)
    heads = prefills + forwards
    for b in pools:
        d, c = b.decode_ticks, b.chunk_ticks
        forward(c, True)
        forward(d, False)
        heads += c + d
        if b.paged is None:
            add("flash_decode", L * d)
        else:
            add("flash_decode_paged", L * d)
            add("flash_chunk_paged" if chunk_kernel_takes(cfg.size_per_head) else "plain_routes",
                L * c)
    if quant["weight_bits"] == 4:
        add("quant_matmul_w4_head", heads)
    return {n: c for n, c in out.items() if c}


def family_tokens(pkg, cfg, params, prompts, n, pool=None, runs=None):
    """Greedy tokens (``n`` a prompt) of ``prompts`` on the params' device
    over an int8 KV cache: the static engine, or a ContinuousBatcher with
    the ``pool`` keywords. ``runs`` (a dict) counts the static prefills and
    decode forwards and keeps the batchers."""
    from fastertransformer4codefuse_tpu_torch.engine.batcher import ContinuousBatcher

    rt = pkg.RuntimeConfig(dtype="bf16", int8_mode=1, kv_cache_dtype="int8", seq_bucket=8)
    eng = pkg.GptNeoXEngine(cfg, params, rt)
    if pool is None:
        out = eng.generate(prompts, output_len=n, top_k=1)
        if runs is not None:
            runs["prefills"] += 1
            runs["forwards"] += eng.decode_forwards
        return [list(map(int, r[0][len(p):len(p) + n])) for r, p in zip(out.output_ids, prompts)]
    cb = ContinuousBatcher(eng, **pool)
    uids = [cb.submit(prompt=p, output_len=n, top_k=1) for p in prompts]
    done = cb.run(max_ticks=400)
    if runs is not None:
        runs["pools"].append(cb)
    return [list(map(int, done[u].output_ids[len(p):])) for u, p in zip(uids, prompts)]


def pool_gap(pkg, cfg, params, ids, pool, a, b):
    """(logit of ``b`` - logit of ``a``) / max |logits| in the first token
    a pool (``pool`` keywords) alone on ``ids`` picks: the logits of the
    decode tick that picked it, row 0 (the one request's slot)."""
    from fastertransformer4codefuse_tpu_torch.models import gptneox as model

    real, last = model.lm_logits, []

    def recording(*args, **kw):
        out = real(*args, **kw)
        last[:] = [out]
        return out

    model.lm_logits = recording
    try:
        family_tokens(pkg, cfg, params, [ids], 1, pool)
    finally:
        model.lm_logits = real
    lg = last[0][0].float()
    return ((lg[b] - lg[a]) / lg.abs().max()).item()


def family_check(torch, pkg, kernels, launched, label, family, hf, quant, pool):
    """One decoder family at its published widths and 1 layer (FAMILY_LAYERS), built on
    the card and copied to the CPU: prefill (B = 2, 64 tokens) and 3
    teacher-forced decode steps, card logits against the CPU's; greedy
    tokens of FAMILY_PROMPTS on the static engine and of
    ``family_prompts`` on (``pool``) a pool, the card's held to the CPU's
    (``hold_to_cpu``); the launches of every card run exact. An MoE
    model's card logits and tokens, static and pooled, are also run twice
    and must be equal bytes. Returns an error or None."""
    import gc

    from fastertransformer4codefuse_tpu_torch.models.params import param_bytes, params_to

    cfg = family_config(pkg, family, hf, layers=FAMILY_LAYERS.get(label, 1))
    t0 = time.time()
    p_card = family_params(torch, pkg, cfg, hf, 11, "cuda", quant)  # the card's generator: fast
    p_cpu = params_to(p_card, "cpu")
    kv = torch.int8
    zero_counts(kernels)
    card = []
    rels = phase_reference(torch, (cfg, p_cpu, p_card), card_logits=card)
    runs = dict(prefills=0, forwards=0, pools=[])
    def routes(ids):  # the card's and the CPU's experts on a context (one prefill each)
        runs["prefills"] += 1
        return routing_differs(torch, cfg, p_card, p_cpu, ids, kv)

    log_ties, sides = [], [("static", None, FAMILY_PROMPTS)] + (
        [("pool", pool, family_prompts(pool, cfg.vocab_size))] if pool is not None else [])
    got = {}
    for side, kw, prompts in sides:
        got[side] = family_tokens(pkg, cfg, p_card, prompts, FAMILY_TOKENS, kw, runs)
        want = family_tokens(pkg, cfg, p_cpu, prompts, FAMILY_TOKENS, kw)
        err, ties = hold_to_cpu(
            torch, cfg, p_cpu, kv, prompts, got[side], want, FAMILY_TOKENS,
            lambda p, n, kw=kw: family_tokens(pkg, cfg, p_card, [p], n, kw, runs)[0],
            lambda p, n, kw=kw: family_tokens(pkg, cfg, p_cpu, [p], n, kw)[0],
            routes if cfg.moe_experts else None,
            (lambda ids, a, b, kw=kw: pool_gap(pkg, cfg, p_cpu, ids, kw, a, b))
            if cfg.moe_experts and kw is not None else None)
        if err:
            return f"{label}: {side} greedy: {err}"
        log_ties += [f"{side} {t}" for t in ties]
    same = ""
    if cfg.moe_experts:
        again = []
        phase_reference(torch, (cfg, p_cpu, p_card), card_logits=again)
        if not all(torch.equal(a, b) for a, b in zip(card, again)) or any(
                family_tokens(pkg, cfg, p_card, prompts, FAMILY_TOKENS, kw, runs) != got[side]
                for side, kw, prompts in sides):
            return f"{label}: two runs on the card differ (the MoE combine must be deterministic)"
        same = "; two runs on the card: equal bytes (logits) and tokens (static and pool)"
    torch.cuda.synchronize()
    forwards = 3 * (2 if cfg.moe_experts else 1) + runs["forwards"]
    prefills = (2 if cfg.moe_experts else 1) + runs["prefills"]
    expect = family_launches(cfg, quant, prefills, forwards, pools=runs["pools"])
    err = check_run_counts(torch, kernels, launched, expect, f"{label}, card runs")
    log(f"  {label} ({cfg.hidden_size}, {cfg.head_num} x {cfg.size_per_head} on "
        f"{cfg.kv_heads} KV heads, FFN {cfg.inter_size}"
        f"{f' x {cfg.moe_experts} experts' if cfg.moe_experts else ''}, vocab "
        f"{cfg.vocab_size}, {param_bytes(p_card) / 2**30:.2f} GiB at {cfg.layer_num} "
        f"layer{'s' * (cfg.layer_num > 1)}; checked in "
        f"{time.time() - t0:.1f} s): logits after prefill and 3 steps "
        f"{', '.join(f'{r:.2e}' for r in rels)} (tol 5e-2); greedy == CPU's ("
        + " and ".join(f"{side}, prompts of {[len(p) for p in prompts]} tokens"
                       for side, _, prompts in sides) + ")"
        f"{' (near-ties, then teacher-forced: ' + '; '.join(log_ties) + ')' if log_ties else ''}"
        f"{same}")
    del p_cpu, p_card, card
    gc.collect()
    torch.cuda.empty_cache()
    if err:
        return err
    if max(rels) >= 5e-2:
        return f"{label}: card and CPU logits disagree"
    return None


def phase_families(torch, pkg, kernels, launched):
    """The decoder families: StarCoder at full width and depth
    (``phase_starcoder``), then the six others at their published widths
    and 1 layer (Mixtral 2), card against CPU (``family_check``). Returns an error or
    None."""
    err = phase_starcoder(torch, pkg, kernels, launched)
    if err:
        return f"StarCoder: {err}"
    log("phase 8b: decoder families at published widths, 1 layer (Mixtral 2), card (kernels) "
        "vs CPU (plain)")
    for label, family, hf, quant, pool in FAMILIES:
        err = family_check(torch, pkg, kernels, launched, label, family, hf, quant, pool)
        if err:
            return err
    return None


# A full-size pool token may lie this far (a share of max |logits|) below
# the static program's argmax at its step: the pool attends its chunks by
# K10 and decodes by K9, the static prefill by K5, and over 40 layers of
# random weights their roundings part greedy runs at gaps up to 2.28e-2
# (recorded on the card); 5e-2 is the logits tolerance of every card check.
POOL_GAP = 5e-2
STAR_POOL_PROMPTS = (1800, 130, 900, 1500, 400, 1100, 700)
STAR_POOL_OUTS = (128, 32, 64, 96, 48, 128, 32)
STAR_ALONE = (1, 4, 6)  # the requests run again alone
# phase 8's depth: 10 of StarCoder's 40 layers, as phase 4 cuts CodeFuse-13B
STAR_LAYERS = 10


def static_gaps(torch, engine, context, gen):
    """Greedy tokens ``gen``, generated after ``context``, against the static
    program teacher-forced: one prefill (K5) of ``context`` and all of
    ``gen`` but the last, its logits at each step. Returns each step's gap
    from its argmax to the token's logit over max |logits| (0 where the
    token is the argmax)."""
    from fastertransformer4codefuse_tpu_torch.engine import kv_cache
    from fastertransformer4codefuse_tpu_torch.models import gptneox as model

    cfg, params, dev = engine.config, engine.params, engine.device
    ids = list(context) + list(gen[:-1])
    cache = kv_cache.init_cache(cfg, 1, len(ids), engine._cache_dtype(), dev)
    lens = torch.tensor([len(ids)], dtype=torch.int32, device=dev)
    hidden, _ = model.prefill(cfg, params, torch.tensor([ids], device=dev), lens, cache)
    lg = model.lm_logits(cfg, params, hidden[0, len(context) - 1:]).float()
    toks = torch.tensor(list(gen), device=dev)[:, None]
    return ((lg.amax(-1) - lg.gather(1, toks)[:, 0]) / lg.abs().amax(-1)).cpu().numpy()


def phase_starcoder(torch, pkg, kernels, launched):
    """StarCoder (bigcode/starcoder: 6144 wide, 48 query heads on one KV head,
    learned positions of 8192 rows) at full width and STAR_LAYERS of its 40
    layers on the card, int8
    weights and embeddings, an int8 KV cache, random weights: the engine (a
    1000-token prompt, 64 greedy tokens x2; B = 4 sampled x2; a 3000-token
    prompt), the handler, a paged BatchingServer taking 7 greedy requests
    from threads, and beam search (2 prompts x 4 beams, every hypothesis
    rescored); each path's launches exact, ``plain_routes`` 0. The pool's
    requests (STAR_ALONE) must give the same tokens alone as in the mix,
    and every pool token is held to the static program teacher-forced
    (``static_gaps``): it must lie within POOL_GAP of max |logits| of that
    step's argmax. (The 1-layer StarCoder of FAMILIES holds a pool on the
    same pages to the CPU's, token for token past NEAR_TIE.) Returns an
    error or None."""
    import gc

    from fastertransformer4codefuse_tpu_torch.api.handler import CodeFuseHandler
    from fastertransformer4codefuse_tpu_torch.api.trie import VocabTrie
    from fastertransformer4codefuse_tpu_torch.engine import kv_cache
    from fastertransformer4codefuse_tpu_torch.engine.server import BatchingServer
    from fastertransformer4codefuse_tpu_torch.models.params import param_bytes

    log(f"phase 8: StarCoder (bigcode/starcoder, {STAR_LAYERS} of 40 layers, full width, int8 "
        "weights and KV) on the card")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = family_config(pkg, "starcoder", STARCODER, layers=STAR_LAYERS)
    t0 = time.time()
    params = family_params(torch, pkg, cfg, STARCODER, 0, "cuda", INT8)
    torch.cuda.synchronize()
    log(f"  params {param_bytes(params) / 2**30:.2f} GiB built in {time.time() - t0:.1f} s "
        f"({cfg.head_num} x {cfg.size_per_head} on {cfg.kv_heads} KV head, FFN "
        f"{cfg.inter_size}, vocab {cfg.vocab_size}, {params['pos_embed'].shape[0]} positions)")
    engine = pkg.GptNeoXEngine(
        cfg, params, pkg.RuntimeConfig(dtype="bf16", int8_mode=1, kv_cache_dtype="int8"))
    V = cfg.vocab_size
    rng = np.random.default_rng(21)
    prompt = rng.integers(0, V, 1000).tolist()
    zero_counts(kernels)
    runs = dict(prefills=0, forwards=0)

    def run(*a, **kw):
        torch.cuda.synchronize()
        t = time.time()
        out = engine.generate(*a, **kw)
        torch.cuda.synchronize()
        runs["forwards"] += engine.decode_forwards
        runs["prefills"] += 1
        return out, time.time() - t, engine.decode_forwards

    run([prompt[:100]], 1, top_k=1)  # the first call's set-up is not prefill time
    _, t_pre, _ = run([prompt], 1, top_k=1)
    g1, t1, f1 = run([prompt], 64, top_k=1, return_cum_log_probs=True)
    g2, t2, _ = run([prompt], 64, top_k=1, return_cum_log_probs=True)
    if not np.array_equal(g1.output_ids, g2.output_ids):
        return "greedy generation is not deterministic"
    gen = g1.output_ids[0, 0, 1000:g1.sequence_lengths[0, 0]]
    if (gen < 0).any() or (gen >= V).any() or not np.isfinite(g1.cum_log_probs).all():
        return "greedy ids out of range or non-finite logits"
    step_ms = (min(t1, t2) - t_pre) / max(f1, 1) * 1e3
    err, off, _ = forced_check(torch, engine, prompt, gen.tolist()[:16])
    if err:
        return f"greedy tokens: {err}"
    runs["prefills"] += 1
    runs["forwards"] += min(16, len(gen)) - 1
    lens = [100, 367, 633, 900]
    prompts = [rng.integers(0, V, n).tolist() for n in lens]
    kw = dict(top_k=40, top_p=0.9, temperature=0.8, repetition_penalty=1.1,
              random_seed=[11, 22, 33, 44], return_cum_log_probs=True)
    _, t_pre4, _ = run(prompts, 1, **kw)
    s1, ts, fs = run(prompts, 32, **kw)
    s2, _, _ = run(prompts, 32, **kw)
    if not np.array_equal(s1.output_ids, s2.output_ids) or not np.isfinite(s1.cum_log_probs).all():
        return "sampling with per-row seeds is not reproducible"
    step4_ms = (ts - t_pre4) / max(fs, 1) * 1e3
    long_prompt = rng.integers(0, V, 3000).tolist()
    _, t_long, _ = run([long_prompt], 1, top_k=1)
    l1, _, _ = run([long_prompt], 16, top_k=1)
    if (l1.output_ids[0, 0, 3000:l1.sequence_lengths[0, 0]] >= V).any():
        return "3000-token prompt: ids out of range"
    log(f"  B=1 1000-token prompt, 64 greedy tokens x2: identical (first 16 the concatenated "
        f"run's argmax{' but near-ties ' + str(off) if off else ''}); prefill "
        f"{t_pre * 1e3:.1f} ms, decode {step_ms:.2f} ms/step; B=4 ragged {lens}, 32 sampled x2: "
        f"reproducible, decode {step4_ms:.2f} ms/step; 3000-token prompt: prefill "
        f"{t_long * 1e3:.1f} ms ({CARD})")
    tok = ByteTokenizer()
    handler = CodeFuseHandler(engine=engine, tokenizer=tok, trie=VocabTrie(tok.get_vocab()),
                              warmup=False)
    req = {"prompts": [{"prompt": "def fib(n):\n    " * 30, "top_k": 1, "random_seed": 5}],
           "out_seq_length": 32}
    answers = []
    for stream in (False, True):
        code, msg, res = handler.predict(dict(req, stream=stream), f"star-{int(stream)}")
        runs["forwards"] += engine.decode_forwards
        runs["prefills"] += 1
        if code != 0:
            return f"handler request failed: {msg}"
        answers.append(json.loads(res["res"]))
    if answers[0]["generated_code"] != answers[1]["generated_code"]:
        return "the streamed handler response differs"
    log(f"  handler: greedy == streamed, length {answers[0]['length']}")
    err = check_run_counts(torch, kernels, launched,
                           family_launches(cfg, INT8, runs["prefills"], runs["forwards"]),
                           "StarCoder engine and handler")
    if err:
        return err

    # the paged pool: 7 greedy requests from threads, 2 arriving late
    reqs = [(rng.integers(0, V, n).tolist(), o, dict(top_k=1))
            for n, o in zip(STAR_POOL_PROMPTS, STAR_POOL_OUTS)]
    zero_counts(kernels)
    srv = BatchingServer(engine, paged=dict(PAGES), max_slots=8,
                         max_seq_len=2048, prompt_bucket=128, pipeline_ticks=True)
    try:
        res, wall = drive_mix(srv, reqs, late=2)
        b = srv.batcher
        err = bad_length(res, reqs, cfg.end_id, V)
        if err:
            return f"pool: {err}"
        torch.cuda.synchronize()
        gen_n = sum(len(r.output_ids) - len(p) for r, (p, _, _) in zip(res, reqs))
        err = check_run_counts(torch, kernels, launched, family_launches(cfg, INT8, pools=[b]),
                               f"StarCoder paged pool ({b.decode_ticks} decode ticks, "
                               f"{b.chunk_ticks} with a chunk)")
        if err:
            return err
        log(f"  paged pool (8 slots, 64 pages of 256): 7 greedy requests (prompts "
            f"{min(STAR_POOL_PROMPTS)}-{max(STAR_POOL_PROMPTS)}, outputs {min(STAR_POOL_OUTS)}-"
            f"{max(STAR_POOL_OUTS)}, 2 arriving late): {gen_n} tokens in {wall:.2f} s = "
            f"{gen_n / wall:.1f} tokens/s ({CARD})")
        # requests alone in the pool: their tokens in the mix, bit for bit
        # (a pool's rows do not depend on the other rows); the three shortest
        zero_counts(kernels)
        b.decode_ticks = b.chunk_ticks = 0
        for i in STAR_ALONE:
            p, o, kw = reqs[i]
            if srv.generate(p, o, **kw).output_ids != res[i].output_ids:
                return f"pool request {i} alone differs from itself inside the mix"
        err = check_run_counts(torch, kernels, launched, family_launches(cfg, INT8, pools=[b]),
                               f"StarCoder paged pool, each request alone ({b.decode_ticks} "
                               f"decode ticks, {b.chunk_ticks} with a chunk)")
        if err:
            return err
        # every pool token against the static program's teacher-forced
        # logits at its step (a prefill, K5, of the prompt and the tokens)
        gaps = [static_gaps(torch, engine, p, r.output_ids[len(p):])
                for r, (p, _, _) in zip(res, reqs)]
        log(f"  requests {list(STAR_ALONE)} alone == themselves in the mix; each pool token vs "
            f"the static program's argmax at its step (teacher-forced): "
            + "; ".join(f"request {i}: {int((g > 0).sum())} of {len(g)} steps off, max gap "
                        f"{g.max():.2e}" for i, g in enumerate(gaps))
            + f" (limit {POOL_GAP:g} of max |logits|)")
        worst = int(np.argmax([g.max() for g in gaps]))
        if gaps[worst].max() > 0:
            # the witness: the same request in a pool whose chunk attention
            # is the plain version (not K10), held the same way
            p, o, kw = reqs[worst]
            real = kv_cache.chunk_kernel_takes
            kv_cache.chunk_kernel_takes = lambda dh: False
            try:
                plain = srv.generate(p, o, **kw).output_ids
            finally:
                kv_cache.chunk_kernel_takes = real
            g = static_gaps(torch, engine, p, plain[len(p):])
            j = next((j - len(p) for j, (x, y) in enumerate(zip(plain, res[worst].output_ids))
                      if x != y), None)
            log(f"  witness: request {worst} in a pool whose chunk attention is the plain version "
                f"({kv_cache.attend_chunk.plain_routes} plain chunk calls): "
                + ("the K10 pool's tokens" if j is None else
                   f"parts from the K10 pool's tokens at token {j}")
                + f"; {int((g > 0).sum())} of {len(g)} steps off the static argmax, max gap "
                f"{g.max():.2e}")
        if max(g.max() for g in gaps) >= POOL_GAP:
            return (f"pool request {worst}: a token lies {gaps[worst].max():.2e} of max |logits| "
                    f"below the static program's argmax (limit {POOL_GAP:g})")
    finally:
        srv.close()
    # beam search: 2 prompts x 4 beams, 32 tokens, every hypothesis rescored
    zero_counts(kernels)
    bprompts = [rng.integers(0, V, n).tolist() for n in (600, 300)]
    bo = engine.generate(bprompts, 32, beam_width=4, output_log_probs=True)
    bf = engine.decode_forwards
    d, n = rescore(torch, engine, bo, bprompts)
    log(f"  beam search B=2 x 4 beams, 32 tokens: {bf} decode forwards; rescoring of the 8 "
        f"hypotheses |dlogprob| mean {d.mean():.2e}, max {d.max():.2e} nats per token (limit "
        f"0.05 mean)")
    if not np.isfinite(d).all() or d.mean() > 0.05:
        return "beam search: the hypotheses' log-probs disagree with their rescoring"
    err = check_run_counts(torch, kernels, launched,
                           add_counts(family_launches(cfg, INT8, 1, bf, beam=True),
                                      family_launches(cfg, INT8, n)),
                           "StarCoder beam search and its rescoring")
    if err:
        return err
    log(f"  StarCoder: peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"prefill {t_pre * 1e3:.1f} ms (1000 tokens), {t_long * 1e3:.1f} ms (3000); decode "
        f"{step_ms:.2f} ms/step at B=1, {step4_ms:.2f} at B=4; pool {gen_n / wall:.1f} "
        f"tokens/s ({CARD})")
    return None


# ---------------------------------------------------------------- phase 9 --
# Published configurations, as HF's config classes name their attributes.
# T5-3B: google-t5/t5-3b (relu FFN, tied head, no gating). Phase 9 serves
# T5_LAYERS of its 24 + 24 layers at full width (its decode is host-bound,
# its time in proportion to the depth), to keep the run within its time
# limit with phase 12.
T5_LAYERS = 12
T5_3B = dict(d_model=1024, d_kv=128, num_heads=32, d_ff=16384, num_layers=24,
             num_decoder_layers=24, vocab_size=32128, relative_attention_num_buckets=32,
             relative_attention_max_distance=128, feed_forward_proj="relu",
             layer_norm_epsilon=1e-6, decoder_start_token_id=0, eos_token_id=1,
             tie_word_embeddings=True)
# facebook/bart-large and Helsinki-NLP/opus-mt-en-de (Marian: sinusoidal
# positions, scaled embeddings, swish)
BART_LARGE = dict(d_model=1024, encoder_attention_heads=16, decoder_attention_heads=16,
                  encoder_ffn_dim=4096, decoder_ffn_dim=4096, encoder_layers=12,
                  decoder_layers=12, vocab_size=50265, max_position_embeddings=1024,
                  activation_function="gelu", scale_embedding=False, decoder_start_token_id=2,
                  eos_token_id=2, forced_eos_token_id=2)
MARIAN_EN_DE = dict(d_model=512, encoder_attention_heads=8, decoder_attention_heads=8,
                    encoder_ffn_dim=2048, decoder_ffn_dim=2048, encoder_layers=6,
                    decoder_layers=6, vocab_size=58101, max_position_embeddings=512,
                    activation_function="swish", scale_embedding=True,
                    decoder_start_token_id=58100, eos_token_id=0, forced_eos_token_id=0)
VIT_B16 = dict(hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
               intermediate_size=3072, image_size=224, patch_size=16, num_channels=3,
               layer_norm_eps=1e-12, hidden_act="gelu")
SWIN_T = dict(image_size=224, patch_size=4, num_channels=3, embed_dim=96, depths=[2, 2, 6, 2],
              num_heads=[3, 6, 12, 24], window_size=7, mlp_ratio=4.0, layer_norm_eps=1e-5,
              hidden_act="gelu")
DEBERTA_V3_BASE = dict(hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
                       intermediate_size=3072, vocab_size=128100, max_position_embeddings=512,
                       type_vocab_size=0, layer_norm_eps=1e-7, hidden_act="gelu",
                       relative_attention=True, position_buckets=256, max_relative_positions=-1,
                       pos_att_type=["p2c", "c2p"], norm_rel_ebd="layer_norm",
                       share_att_key=True, position_biased_input=False)
XLNET_BASE = dict(d_model=768, n_layer=12, n_head=12, d_head=64, d_inner=3072, vocab_size=32000,
                  ff_activation="gelu", layer_norm_eps=1e-12, clamp_len=-1)
# facebook/wav2vec2-conformer-rel-pos-large (LayerNorm feature extractor
# with conv biases, swish)
CONFORMER_LARGE = dict(hidden_size=1024, num_hidden_layers=24, num_attention_heads=16,
                       intermediate_size=4096, conv_dim=[512] * 7, conv_stride=[5, 2, 2, 2, 2, 2, 2],
                       conv_kernel=[10, 3, 3, 3, 3, 2, 2], conv_depthwise_kernel_size=31,
                       conv_bias=True, feat_extract_norm="layer", feat_extract_activation="gelu",
                       hidden_act="swish", layer_norm_eps=1e-5,
                       position_embeddings_type="relative")
T5_GREEDY_LENS = (64, 512, 200, 350, 97, 430, 150, 280)  # 8 greedy inputs (64-512 tokens)
T5_OUT = 64
T5_SAMPLED = ((300, 11), (120, 22))  # (input length, seed): top_k 40, each run twice
T5_BEAM_LENS = (256, 128, 400, 90)  # one group of 4 at beam width 4
SEQ_TOL = 5e-2  # card vs CPU: max |d| / max |ref|, as phase 3's models
BEAM_NATS = 0.05  # a beam's mean |dlogprob| a token against its rescoring (phase 4's limit)


def hf_ns(hf, **over):
    import types

    return types.SimpleNamespace(**{**hf, **over})


def t5_random_params(torch, cfg, seed, device, int8, dtype="bf16"):
    """Random T5 weights at the scales of HF's T5PreTrainedModel._init_weights
    (factor 1.0: q (d_model d_kv)^-0.5, k and v d_model^-0.5, o (heads d_kv)^-0.5,
    wi d_model^-0.5, wo d_ff^-0.5, the shared embedding 1, the bucket tables
    d_model^-0.5, norms 1), drawn on ``device`` from one generator, a stacked
    weight at a time; with ``int8`` each is quantized there
    (``ckpt.quantize.quantize_array``) before the next is drawn, so no fp32
    copy of the model is ever whole."""
    from fastertransformer4codefuse_tpu_torch.ckpt.quantize import quantize_array
    from fastertransformer4codefuse_tpu_torch.core.dtypes import torch_dtype

    dt = torch_dtype(dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    D, dkv, nH, F_, V = cfg.d_model, cfg.size_per_head, cfg.head_num, cfg.inter_size, cfg.vocab_size
    inner = nH * dkv

    def normal(shape, std):
        return torch.empty(shape, device=device).normal_(0.0, std, generator=gen)

    def weight(L, K, N, std):
        w = normal((L, K, N), std)
        return quantize_array(w, k_axis=-2) if int8 else w.to(dt)

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=device)

    def side(L, cross):
        out = {"ln1_w": ones(L, D), "q_w": weight(L, D, inner, (D * dkv) ** -0.5),
               "k_w": weight(L, D, inner, D ** -0.5), "v_w": weight(L, D, inner, D ** -0.5),
               "o_w": weight(L, inner, D, inner ** -0.5), "ln2_w": ones(L, D),
               "wi": weight(L, D, F_, D ** -0.5), "wo": weight(L, F_, D, F_ ** -0.5)}
        if cross:
            out.update({"ln_x_w": ones(L, D), "xq_w": weight(L, D, inner, (D * dkv) ** -0.5),
                        "xk_w": weight(L, D, inner, D ** -0.5),
                        "xv_w": weight(L, D, inner, D ** -0.5),
                        "xo_w": weight(L, inner, D, inner ** -0.5)})
        return out

    return {
        "embed": normal((V, D), 1.0).to(dt),
        "enc": side(cfg.layer_num, False),
        "dec": side(cfg.dec_layer_num, True),
        "enc_rel_bias": normal((cfg.num_buckets, nH), D ** -0.5).to(dt),
        "dec_rel_bias": normal((cfg.num_buckets, nH), D ** -0.5).to(dt),
        "enc_final_ln_w": ones(D),
        "dec_final_ln_w": ones(D),
    }


def forced_logits(torch, mod, cfg, params, inputs, rows):
    """One teacher-forced pass of an encoder-decoder family (``mod``:
    models.t5 or models.bart) on the params' device over len(rows) rows: row
    b encodes ``inputs[b]`` (ragged, padded) and its decoder is fed the
    start token and ``rows[b]`` but the last (padded with end_id). Returns
    each row's fp32 logits [len(rows[b]), V]; with one row, a solo pass."""
    B, T = len(rows), max(len(r) for r in rows)
    lens = np.array([len(x) for x in inputs])
    ids = np.zeros((B, lens.max()), np.int64)
    for b, x in enumerate(inputs):
        ids[b, :len(x)] = x
    enc = mod.encode(cfg, params, ids, lens)
    state = mod.init_decoder_state(cfg, params, enc, lens, T + 1)
    feed = np.full((B, T), cfg.end_id)
    feed[:, 0] = cfg.start_id
    for b, r in enumerate(rows):
        feed[b, 1:len(r)] = r[:-1]
    out = []
    for t in range(T):
        lg, state = mod.decode_step(cfg, params, state, feed[:, t], t)
        out.append(lg.float())
    out = torch.stack(out, 1)  # [B, T, V]
    return [out[b, :len(r)] for b, r in enumerate(rows)]


def gaps_to_argmax(torch, logits, tokens):
    """Each step's gap from its argmax to the token's logit, over max |logits|."""
    toks = torch.as_tensor(list(tokens), device=logits.device)[:, None]
    return ((logits.amax(-1) - logits.gather(1, toks)[:, 0]) / logits.abs().amax(-1)).cpu().numpy()


def s2s_greedy(torch, mod, cfg, params, ids, forced, n):
    """Greedy tokens of an encoder-decoder family on one input, B = 1: the
    decoder fed the start token and ``forced`` (teacher-forced), then its own
    argmax up to ``n`` tokens in all (EOS ends it). Returns (tokens after
    ``forced``, the fp32 logits of each of those steps)."""
    enc = mod.encode(cfg, params, np.asarray([ids]), np.asarray([len(ids)]))
    state = mod.init_decoder_state(cfg, params, enc, np.asarray([len(ids)]), n + 1)
    tok, toks, logs = cfg.start_id, [], []
    for t in range(n):
        lg, state = mod.decode_step(cfg, params, state, [tok], t)
        if t < len(forced):
            tok = forced[t]
            continue
        tok = int(lg[0].argmax())
        toks.append(tok)
        logs.append(lg[0].float().cpu())
        if tok == cfg.end_id:
            break
    return toks, logs


def s2s_hold(torch, mod, cfg, p_card, p_cpu, ids, n):
    """The card's greedy tokens on ``ids`` held to the CPU's: where they part,
    the CPU's two candidates must lie within NEAR_TIE of max |logits| (the
    CPU's logits at that step), and both go on from the CPU's token. Returns
    (error or None, the near-ties, the tokens compared)."""
    forced, ties = [], []
    while len(forced) < n:
        a, _ = s2s_greedy(torch, mod, cfg, p_card, ids, forced, n)
        b, logs = s2s_greedy(torch, mod, cfg, p_cpu, ids, forced, n)
        i = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if i is None:
            if len(a) != len(b):
                return f"card tokens {a} against the CPU's {b}", ties, forced + b
            return None, ties, forced + b
        lg = logs[i]
        gap = (lg[b[i]] - lg[a[i]]).item() / lg.abs().max().item()
        ties.append(f"step {len(forced) + i}: gap {gap:.2e}")
        if gap >= NEAR_TIE:
            return (f"card token {a[i]} against the CPU's {b[i]} at step {len(forced) + i} "
                    f"(gap {gap:.2e} of max |logits|)"), ties, forced + b
        forced = forced + b[:i + 1]
        if b[i] == cfg.end_id:
            break
    return None, ties, forced


def s2s_card_vs_cpu(torch, mod, cfg, p_card, p_cpu, inputs, steps=4, n=16):
    """An encoder-decoder family, card against CPU: the logits of ``steps``
    teacher-forced decoder steps on a batch of ``inputs`` (ragged), each as
    max |d| / max |logits|; then each input's greedy tokens (``n``), held by
    ``s2s_hold``. Returns (error or None, the logit errors, the near-ties)."""
    B, S = len(inputs), max(len(x) for x in inputs)
    ids = np.zeros((B, S), np.int64)
    for i, x in enumerate(inputs):
        ids[i, :len(x)] = x
    lens = np.array([len(x) for x in inputs])
    feed = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, steps))
    feed[:, 0] = cfg.start_id
    logits = {}
    for side, p in (("card", p_card), ("cpu", p_cpu)):
        enc = mod.encode(cfg, p, ids, lens)
        state = mod.init_decoder_state(cfg, p, enc, lens, steps + 1)
        logits[side] = []
        for t in range(steps):
            lg, state = mod.decode_step(cfg, p, state, feed[:, t], t)
            logits[side].append(lg.float().cpu())
    rels = [rel_err(torch, a, b)[1] for a, b in zip(logits["card"], logits["cpu"])]
    if not all(bool(torch.isfinite(a).all()) for a in logits["card"]):
        return "non-finite logits on the card", rels, []
    if max(rels) >= SEQ_TOL:
        return f"card and CPU logits disagree ({max(rels):.2e})", rels, []
    ties = []
    for x in inputs:
        err, t, _ = s2s_hold(torch, mod, cfg, p_card, p_cpu, list(x), n)
        ties += t
        if err:
            return err, rels, ties
    return None, rels, ties


class HeldEngine:
    """A T5 engine behind ``T5BatchingServer`` that records each batch (rows,
    output_len, beam width, wall ms ending in a synchronise, decoder steps)
    and, while ``hold`` is clear, keeps the server's thread inside the next batch, so
    that requests queue in a known order behind it."""

    def __init__(self, torch, engine):
        self.torch, self.engine, self.batches = torch, engine, []
        self.hold = threading.Event()
        self.hold.set()
        self.entered = threading.Event()

    def generate(self, ids, output_len, beam_width=1, **kw):
        self.entered.set()
        self.hold.wait(120)
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.engine.generate(ids, output_len, beam_width=beam_width, **kw)
        self.torch.cuda.synchronize()
        self.batches.append((len(ids), output_len, beam_width,
                             (time.perf_counter() - t0) * 1e3, self.engine.decode_forwards))
        return out


def t5_serve_mix(torch, srv, held, reqs):
    """One mix through ``srv``: a held head request (output_len 1) enters the
    server's thread, then ``reqs`` [(ids, kw)] are submitted from threads one after
    another (each queued before the next starts), the head is released, and
    every request waits for its result. Returns (results, wall seconds from
    the release to the last result)."""
    results, errors = [None] * len(reqs), []
    held.hold.clear()
    held.entered.clear()
    head = threading.Thread(target=lambda: srv.generate(reqs[0][0][:8], 1, timeout=600))
    head.start()
    held.entered.wait(60)

    def call(i):
        try:
            results[i] = srv.generate(reqs[i][0], T5_OUT, timeout=600, **reqs[i][1])
        except BaseException as e:  # noqa: BLE001 -- reported below
            errors.append(e)

    ts = [threading.Thread(target=call, args=(i,)) for i in range(len(reqs))]
    for i, t in enumerate(ts):
        t.start()
        while len(srv._mailbox) < i + 1:
            time.sleep(0.002)
    t0 = time.perf_counter()
    held.hold.set()
    for t in ts + [head]:
        t.join(600)
    if errors:
        raise errors[0]
    return results, time.perf_counter() - t0


def t5_step_profile(torch, engine, ids, lens, steps=8):
    """Where a T5 decode step goes at B = len(ids): ``steps`` decoder steps
    timed on the host clock, then as many under torch.profiler (kernel
    activity only). Returns (wall ms a step, device ms a step, rows)."""
    from fastertransformer4codefuse_tpu_torch.models import t5
    from fastertransformer4codefuse_tpu_torch.utils.profiling import summarize_trace, trace

    cfg, p = engine.config, engine.params
    enc = t5.encode(cfg, p, ids, lens)
    state = t5.init_decoder_state(cfg, p, enc, lens, 2 * steps + 2)
    tok = torch.zeros(len(ids), dtype=torch.long, device="cuda")
    t5.decode_step(cfg, p, state, tok, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(1, steps + 1):
        t5.decode_step(cfg, p, state, tok, t)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / steps * 1e3
    with trace(cpu=False) as prof:
        for t in range(steps + 1, 2 * steps + 1):
            t5.decode_step(cfg, p, state, tok, t)
    rows = [(name, ms / steps, n / steps) for name, ms, n, _ in summarize_trace(prof, top=0)]
    return wall, sum(r[1] for r in rows), rows


def phase_t5_3b(torch, pkg, kernels, launched):
    """T5-3B (google-t5/t5-3b: T5_LAYERS + T5_LAYERS of its 24 + 24 layers, 1024
    wide, 32 x 128 heads, FFN
    16384, vocab 32128) at full size on the card, int8 weights at HF's init
    scales, bf16 activations, served by a T5BatchingServer(max_batch=8): 8
    greedy requests (inputs 64-512 tokens, 64 out), 2 sampled (top_k 40,
    fixed seeds) and a group of 4 at beam width 4, queued in that order
    behind a held head request, the mix twice. Each greedy token is held to
    its step's argmax in a solo teacher-forced pass of the same engine
    (within NEAR_TIE of max |logits|), each sampled request must give equal
    bytes in both mixes, each beam is rescored teacher-forced (mean
    |dlogprob| a token under BEAM_NATS), and the server's batches are the
    coalescing rule's. Returns an error or None."""
    import gc

    from fastertransformer4codefuse_tpu_torch.engine.encoder_server import T5BatchingServer
    from fastertransformer4codefuse_tpu_torch.engine.t5_engine import T5Engine
    from fastertransformer4codefuse_tpu_torch.models import registry, t5
    from fastertransformer4codefuse_tpu_torch.models.params import param_bytes

    log(f"phase 9: T5-3B (google-t5/t5-3b, {T5_LAYERS} + {T5_LAYERS} of 24 + 24 layers, full "
        "width, int8 weights) behind a "
        "T5BatchingServer on the card")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = registry.get("t5").config_from_hf(hf_ns(T5_3B, num_layers=T5_LAYERS,
                                                   num_decoder_layers=T5_LAYERS))
    t0 = time.time()
    params = t5_random_params(torch, cfg, 0, "cuda", int8=True)
    torch.cuda.synchronize()
    dec_step_bytes = sum(param_bytes({k: v}) for k, v in params["dec"].items()
                         if k not in ("xk_w", "xv_w"))
    log(f"  params {param_bytes(params) / 2**30:.2f} GiB built in {time.time() - t0:.1f} s; the "
        f"weights a decoder step reads {dec_step_bytes / 1e9:.3f} GB (int8, cross K/V "
        f"projections excluded): {dec_step_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms at 3.35 TB/s")
    engine = T5Engine(cfg, params)
    V = cfg.vocab_size
    rng = np.random.default_rng(31)
    zero_counts(kernels)

    def timed(ids, n, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = engine.generate(ids, n, **kw)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3, engine.decode_forwards

    greedy_in = [rng.integers(2, V, n).tolist() for n in T5_GREEDY_LENS]
    timed([greedy_in[0]], 2)  # the first call's set-up
    # encode at B = 8, S = 512 (CUDA events, median of 3)
    ids8 = rng.integers(2, V, (8, 512))
    lens8 = np.full((8,), 512)
    enc_ms = []
    for _ in range(3):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        t5.encode(cfg, params, ids8, lens8)
        e1.record()
        e1.synchronize()
        enc_ms.append(e0.elapsed_time(e1))
    enc_ms = statistics.median(enc_ms)
    # decode ms/step at B = 1 and 8: 64 steps against 1, on the host clock
    step_ms = {}
    for label, batch in (("B=1", [greedy_in[1]]), ("B=8", greedy_in)):
        _, t1, f1 = timed(batch, 1, top_k=1)
        _, tn, fn = timed(batch, T5_OUT, top_k=1)
        step_ms[label] = (tn - t1) / max(fn - f1, 1)
    beam_in = [rng.integers(2, V, n).tolist() for n in T5_BEAM_LENS]
    _, t1, f1 = timed(beam_in, 1, beam_width=4)
    _, tn, fn = timed(beam_in, T5_OUT, beam_width=4)
    beam_ms = (tn - t1) / max(fn - f1, 1)
    wall, dev, rows = t5_step_profile(torch, engine, np.asarray([x[:64] for x in greedy_in]),
                                      np.full((8,), 64))
    log(f"  encode B=8 S=512 {enc_ms:.2f} ms; decode {step_ms['B=1']:.2f} ms/step at B=1, "
        f"{step_ms['B=8']:.2f} at B=8; beam (4 inputs x 4 beams) {beam_ms:.2f} ms/step "
        f"({CARD})")
    log(f"  a decode step at B=8 (profiled, 8 steps): wall {wall:.2f} ms, device kernels "
        f"{dev:.2f} ms ({dev / wall:.0%} busy); by kernel:")
    for name, ms, n in rows[:8]:
        log(f"    {ms:8.3f} ms {n:6.1f}x  {name[:90]}")
    err = check_run_counts(torch, kernels, launched, {}, "T5-3B engine (no JAX kernel on it)")
    if err:
        return err

    # the server: the mix twice behind a held head request
    sampled_in = [(rng.integers(2, V, n).tolist(), seed) for n, seed in T5_SAMPLED]
    reqs = ([(x, dict(top_k=1)) for x in greedy_in]
            + [(x, dict(top_k=40, random_seed=seed)) for x, seed in sampled_in]
            + [(x, dict(beam_width=4, length_penalty=1.0)) for x in beam_in])
    held = HeldEngine(torch, engine)
    srv = T5BatchingServer(held, max_batch=8, max_seq_len=512)
    zero_counts(kernels)
    try:
        mixes = [t5_serve_mix(torch, srv, held, reqs) for _ in range(2)]
        batches_run, served = srv.batches_run, srv.requests_served
    finally:
        srv.close()
    err = check_run_counts(torch, kernels, launched, {}, "T5-3B server mixes")
    if err:
        return err
    # the coalescing rule: the head alone, the 8 greedy, the 2 sampled (the
    # same statics, past max_batch), the 4 beams (other statics); twice
    want = [(1, 1, 1), (8, T5_OUT, 1), (2, T5_OUT, 1), (4, T5_OUT, 4)] * 2
    got = [b[:3] for b in held.batches]
    if got != want or batches_run != 8 or served != 2 * (len(reqs) + 1):
        return (f"server batches {got} ({batches_run} run, {served} served), expected {want} "
                f"(8 run, {2 * (len(reqs) + 1)} served)")
    (res1, wall1), (res2, wall2) = mixes
    # sampled: equal bytes in both mixes, and each token inside its step's
    # top 40 of a teacher-forced pass of the two (within NEAR_TIE of the 40th
    # logit)
    sampled = [res1[i].output_ids[0, :int(res1[i].sequence_lengths[0])].tolist() for i in (8, 9)]
    sampled_lg = forced_logits(torch, t5, cfg, params, [x for x, _ in sampled_in], sampled)
    for i, toks, lg in zip((8, 9), sampled, sampled_lg):
        if not np.array_equal(res1[i].output_ids, res2[i].output_ids):
            return f"sampled request {i - 8}: the two mixes differ"
        if min(toks) < 0 or max(toks) >= V:
            return "sampled ids out of range"
        kth = lg.topk(40, dim=-1).values[:, -1]
        below = (kth - lg.gather(1, torch.tensor(toks, device="cuda")[:, None])[:, 0]) \
            / lg.abs().amax(-1)
        if float(below.max()) >= NEAR_TIE:
            return f"sampled request {i - 8}: a token outside its step's top 40"
    # greedy: each token within NEAR_TIE of its step's argmax, solo and
    # teacher-forced through the same engine
    off, worst, distinct = [], 0.0, set()
    for i in range(8):
        n = int(res1[i].sequence_lengths[0])
        toks = res1[i].output_ids[0, :n].tolist()
        distinct.update(toks)
        g = gaps_to_argmax(torch, forced_logits(torch, t5, cfg, params, [greedy_in[i]], [toks])[0],
                           toks)
        off.append(int((g > 0).sum()))
        worst = max(worst, float(g.max()))
        if g.max() >= NEAR_TIE:
            return (f"greedy request {i}: a token lies {g.max():.2e} of max |logits| below its "
                    f"step's argmax (limit {NEAR_TIE:g})")
    # beams: rescored teacher-forced, each beam's log-prob sum against its
    # score times its length (length_penalty 1)
    # (the 16 beams of the 4 requests in one pass of 16 rows)
    beams = [(x, res1[10 + j], k) for j, x in enumerate(beam_in) for k in range(4)]
    rows = [r.output_ids[k, :int(r.sequence_lengths[k])].tolist() for _, r, k in beams]
    diffs = []
    for (_, r, k), toks, lg in zip(beams, rows, forced_logits(
            torch, t5, cfg, params, [x for x, _, _ in beams], rows)):
        lp = torch.log_softmax(lg, -1).gather(1, torch.tensor(toks, device="cuda")[:, None])
        diffs.append(abs(float(lp.sum()) - float(r.scores[k]) * len(toks)) / len(toks))
    d = np.asarray(diffs)
    zero_counts(kernels)  # the checks' passes are not the served path
    log(f"  server (max_batch 8): {len(reqs)} requests x2 in {batches_run} batches, "
        f"{[b[:3] for b in held.batches[:4]]} each time; {len(reqs) / wall1:.2f} and "
        f"{len(reqs) / wall2:.2f} requests/s; batch walls "
        + ", ".join(f"{b[3]:.0f} ms ({b[4]} steps)" for b in held.batches[:4]) + f" ({CARD})")
    log(f"  greedy tokens ({len(distinct)} distinct ids over the 8 requests) vs the solo "
        f"teacher-forced argmax: "
        f"{', '.join(map(str, off))} of each request's steps off, largest gap {worst:.2e} "
        f"(limit {NEAR_TIE:g}); sampled x2: equal bytes; beams rescored: |dlogprob| mean "
        f"{d.mean():.2e}, max {d.max():.2e} nats a token (limit {BEAM_NATS} mean)")
    if not np.isfinite(d).all() or d.mean() > BEAM_NATS:
        return "beams: the scores disagree with their rescoring"
    log(f"  T5-3B: peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"({CARD})")
    del engine, params, held, srv
    gc.collect()
    torch.cuda.empty_cache()
    return None


def random_sd(torch, shapes, seed, std=0.02, norms=(), ints=None):
    """A state dict of ``shapes`` drawn N(0, ``std``) on the card from
    ``seed`` and moved to the CPU; names ending in one of ``norms`` ("weight"
    of a norm) are near 1; ``ints`` adds integer buffers as they are."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    sd = {}
    for name, shape in shapes.items():
        t = torch.empty(shape, device="cuda").normal_(0.0, std, generator=gen)
        if any(name.endswith(n) for n in norms):
            t += 1.0
        sd[name] = t.cpu()
    sd.update(ints or {})
    return sd


def bart_shapes(hf, layers, marian):
    """HF names and shapes of a BART / Marian checkpoint of ``layers`` +
    ``layers`` layers (Marian without embedding LayerNorms; its position
    table is added apart)."""
    D, F_, V, P = hf["d_model"], hf["encoder_ffn_dim"], hf["vocab_size"], hf["max_position_embeddings"]
    out = {"model.shared.weight": (V, D), "final_logits_bias": (1, V)}
    for side in ("encoder", "decoder"):
        if not marian:
            out[f"model.{side}.embed_positions.weight"] = (P + 2, D)
            out[f"model.{side}.layernorm_embedding.weight"] = (D,)
            out[f"model.{side}.layernorm_embedding.bias"] = (D,)
        for i in range(layers):
            a = f"model.{side}.layers.{i}."
            attns = ["self_attn"] + (["encoder_attn"] if side == "decoder" else [])
            for at in attns:
                for pr in ("q_proj", "k_proj", "v_proj", "out_proj"):
                    out[f"{a}{at}.{pr}.weight"] = (D, D)
                    out[f"{a}{at}.{pr}.bias"] = (D,)
                out[f"{a}{at}_layer_norm.weight"] = (D,)
                out[f"{a}{at}_layer_norm.bias"] = (D,)
            out.update({f"{a}fc1.weight": (F_, D), f"{a}fc1.bias": (F_,),
                        f"{a}fc2.weight": (D, F_), f"{a}fc2.bias": (D,),
                        f"{a}final_layer_norm.weight": (D,), f"{a}final_layer_norm.bias": (D,)})
    return out


def marian_positions(torch, n, dim):
    """HF MarianSinusoidalPositionalEmbedding's table [n, dim]: sines in the
    first half of the columns, cosines in the second."""
    pos = np.arange(n, dtype=np.float64)[:, None]
    enc = pos / np.power(10000, 2 * (np.arange(dim) // 2) / dim)[None, :]
    half = dim // 2 + dim % 2
    out = np.zeros((n, dim))
    out[:, :half] = np.sin(enc[:, 0::2])
    out[:, half:] = np.cos(enc[:, 1::2])
    return torch.from_numpy(out.astype(np.float32))


def phase_seq2seq_reduced(torch, pkg, kernels, launched):
    """T5-3B's width (int8 and bf16 weights), BART-large and Marian (en-de)
    at their published widths with 2 + 2 layers, card (bf16 activations)
    against the port on the CPU (fp32, plain): decoder logits of 4
    teacher-forced steps on a ragged batch within SEQ_TOL, greedy tokens
    equal past NEAR_TIE (``s2s_card_vs_cpu``); 0 kernel launches. Returns an
    error or None."""
    from fastertransformer4codefuse_tpu_torch.models import bart, registry, t5
    from fastertransformer4codefuse_tpu_torch.models.params import params_to

    log("phase 9b: T5-3B width (int8, bf16), BART-large and Marian (opus-mt-en-de) at published "
        "widths, 2 + 2 layers, card vs CPU")
    rng = np.random.default_rng(41)
    cases = []
    t5cfg = registry.get("t5").config_from_hf(hf_ns(T5_3B, num_layers=2, num_decoder_layers=2))
    for label, int8 in (("T5-3B width int8", True), ("T5-3B width bf16", False)):
        cases.append((label, t5, t5cfg, lambda int8=int8: t5_random_params(
            torch, t5cfg, 5, "cuda", int8=int8)))
    for label, fam, hf in (("BART-large", "bart", BART_LARGE), ("Marian en-de", "marian",
                                                                  MARIAN_EN_DE)):
        cfg = registry.get(fam).config_from_hf(hf_ns(hf, encoder_layers=2, decoder_layers=2))

        def build(fam=fam, hf=hf, cfg=cfg):
            marian = fam == "marian"
            sd = random_sd(torch, bart_shapes(hf, 2, marian), 7,
                           norms=("layer_norm.weight", "layernorm_embedding.weight"))
            if marian:
                pos = marian_positions(torch, hf["max_position_embeddings"], hf["d_model"])
                sd["model.encoder.embed_positions.weight"] = pos
                sd["model.decoder.embed_positions.weight"] = pos
            return registry.get(fam).params_from_hf(cfg, sd, "bf16", device="cuda")
        cases.append((label, bart, cfg, build))
    for label, mod, cfg, build in cases:
        t0 = time.time()
        p_card = build()
        p_cpu = params_to(p_card, "cpu", dtype="fp32")
        inputs = [rng.integers(2, cfg.vocab_size, n).tolist() for n in (300, 171)]
        zero_counts(kernels)
        err, rels, ties = s2s_card_vs_cpu(torch, mod, cfg, p_card, p_cpu, inputs)
        cerr = check_run_counts(torch, kernels, launched, {}, f"{label} (no JAX kernel on it)")
        log(f"  {label} ({cfg.head_num} x {cfg.size_per_head}, FFN {cfg.inter_size}, vocab "
            f"{cfg.vocab_size}; {time.time() - t0:.1f} s): logits of 4 teacher-forced steps "
            f"{', '.join(f'{r:.2e}' for r in rels)} (tol {SEQ_TOL:g}); greedy == CPU's over 16 "
            f"tokens of inputs of 300 and 171"
            f"{' (near-ties, then teacher-forced: ' + '; '.join(ties) + ')' if ties else ''}")
        if err or cerr:
            return f"{label}: {err or cerr}"
        del p_card, p_cpu
    return None


def encoder_shapes(family, hf):
    """HF names and shapes of ``family``'s encoder checkpoint at ``hf``'s
    widths and depth, and its integer buffers (Swin's relative-position
    index, as HF builds it)."""
    import torch

    out, ints = {}, {}
    if family == "vit":
        H, F_, P, C = hf["hidden_size"], hf["intermediate_size"], hf["patch_size"], hf["num_channels"]
        n = (hf["image_size"] // P) ** 2 + 1
        out.update({"embeddings.cls_token": (1, 1, H), "embeddings.position_embeddings": (1, n, H),
                    "embeddings.patch_embeddings.projection.weight": (H, C, P, P),
                    "embeddings.patch_embeddings.projection.bias": (H,),
                    "layernorm.weight": (H,), "layernorm.bias": (H,),
                    "pooler.dense.weight": (H, H), "pooler.dense.bias": (H,)})
        for i in range(hf["num_hidden_layers"]):
            a = f"encoder.layer.{i}."
            for n_ in ("query", "key", "value"):
                out[f"{a}attention.attention.{n_}.weight"] = (H, H)
                out[f"{a}attention.attention.{n_}.bias"] = (H,)
            out.update({f"{a}attention.output.dense.weight": (H, H),
                        f"{a}attention.output.dense.bias": (H,),
                        f"{a}layernorm_before.weight": (H,), f"{a}layernorm_before.bias": (H,),
                        f"{a}layernorm_after.weight": (H,), f"{a}layernorm_after.bias": (H,),
                        f"{a}intermediate.dense.weight": (F_, H),
                        f"{a}intermediate.dense.bias": (F_,),
                        f"{a}output.dense.weight": (H, F_), f"{a}output.dense.bias": (H,)})
    elif family == "swin":
        E, P, M = hf["embed_dim"], hf["patch_size"], hf["window_size"]
        out.update({"embeddings.patch_embeddings.projection.weight": (E, hf["num_channels"], P, P),
                    "embeddings.patch_embeddings.projection.bias": (E,),
                    "embeddings.norm.weight": (E,), "embeddings.norm.bias": (E,)})
        coords = torch.stack(torch.meshgrid(torch.arange(M), torch.arange(M), indexing="ij"))
        flat = coords.flatten(1)
        rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0).contiguous()
        rel[:, :, 0] += M - 1
        rel[:, :, 1] += M - 1
        rel[:, :, 0] *= 2 * M - 1
        index = rel.sum(-1)
        C = E
        for si, (depth, nH) in enumerate(zip(hf["depths"], hf["num_heads"])):
            F_ = int(C * hf["mlp_ratio"])
            for bi in range(depth):
                a = f"encoder.layers.{si}.blocks.{bi}."
                for n_ in ("query", "key", "value"):
                    out[f"{a}attention.self.{n_}.weight"] = (C, C)
                    out[f"{a}attention.self.{n_}.bias"] = (C,)
                out.update({f"{a}attention.self.relative_position_bias_table":
                            ((2 * M - 1) ** 2, nH),
                            f"{a}attention.output.dense.weight": (C, C),
                            f"{a}attention.output.dense.bias": (C,),
                            f"{a}layernorm_before.weight": (C,), f"{a}layernorm_before.bias": (C,),
                            f"{a}layernorm_after.weight": (C,), f"{a}layernorm_after.bias": (C,),
                            f"{a}intermediate.dense.weight": (F_, C),
                            f"{a}intermediate.dense.bias": (F_,),
                            f"{a}output.dense.weight": (C, F_), f"{a}output.dense.bias": (C,)})
                ints[f"{a}attention.self.relative_position_index"] = index
            if si < len(hf["depths"]) - 1:
                d = f"encoder.layers.{si}.downsample."
                out.update({d + "reduction.weight": (2 * C, 4 * C), d + "norm.weight": (4 * C,),
                            d + "norm.bias": (4 * C,)})
                C *= 2
        out.update({"layernorm.weight": (C,), "layernorm.bias": (C,)})
    elif family == "deberta":
        H, F_ = hf["hidden_size"], hf["intermediate_size"]
        out.update({"embeddings.word_embeddings.weight": (hf["vocab_size"], H),
                    "embeddings.LayerNorm.weight": (H,), "embeddings.LayerNorm.bias": (H,),
                    "encoder.rel_embeddings.weight": (2 * hf["position_buckets"], H),
                    "encoder.LayerNorm.weight": (H,), "encoder.LayerNorm.bias": (H,)})
        for i in range(hf["num_hidden_layers"]):
            a = f"encoder.layer.{i}."
            for n_ in ("query_proj", "key_proj", "value_proj"):
                out[f"{a}attention.self.{n_}.weight"] = (H, H)
                out[f"{a}attention.self.{n_}.bias"] = (H,)
            out.update({f"{a}attention.output.dense.weight": (H, H),
                        f"{a}attention.output.dense.bias": (H,),
                        f"{a}attention.output.LayerNorm.weight": (H,),
                        f"{a}attention.output.LayerNorm.bias": (H,),
                        f"{a}intermediate.dense.weight": (F_, H),
                        f"{a}intermediate.dense.bias": (F_,),
                        f"{a}output.dense.weight": (H, F_), f"{a}output.dense.bias": (H,),
                        f"{a}output.LayerNorm.weight": (H,), f"{a}output.LayerNorm.bias": (H,)})
    elif family == "xlnet":
        D, nH, dh, F_ = hf["d_model"], hf["n_head"], hf["d_head"], hf["d_inner"]
        out["word_embedding.weight"] = (hf["vocab_size"], D)
        for i in range(hf["n_layer"]):
            a = f"layer.{i}."
            for n_ in ("q", "k", "v", "o", "r"):
                out[f"{a}rel_attn.{n_}"] = (D, nH, dh)
            for n_ in ("r_w_bias", "r_r_bias", "r_s_bias"):
                out[f"{a}rel_attn.{n_}"] = (nH, dh)
            out.update({f"{a}rel_attn.seg_embed": (2, nH, dh),
                        f"{a}rel_attn.layer_norm.weight": (D,), f"{a}rel_attn.layer_norm.bias": (D,),
                        f"{a}ff.layer_1.weight": (F_, D), f"{a}ff.layer_1.bias": (F_,),
                        f"{a}ff.layer_2.weight": (D, F_), f"{a}ff.layer_2.bias": (D,),
                        f"{a}ff.layer_norm.weight": (D,), f"{a}ff.layer_norm.bias": (D,)})
    elif family == "conformer":
        H, F_, K = hf["hidden_size"], hf["intermediate_size"], hf["conv_depthwise_kernel_size"]
        nH = hf["num_attention_heads"]
        cin = 1
        for li, (c, k) in enumerate(zip(hf["conv_dim"], hf["conv_kernel"])):
            f = f"feature_extractor.conv_layers.{li}."
            out.update({f + "conv.weight": (c, cin, k), f + "conv.bias": (c,),
                        f + "layer_norm.weight": (c,), f + "layer_norm.bias": (c,)})
            cin = c
        out.update({"feature_projection.layer_norm.weight": (cin,),
                    "feature_projection.layer_norm.bias": (cin,),
                    "feature_projection.projection.weight": (H, cin),
                    "feature_projection.projection.bias": (H,),
                    "encoder.layer_norm.weight": (H,), "encoder.layer_norm.bias": (H,)})
        for i in range(hf["num_hidden_layers"]):
            a = f"encoder.layers.{i}."
            for w in ("ffn1", "ffn2"):
                out.update({f"{a}{w}_layer_norm.weight": (H,), f"{a}{w}_layer_norm.bias": (H,),
                            f"{a}{w}.intermediate_dense.weight": (F_, H),
                            f"{a}{w}.intermediate_dense.bias": (F_,),
                            f"{a}{w}.output_dense.weight": (H, F_),
                            f"{a}{w}.output_dense.bias": (H,)})
            for n_ in ("linear_q", "linear_k", "linear_v", "linear_out"):
                out[f"{a}self_attn.{n_}.weight"] = (H, H)
                out[f"{a}self_attn.{n_}.bias"] = (H,)
            cm = a + "conv_module."
            out.update({f"{a}self_attn.linear_pos.weight": (H, H),
                        f"{a}self_attn.pos_bias_u": (nH, H // nH),
                        f"{a}self_attn.pos_bias_v": (nH, H // nH),
                        f"{a}self_attn_layer_norm.weight": (H,),
                        f"{a}self_attn_layer_norm.bias": (H,),
                        cm + "layer_norm.weight": (H,), cm + "layer_norm.bias": (H,),
                        cm + "pointwise_conv1.weight": (2 * H, H, 1),
                        cm + "depthwise_conv.weight": (H, 1, K),
                        cm + "batch_norm.weight": (H,), cm + "batch_norm.bias": (H,),
                        cm + "batch_norm.running_mean": (H,),
                        cm + "batch_norm.running_var": (H,),
                        cm + "pointwise_conv2.weight": (H, H, 1),
                        f"{a}final_layer_norm.weight": (H,), f"{a}final_layer_norm.bias": (H,)})
    return out, ints


def encoder_inputs(family, hf, rng):
    """(args of ``encode`` after config and params, real-row mask [B, S] or
    None) of phase 9's workload of ``family``."""
    if family in ("vit", "swin"):
        return (rng.standard_normal((8, 3, 224, 224)).astype(np.float32),), None
    if family == "conformer":
        return ((rng.standard_normal((2, 160000)) * 0.1).astype(np.float32),), None
    vocab = hf["vocab_size"]
    ids = rng.integers(2, vocab, (2, 512))
    lens = np.array([512, 300])
    return (ids, lens), np.arange(512)[None, :] < lens[:, None]


# (label, registry family, published config, layers run on the card and the CPU)
SEQ_ENCODERS = [
    ("ViT-B/16 (google/vit-base-patch16-224), B=8 224x224", "vit", VIT_B16, None),
    ("Swin-T (microsoft/swin-tiny-patch4-window7-224), B=8 224x224", "swin", SWIN_T, None),
    ("DeBERTa-v3-base (microsoft/deberta-v3-base), B=2 S=512 lengths 512/300", "deberta",
     DEBERTA_V3_BASE, None),
    ("XLNet-base-cased, B=2 S=512 lengths 512/300", "xlnet", XLNET_BASE, None),
    ("Conformer (facebook/wav2vec2-conformer-rel-pos-large), B=2 x 10 s of 16 kHz", "conformer",
     CONFORMER_LARGE, None),
]


def phase_seq_encoders(torch, kernels, launched):
    """The five encoders at published widths (SEQ_ENCODERS), random weights
    under HF's names through the registry's converters: the card (bf16
    weights; the activations bf16 for the text encoders, and for ViT, Swin
    and the Conformer the dtype of their fp32 pixels and audio, as in the
    JAX package) against the CPU (fp32), max |dhidden| / max |hidden| over
    the real rows within SEQ_TOL, and two card encodes equal bytes;
    encodes/s on the card (CUDA events, median of 3 after a warm-up); 0
    kernel launches. Returns an error or None."""
    import gc

    from fastertransformer4codefuse_tpu_torch.models import registry
    from fastertransformer4codefuse_tpu_torch.models.params import param_bytes, params_to

    log("phase 9d: ViT-B/16, Swin-T, DeBERTa-v3-base, XLNet-base and the Conformer (large) at "
        "published widths, card vs CPU")
    rng = np.random.default_rng(43)
    norms = ("LayerNorm.weight", "layer_norm.weight", "layernorm.weight", "norm.weight",
             "layernorm_before.weight", "layernorm_after.weight", "running_var")
    for label, family, hf, layers in SEQ_ENCODERS:
        t0 = time.time()
        if layers:
            hf = dict(hf, **{("n_layer" if family == "xlnet" else "num_hidden_layers"): layers})
        fam = registry.get(family)
        cfg = fam.config_from_hf(hf_ns(hf))
        shapes, ints = encoder_shapes(family, hf)
        sd = random_sd(torch, shapes, 17, norms=norms, ints=ints)
        p_cpu = fam.params_from_hf(cfg, sd, "fp32", device="cpu")
        p_card = params_to(p_cpu, "cuda", dtype="bf16")
        args, real = encoder_inputs(family, hf, rng)
        zero_counts(kernels)
        h_card = fam.encode(cfg, p_card, *args)[0]
        h_again = fam.encode(cfg, p_card, *args)[0]
        ms = []
        for _ in range(3):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            fam.encode(cfg, p_card, *args)
            e1.record()
            e1.synchronize()
            ms.append(e0.elapsed_time(e1))
        err = check_run_counts(torch, kernels, launched, {}, f"{family} (no JAX kernel on it)")
        if err:
            return err
        t1 = time.time()
        h_cpu = fam.encode(cfg, p_cpu, *args)[0]
        cpu_s = time.time() - t1
        act = str(h_card.dtype).replace("torch.", "")
        h_card = h_card.float().cpu()
        mask = torch.ones(h_card.shape[:2], dtype=torch.bool) if real is None \
            else torch.from_numpy(real)
        rel = rel_err(torch, h_card[mask], h_cpu[mask])[1]
        same = torch.equal(h_card, h_again.float().cpu())
        B = args[0].shape[0]
        log(f"  {label}: {cfg.layer_num if hasattr(cfg, 'layer_num') else sum(cfg.depths)} "
            f"layers, {param_bytes(p_card) / 2**30:.2f} GiB (bf16), {act} activations; hidden "
            f"{tuple(h_card.shape)} "
            f"max |dhidden| / max |hidden| {rel:.2e} (tol {SEQ_TOL:g}); two card encodes "
            f"{'equal bytes' if same else 'DIFFER'}; card {statistics.median(ms):.2f} ms an "
            f"encode = {B / statistics.median(ms) * 1e3:.1f} encodes/s ({CARD}); CPU side "
            f"{cpu_s:.1f} s; {time.time() - t0:.1f} s in all")
        if not bool(torch.isfinite(h_card).all()) or rel >= SEQ_TOL:
            return f"{label}: card and CPU hidden states disagree ({rel:.2e})"
        if not same:
            return f"{label}: two encodes on the card differ"
        del p_cpu, p_card, sd
        gc.collect()
        torch.cuda.empty_cache()
    return None


def phase_seq2seq(torch, pkg, kernels, launched):
    """Phase 9: the encoder-decoder, vision and audio families, none of
    which reaches a JAX kernel (every path launches 0 kernels and takes no
    plain attention route): T5-3B at full size behind a T5BatchingServer
    (``phase_t5_3b``), the 2 + 2-layer encoder-decoders card vs CPU
    (``phase_seq2seq_reduced``), the five encoders (``phase_seq_encoders``).
    Returns an error or None."""
    t0 = time.time()
    for fn in (phase_t5_3b, phase_seq2seq_reduced):
        err = fn(torch, pkg, kernels, launched)
        if err:
            return err
    err = phase_seq_encoders(torch, kernels, launched)
    log(f"  phase 9: {time.time() - t0:.1f} s")
    return err



# Phase 10: tensor parallelism. CodeFuse-13B at full width (40 heads x 128,
# FFN 20480, vocab 100831 padded to 100832 for tp = 2; int8 weights and
# embeddings, int8 KV) and TP_LAYERS deep, served by two ranks of a gloo
# group on the one card (NCCL refuses two ranks on one device), beside a
# tp = 1 engine over the same weights on rank 0
TP_LAYERS = 4
TP_PROMPTS = (1000, 992)  # the static batch, B = 2
TP_TOKENS = 16
TP_POOL_PROMPTS = (900, 130, 500, 300)
TP_POOL_OUTS = (16, 24, 16, 32)
TP_POOL = dict(max_slots=4, max_seq_len=1024, prompt_bucket=128,
               paged=dict(num_pages=17, page_size=256))
# seconds for the whole phase and for any one collective: the phase took
# ~15-25 s before its served runs, and starts ~600 s into the script's
# 1200 s, so a hung rank fails here with a message rather than at the
# script's limit
TP_TIMEOUT = 180
# the served run of phase 10: a pooled handler on rank 0 (rank 1 follows)
# with TP_POOL's paged class and a beam class of width 2; its clients send
# TP_POOL_PROMPTS, a streamed request, a sampled one with neither seed nor
# top_k, one too long for either class (the static route) and a beam
# request, TP_STAGGER s apart
TP_BEAM_POOL = dict(max_slots=1, max_seq_len=512, prompt_bucket=128, beam_width=2)
TP_SERVED = (("streamed", 200, 16), ("sampled", 100, 16), ("static", 1000, 40),
             ("beam", 300, 16))
TP_STAGGER = 0.05
TP_BERT_LENS = (32, 512, 130, 300, 77, 200)  # the served int8 BERT-base requests


def tp_forced_logits(torch, engine, prompts, forced):
    """[B, n, V] fp32 on the CPU: the logits after the prefill of
    ``prompts`` and after each decode step that takes ``forced`` [B, n]'s
    token of the step before (teacher-forced): one prefill and n - 1 decode
    forwards of the engine's own program."""
    from fastertransformer4codefuse_tpu_torch.ops.rotary import make_rotary_tables

    cfg, n = engine.config, forced.shape[1]
    st, inputs = engine._prepare(prompts, n, top_k=1)
    s = engine._prefill_state(st, inputs)
    rot = make_rotary_tables(st.total_len, cfg.rotary_embedding_dim, cfg.rotary_base,
                             engine.device)
    rows = torch.arange(len(prompts), device=engine.device)
    f = torch.as_tensor(forced, dtype=torch.int32, device=engine.device)
    out = [s.logits.float().cpu()]
    for j in range(n - 1):
        s.tokens[rows, s.seq_lens.long()] = f[:, j]
        s.seq_lens = s.seq_lens + 1
        engine._forward_newest(s, rot)
        out.append(s.logits.float().cpu())
    return torch.stack(out, 1)


def tp_rank(rank, port, results):
    """A rank of phase 10 (a spawned process): its results, or the
    traceback, on ``results``."""
    try:
        res = _tp_rank(rank, port)
    except BaseException:  # noqa: BLE001 - the parent reports it
        import traceback

        res = {"error": traceback.format_exc()}
    results.put((rank, res))


def _tp_rank(rank, port):
    import torch
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    import fastertransformer4codefuse_tpu_torch as pkg
    from fastertransformer4codefuse_tpu_torch.engine import kv_cache
    from fastertransformer4codefuse_tpu_torch.engine.batcher import ContinuousBatcher
    from fastertransformer4codefuse_tpu_torch.models.params import param_bytes
    from fastertransformer4codefuse_tpu_torch.ops import _cuda
    from fastertransformer4codefuse_tpu_torch.ops.attention import prefill_attention
    from fastertransformer4codefuse_tpu_torch.parallel import distributed as pd
    from fastertransformer4codefuse_tpu_torch.parallel.sharding import build_mesh

    global ROUTERS
    ROUTERS = (prefill_attention, kv_cache.attend_chunk, kv_cache.attend_decode)
    torch.backends.cuda.matmul.allow_tf32 = False
    _cuda.lib()  # built by the parent
    pd.init_distributed(f"127.0.0.1:{port}", 2, rank, backend="gloo", timeout_s=TP_TIMEOUT)
    mesh = build_mesh(tp=2)
    kernels = kernel_table()
    ar, ag = pd.all_reduce, pd.all_gather
    cfg = pkg.GptNeoXConfig(**{**pkg.GptNeoXConfig.codefuse_13b().__dict__,
                               "layer_num": TP_LAYERS})
    L, V = cfg.layer_num, cfg.vocab_size
    params = pkg.init_params(cfg, seed=0, dtype="bf16", int8_mode=1, quantize_embeddings=True,
                             device="cuda")
    rt = pkg.RuntimeConfig(dtype="bf16", int8_mode=1, kv_cache_dtype="int8")
    eng2 = pkg.GptNeoXEngine(cfg, params, rt, mesh=mesh)
    eng1 = pkg.GptNeoXEngine(cfg, params, rt) if rank == 0 else None
    out = {"backend": dist.get_backend(), "full_gib": param_bytes(params) / 2**30,
           "shard_gib": param_bytes(eng2.params) / 2**30,
           "head_rows": int(eng2.params["lm_head"].q.shape[0])}
    del params
    rng = np.random.default_rng(10)
    prompts = [rng.integers(0, V, n).tolist() for n in TP_PROMPTS]

    def timed(engine, n):
        if engine is eng2:
            dist.barrier()
        torch.cuda.synchronize()
        t = time.time()
        g = engine.generate(prompts, n, top_k=1)
        torch.cuda.synchronize()
        return g, time.time() - t, engine.decode_forwards

    def counted(fn):
        """fn's result, its kernel launches and counted collectives."""
        zero_counts(kernels)
        ar.calls = ag.calls = 0
        res = fn()
        torch.cuda.synchronize()
        return res, read_counts(kernels), (ar.calls, ag.calls)

    # the static greedy batch under tp = 2, then its times (a prefill alone,
    # the whole call), the same on the tp = 1 engine while rank 1 waits
    (g2, _, f2), out["static_counts"], out["static_coll"] = counted(
        lambda: timed(eng2, TP_TOKENS))
    out["static_ids"], out["static_forwards"] = g2.output_ids, f2
    _, t_pre, _ = timed(eng2, 1)
    _, t_all, f = timed(eng2, TP_TOKENS)
    out["tp2_ms"] = (t_pre * 1e3, (t_all - t_pre) / max(f, 1) * 1e3)
    forced = None
    if rank == 0:
        g1, _, _ = timed(eng1, TP_TOKENS)
        out["tp1_ids"] = g1.output_ids
        _, t_pre, _ = timed(eng1, 1)
        _, t_all, f = timed(eng1, TP_TOKENS)
        out["tp1_ms"] = (t_pre * 1e3, (t_all - t_pre) / max(f, 1) * 1e3)
        forced = np.stack([g1.output_ids[b, 0, n:n + TP_TOKENS]
                           for b, n in enumerate(TP_PROMPTS)])
    box = [forced]
    dist.broadcast_object_list(box, src=0)
    forced = box[0]
    # teacher-forced logits of both programs on the tp = 1 tokens
    lg2, out["forced_counts"], out["forced_coll"] = counted(
        lambda: tp_forced_logits(torch, eng2, prompts, forced))
    if rank == 0:
        lg1 = tp_forced_logits(torch, eng1, prompts, forced)
        out["forced_rel"] = [((lg2[:, j] - lg1[:, j]).abs().max()
                              / lg1[:, j].abs().max()).item() for j in range(TP_TOKENS)]
        # the greedy runs' first parting, read on the tp = 1 teacher-forced logits
        out["parting"] = []
        for b, n in enumerate(TP_PROMPTS):
            a, c = g2.output_ids[b, 0, n:n + TP_TOKENS], forced[b]
            i = next((i for i in range(TP_TOKENS) if a[i] != c[i]), None)
            if i is not None:
                lg = lg1[b, i]
                out["parting"].append(
                    (b, i, int(a[i]), int(c[i]),
                     ((lg[int(c[i])] - lg[int(a[i])]) / lg.abs().max()).item()))
    del lg2

    # a paged pool of 4 requests, driven in lockstep by both ranks
    pool_prompts = [rng.integers(0, V, n).tolist() for n in TP_POOL_PROMPTS]

    def drive():
        cb = ContinuousBatcher(eng2, **TP_POOL)
        uids = [cb.submit(p, n, top_k=1) for p, n in zip(pool_prompts, TP_POOL_OUTS)]
        ticks = []  # (chunk steps, decode steps, all-reduces, all-gathers) of each tick
        while cb.pending or cb.running:
            ar.calls = ag.calls = 0
            c0, d0 = cb.chunk_ticks, cb.decode_ticks
            cb.step()
            ticks.append((cb.chunk_ticks - c0, cb.decode_ticks - d0, ar.calls, ag.calls))
        return cb, [cb.requests[u].output_ids[len(p):] for u, p in zip(uids, pool_prompts)], ticks

    dist.barrier()
    t = time.time()
    (cb, pool_out, ticks), out["pool_counts"], _ = counted(drive)
    out["pool_s"] = time.time() - t
    out["pool_expect"] = pool_launches(L, cb)
    out["pool_out"], out["pool_ticks"] = pool_out, ticks
    if rank == 0:  # each pool token held to the tp = 1 static program's argmax
        out["pool_gaps"] = [float(static_gaps(torch, eng1, p, g).max())
                            for p, g in zip(pool_prompts, pool_out)]
    del cb
    out["served"] = tp_served(torch, eng2, eng1, pool_prompts, kernels, rng)
    out["bert"] = tp_served_bert(torch, mesh, kernels)
    dist.barrier()
    dist.destroy_process_group()
    return out


class IdListTokenizer(IdTokenizer):
    """Token ids written out in decimal, space-separated; every id spelled
    out on the way back (``<id>``): the served runs' prompts are random ids
    of the whole vocabulary."""

    def encode(self, text):
        return [int(t) for t in text.split()]


def spelled_ids(text):
    """The ids of an ``IdListTokenizer`` decode."""
    return [int(t) for t in re.findall(r"<(\d+)>", text)]


def staggered(calls, gap):
    """Run each of ``calls`` on a thread of its own, the i-th ``gap`` * i s
    after the first; (results, errors as strings, wall s to the last)."""
    out, errors = [None] * len(calls), []

    def run(i):
        time.sleep(i * gap)
        try:
            out[i] = calls[i]()
        except Exception as e:  # noqa: BLE001 -- reported by the caller
            errors.append(f"request {i}: {e!r}")

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(calls))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    return out, errors, time.perf_counter() - t0


def served_counts(torch, kernels, ls, since, counters):
    """What a lockstep front end's run counted on this rank: each kernel's
    launches, the counted collectives, its rounds and the rounds published
    since ``since``, and what it served, sorted by uid (latency dropped)."""
    from fastertransformer4codefuse_tpu_torch.parallel import lockstep

    torch.cuda.synchronize()
    served = sorted(((u, {k: v for k, v in r.items() if k != "latency"}
                      if isinstance(r, dict) else r) for u, r in ls.served),
                    key=lambda x: x[0])
    return {"counts": read_counts(kernels), "coll": tuple(c.calls for c in counters),
            "rounds": ls.rounds.rounds, "publishes": lockstep.publish.calls - since,
            "served": served}


def count_ticks(ls, counters):
    """Record, from its next round on, each tick of the lockstep front end
    ``ls`` (a ``LockstepPools``): its chunk and decode steps over the pool
    classes and what ``counters`` counted in it, and each round's seconds
    in publishing and agreeing (``Rounds.control_s``) beside its tick's.
    Returns the lists it fills: (chunk steps, decode steps, (counts...))
    for each tick that stepped, and (control s, tick s) for each round that
    ticked."""
    ticks, times, tick = [], [], ls.rounds._tick

    def steps():
        return (sum(b.chunk_ticks for b in ls.batchers), sum(b.decode_ticks for b in ls.batchers))

    def counted():
        (c0, d0), n0 = steps(), [c.calls for c in counters]
        t0 = time.perf_counter()
        tick()
        times.append((ls.rounds.control_s, time.perf_counter() - t0))
        (c1, d1), n1 = steps(), [c.calls for c in counters]
        if (c1, d1) != (c0, d0):
            ticks.append((c1 - c0, d1 - d0, tuple(b - a for a, b in zip(n0, n1))))

    ls.rounds._tick = counted
    return ticks, times


def control_line(times):
    """The rounds' publish + agree seconds beside their ticks', as a log
    phrase: median and total of each."""
    ctl, tick = [c for c, _ in times], [t for _, t in times]
    return (f"publish + agree a round median {statistics.median(ctl) * 1e3:.3f} ms, total "
            f"{sum(ctl):.3f} s over {len(ctl)} rounds; the rounds' ticks median "
            f"{statistics.median(tick) * 1e3:.2f} ms, total {sum(tick):.2f} s")


def tp_served(torch, eng2, eng1, pool_prompts, kernels, rng):
    """Phase 10's served run, on each rank: ``CodeFuseHandler(pool=[TP_POOL,
    TP_BEAM_POOL])`` over the tp = 2 engine; rank 0's client threads send
    the requests, rank 1 follows. Returns what the rank served and counted,
    and on rank 0 the responses, what was streamed, the pooled and static
    greedy tokens' gaps to the tp = 1 static program's argmax, and the
    wall."""
    import torch.distributed as dist

    from fastertransformer4codefuse_tpu_torch.api.handler import CodeFuseHandler
    from fastertransformer4codefuse_tpu_torch.parallel import distributed as pd
    from fastertransformer4codefuse_tpu_torch.parallel import lockstep

    cfg, L = eng2.config, eng2.config.layer_num
    tok = IdListTokenizer()
    extra = {name: rng.integers(0, cfg.vocab_size, n).tolist() for name, n, _ in TP_SERVED}
    streamed = []
    counters = (pd.all_reduce, pd.all_gather)
    zero_counts(kernels)
    for c in counters:
        c.calls = 0
    since = lockstep.publish.calls
    h = CodeFuseHandler(engine=eng2, tokenizer=tok, warmup=False,
                        pool=[dict(TP_POOL), dict(TP_BEAM_POOL)],
                        on_stream_text=lambda b, j, text: streamed.append(text))
    ls = h.lockstep
    ls.served = []
    ticks, times = count_ticks(ls, counters)

    def text(ids):
        return " ".join(map(str, ids))

    reqs = [{"prompts": [{"prompt": text(p), "top_k": 1}], "out_seq_length": n}
            for p, n in zip(pool_prompts, TP_POOL_OUTS)]
    outs = {name: n for name, _, n in TP_SERVED}
    reqs += [
        {"prompts": [{"prompt": text(extra["streamed"]), "top_k": 1}],
         "out_seq_length": outs["streamed"], "stream": True},
        {"prompts": [{"prompt": text(extra["sampled"])}], "out_seq_length": outs["sampled"]},
        {"prompts": [{"prompt": text(extra["static"]), "top_k": 1}],
         "out_seq_length": outs["static"]},
        {"prompts": [{"prompt": text(extra["beam"]), "top_k": 1}],
         "out_seq_length": outs["beam"], "beam_width": 2},
    ]

    def predict(i):
        code, err, res = h.predict(reqs[i], f"served-{i}")
        if code:
            raise RuntimeError(err)
        return json.loads(res["res"])

    res = {}
    if ls.leader:
        got, errors, wall = staggered([lambda i=i: predict(i) for i in range(len(reqs))],
                                      TP_STAGGER)
        h.close()
        res.update(responses=got, errors=errors, wall=wall)
    else:
        h.follow()
    pools = ls.batchers
    res.update(served_counts(torch, kernels, ls, since, counters),
               ticks=[(b.chunk_ticks, b.decode_ticks) for b in pools], tick_counts=ticks,
               times=times, static_forwards=eng2.decode_forwards, streamed="".join(streamed),
               expect=add_counts(*(pool_launches(L, b) for b in pools),
                                 expected_launches(L, 1, eng2.decode_forwards, 8, 0)))
    if ls.leader and not res["errors"]:
        greedy = {**{i: p for i, p in enumerate(pool_prompts)}, 4: extra["streamed"]}
        records = [r for _, r in res["served"] if isinstance(r, dict) and "ids" in r]
        gaps = []
        for i, p in greedy.items():
            ids = next(r["ids"] for r in records if r["ids"][:len(p)] == p)
            gaps.append(float(static_gaps(torch, eng1, p, ids[len(p):]).max()))
        static = spelled_ids(res["responses"][6]["generated_code"][0][0])
        gaps.append(float(static_gaps(torch, eng1, extra["static"], static).max()))
        res["gaps"] = gaps
    del h, pools
    dist.barrier()
    return res


def tp_served_bert(torch, mesh, kernels):
    """Phase 10's served int8 BERT-base (12 layers, its published widths) at
    tp = 2 behind ``EncoderBatchingServer``: rank 0's client threads send
    TP_BERT_LENS requests, rank 1 follows. Returns the batches the rank ran
    and its launches, and on rank 0 each answer's max |d| / max |ref|
    against the tp = 1 encode of the same ids (padded alike)."""
    import torch.distributed as dist

    from fastertransformer4codefuse_tpu_torch.engine.encoder_server import EncoderBatchingServer
    from fastertransformer4codefuse_tpu_torch.models import registry

    cfg, _, params = encoder_params(torch, "bert", None, 42, int8=True)
    fam = registry.get("bert")
    eng = fam.make_engine(cfg, params, mesh=mesh)
    rng = np.random.default_rng(14)
    reqs = [rng.integers(0, cfg.vocab_size, n).tolist() for n in TP_BERT_LENS]
    batches, encode = [], eng.encode

    def logged(ids, lens):
        batches.append(np.asarray(lens).tolist())
        return encode(ids, lens)

    eng.encode = logged
    zero_counts(kernels)
    srv = EncoderBatchingServer(eng, max_batch=4, seq_bucket=32, max_seq_len=512)
    res = {}
    if srv.lockstep.leader:
        got, errors, wall = staggered([lambda r=r: srv.encode(r, timeout=300)[0] for r in reqs],
                                      0.0)
        srv.close()
        res.update(errors=errors, wall=wall)
    else:
        srv.follow()
    torch.cuda.synchronize()
    res.update(batches=batches, counts=read_counts(kernels), layers=cfg.layer_num,
               expect=bert_launches(cfg.layer_num, len(batches)))
    if srv.lockstep.leader and not errors:
        eng1 = fam.make_engine(cfg, params)
        rels = []
        for ids, h in zip(reqs, got):
            W = -(-len(ids) // 32) * 32
            padded = np.zeros((1, W), np.int32)
            padded[0, :len(ids)] = ids
            ref, _ = eng1.encode(padded, np.array([len(ids)], np.int32))
            rels.append(rel_err(torch, torch.from_numpy(h), ref[0, :len(ids)].float().cpu())[1])
        res["rels"] = rels
    del eng, params
    dist.barrier()
    return res


def phase_tp(torch, pkg, kernels, launched):
    """Phase 10: two ranks of CodeFuse-13B at tp = 2 on the one card, spawned
    after the parent built the kernels, each holding its half of the heads,
    the FFN and the vocab; a tp = 1 engine on rank 0 is the yardstick.
    Checks the static greedy batch (teacher-forced logits within 5e-2 of
    max |logits| of tp = 1's, greedy tokens equal past NEAR_TIE, both ranks'
    tokens byte-equal), the counted collectives (one all-reduce a layer a
    forward, one all-gather of the logits a forward), each rank's exact
    kernel launches, and a paged pool of 4 requests (each token within
    POOL_GAP of the tp = 1 static program's argmax). Returns an error or
    None."""
    import socket

    import torch.multiprocessing as mp

    log(f"phase 10: tensor parallelism, CodeFuse-13B int8 at full width, {TP_LAYERS} layers, "
        "tp = 2: two ranks of a gloo group on the one card")
    t0 = time.time()
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=tp_rank, args=(r, port, q)) for r in range(2)]
    for p in procs:
        p.start()
    res, deadline = {}, time.time() + TP_TIMEOUT
    try:
        while len(res) < 2:
            try:
                rank, r = q.get(timeout=5)
                res[rank] = r
            except queue.Empty:
                dead = [p.exitcode for p in procs if not p.is_alive()]
                if len(dead) > len(res) or time.time() > deadline:
                    return f"a rank ended without a result (exit codes {dead}) or timed out"
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    for rank in range(2):
        if "error" in res[rank]:
            return f"rank {rank}: {res[rank]['error']}"
    r0, r1 = res[0], res[1]
    L = TP_LAYERS
    log(f"  backend {r0['backend']} (both ranks: {r1['backend']}); {r0['full_gib']:.2f} GiB of "
        f"params, {r0['shard_gib']:.2f} GiB a rank; the head's {r0['head_rows']} vocab rows a "
        f"rank (100831 padded to {2 * r0['head_rows']})")
    if r0["backend"] != "gloo" or r1["backend"] != "gloo":
        return "phase 10 runs on gloo"
    # both ranks' tokens are the same bytes
    if not (np.array_equal(r0["static_ids"], r1["static_ids"])
            and r0["pool_out"] == r1["pool_out"]):
        return "the two ranks returned different tokens"
    # the counted collectives: one all-reduce a layer a forward, one
    # all-gather of the vocab slices a forward
    for name, (n_ar, n_ag), forwards in (("static generate", r0["static_coll"],
                                          1 + r0["static_forwards"]),
                                         ("teacher-forced run", r0["forced_coll"], TP_TOKENS)):
        log(f"  {name}: {n_ar} all-reduces, {n_ag} all-gathers over {forwards} forwards of "
            f"{L} layers")
        if (n_ar, n_ag) != (L * forwards, forwards):
            return f"{name}: collectives {(n_ar, n_ag)}, expected {(L * forwards, forwards)}"
    for chunks, decodes, n_ar, n_ag in r0["pool_ticks"]:
        if (n_ar, n_ag) != (L * (chunks + decodes), decodes):
            return f"a pool tick of {chunks} chunk and {decodes} decode steps ran " \
                   f"{(n_ar, n_ag)} collectives"
    # each rank's launches, exact
    runs = (("static generate", "static_counts",
             expected_launches(L, 1, r0["static_forwards"], 8, 0)),
            ("teacher-forced run", "forced_counts", expected_launches(L, 1, TP_TOKENS - 1, 8, 0)),
            ("paged pool", "pool_counts", r0["pool_expect"]))
    for rank, r in res.items():
        for label, key, expect in runs:
            want = {n: 0 for n in r[key]}
            want.update(expect)
            if r[key] != want:
                return f"rank {rank}, {label}: launches {r[key]}, expected {want}"
            for n in kernels:
                launched[n] += r[key][n]
    nonzero = {key: {n: c for n, c in r0[key].items() if c}
               for key in ("static_counts", "pool_counts")}
    log(f"  each rank's launches as expected: static {nonzero['static_counts']}, pool "
        f"{nonzero['pool_counts']} ({len(r0['pool_ticks'])} ticks)")
    rel = r0["forced_rel"]
    log(f"  teacher-forced logits, tp = 2 against tp = 1, max |d| / max |ref| after the prefill "
        f"and each step: {', '.join(f'{x:.2e}' for x in rel)} (tol 5e-2)")
    if max(rel) >= 5e-2:
        return "tp = 2 and tp = 1 logits disagree"
    same = [np.array_equal(r0["static_ids"][b, 0, n:n + TP_TOKENS],
                           r0["tp1_ids"][b, 0, n:n + TP_TOKENS]) for b, n in enumerate(TP_PROMPTS)]
    log(f"  greedy tokens, tp = 2 against tp = 1 (prompts of {list(TP_PROMPTS)} tokens, "
        f"{TP_TOKENS} each): equal {same}; partings (row, step, tp = 2, tp = 1, gap on the "
        f"tp = 1 logits): {r0['parting']}")
    far = [x for x in r0["parting"] if x[4] >= NEAR_TIE]
    if far:
        return f"tp = 2 greedy parts from tp = 1 past NEAR_TIE: {far}"
    gaps = r0["pool_gaps"]
    log(f"  paged pool (4 requests of {list(TP_POOL_PROMPTS)} tokens, pages of 256): tokens' "
        f"largest gap to the tp = 1 static argmax {', '.join(f'{g:.2e}' for g in gaps)} "
        f"(tol POOL_GAP {POOL_GAP:g}); {r0['pool_s']:.1f} s")
    if max(gaps) >= POOL_GAP:
        return "tp = 2 pool tokens part from the tp = 1 static program"
    err = check_tp_served(res, kernels, launched)
    if err:
        return err
    (p2, d2), (p1, d1) = r0["tp2_ms"], r0["tp1_ms"]
    log(f"  B = 2 prompts of {list(TP_PROMPTS)} tokens ({CARD}; two ranks share the card, so "
        f"these are no two-card times): tp = 2 prefill {p2:.1f} ms, decode {d2:.2f} ms/step; "
        f"tp = 1 prefill {p1:.1f} ms, decode {d1:.2f} ms/step")
    log(f"  phase 10: {time.time() - t0:.1f} s")
    return None



def check_tp_served(res, kernels, launched):
    """Phase 10's served runs, from both ranks' results: the handler's
    (every rank served the same tokens and seeds and published as many
    rounds as it ran; the counted collectives one all-reduce a layer and
    one all-gather a decode step or static forward; each rank's launches
    those of the pools' ticks and the static request; the greedy tokens
    within POOL_GAP of the tp = 1 static program's argmax; the stream is
    the streamed answer) and the int8 BERT-base server's (every rank ran
    rank 0's batches, four K1 GEMMs a layer a batch, each answer within 5e-2
    of the tp = 1 encode). Returns an error or None."""
    r0, r1 = res[0]["served"], res[1]["served"]
    if r0["errors"]:
        return f"served run: requests failed: {r0['errors']}"
    if r0["served"] != r1["served"] or r0["ticks"] != r1["ticks"]:
        return "served run: the two ranks served different tokens, seeds or ticks"
    L = TP_LAYERS
    for rank, r in res.items():
        s = r["served"]
        if s["publishes"] != s["rounds"]:
            return f"served run, rank {rank}: {s['publishes']} publishes for {s['rounds']} rounds"
        for c, d, coll in s["tick_counts"]:  # phase 10's formula, tick by tick
            if coll != (L * (c + d), d):
                return f"served run, rank {rank}: a tick of {c} chunk and {d} decode steps " \
                       f"ran {coll} collectives"
        steps = sum(c + d for c, d in s["ticks"]) + 1 + s["static_forwards"]
        want = (L * steps, sum(d for _, d in s["ticks"]) + 1 + s["static_forwards"])
        if s["coll"] != want or sum(c + d for c, d, _ in s["tick_counts"]) != steps - 1 - \
                s["static_forwards"]:
            return f"served run, rank {rank}: collectives {s['coll']}, expected {want}"
        expect = {n: 0 for n in s["counts"]}
        expect.update(s["expect"])
        if s["counts"] != expect:
            return f"served run, rank {rank}: launches {s['counts']}, expected {expect}"
        for n in kernels:
            launched[n] += s["counts"][n]
    resp = r0["responses"]
    sampled = resp[len(TP_POOL_PROMPTS) + 1]
    seeds = [rec["seed"] for _, rec in r1["served"] if isinstance(rec, dict) and "seed" in rec]
    if sampled["random_seed"][0] not in seeds:
        return "served run: rank 1 did not serve the sampled request with rank 0's seed"
    streamed = resp[len(TP_POOL_PROMPTS)]["generated_code"][0][0]
    if r0["streamed"] != streamed or r1["streamed"]:
        return "served run: the stream is not the streamed answer, or rank 1 streamed"
    n_req = len(resp)
    log(f"  served (rank 0 the clients, rank 1 following; {CARD}): CodeFuseHandler over a paged "
        f"class and a beam class of width 2, {n_req} requests {TP_STAGGER} s apart (the 4 pool "
        f"prompts, streamed, sampled without seed or top_k, a static-route one of "
        f"{TP_SERVED[2][1]} + {TP_SERVED[2][2]} tokens, a beam): {r0['wall']:.2f} s, "
        f"{n_req / r0['wall']:.2f} requests/s (two ranks share the card: no two-card time); "
        f"{r0['rounds']} rounds, ticks (chunk, decode) {r0['ticks']}, the static request's "
        f"{r0['static_forwards']} decode forwards; sampled seed {sampled['random_seed'][0]} on "
        f"both ranks")
    for rank, r in res.items():
        log(f"  served, rank {rank}: {control_line(r['served']['times'])} ({CARD})")
    log(f"  served: greedy tokens' largest gap to the tp = 1 static argmax (pool x4, streamed, "
        f"static): {', '.join(f'{g:.2e}' for g in r0['gaps'])} (tol POOL_GAP {POOL_GAP:g}); "
        f"each rank's launches {({n: c for n, c in r0['counts'].items() if c})} as expected")
    if max(r0["gaps"]) >= POOL_GAP:
        return "served tokens part from the tp = 1 static program"
    b0, b1 = res[0]["bert"], res[1]["bert"]
    if b0["errors"]:
        return f"served int8 BERT-base: requests failed: {b0['errors']}"
    if b0["batches"] != b1["batches"]:
        return "served int8 BERT-base: the ranks ran different batches"
    for rank, r in res.items():
        expect = {n: 0 for n in r["bert"]["counts"]}
        expect.update(r["bert"]["expect"])
        if r["bert"]["counts"] != expect:
            return f"served int8 BERT-base, rank {rank}: launches {r['bert']['counts']}, " \
                   f"expected {expect}"
        for n in kernels:
            launched[n] += r["bert"]["counts"][n]
    log(f"  served int8 BERT-base ({b0["layers"]} layers) at tp = 2 behind EncoderBatchingServer: "
        f"{len(TP_BERT_LENS)} requests of {min(TP_BERT_LENS)}-{max(TP_BERT_LENS)} tokens in "
        f"batches of lengths {b0['batches']} on both ranks, {b0['wall']:.2f} s, "
        f"{len(TP_BERT_LENS) / b0['wall']:.2f} requests/s ({CARD}; two ranks share the card); "
        f"against the tp = 1 encode max |d| / max |ref| "
        f"{', '.join(f'{x:.2e}' for x in b0['rels'])} (tol 5e-2)")
    if max(b0["rels"]) >= 5e-2:
        return "served int8 BERT-base at tp = 2 disagrees with tp = 1"
    return None


# Phase 11: pipeline parallelism. CodeFuse-13B int8 at full width, PP_LAYERS
# deep, on four ranks of one gloo group on the one card: pp = 2 as two copies
# of the mesh (two layers a stage) and tp 2 x pp 2 on all four ranks, each at
# 1 and 2 microbatches; a pp = 1 engine on rank 0 is the yardstick. Prompts,
# tokens and the pool's requests are phase 10's.
PP_LAYERS = 4
PP_MESHES = (("pp 2", dict(tp=1, pp=2)), ("tp 2 x pp 2", dict(tp=2, pp=2)))
PP_MICROBATCHES = (1, 2)
PP_POOL = dict(max_slots=4, max_seq_len=1024, prompt_bucket=128)  # dense: pp refuses pages
# seconds for the whole phase and for any one hop or collective: the phase
# takes ~60-90 s (four ranks share the card and the host), starting ~650 s
# into the script's 1200 s
PP_TIMEOUT = 240
PP_SERVED = "tp 2 x pp 2"  # the mesh whose dense pool also serves behind a BatchingServer


def pp_served(torch, eng, eng1, pool_prompts, kernels, counters):
    """Phase 11's served run, on each rank: a ``BatchingServer`` on PP_POOL's
    dense pool over the engine of the mesh; rank 0's client threads send
    TP_POOL_PROMPTS TP_STAGGER s apart, the other ranks follow. Returns what
    the rank served and counted, the launches its ticks must give, and on
    rank 0 the tokens' gaps to the pp = 1 static program's argmax and the
    wall."""
    import torch.distributed as dist

    from fastertransformer4codefuse_tpu_torch.engine.server import BatchingServer
    from fastertransformer4codefuse_tpu_torch.parallel import lockstep

    zero_counts(kernels)
    for c in counters:
        c.calls = 0
    since = lockstep.publish.calls
    srv = BatchingServer(eng, **PP_POOL)
    ls = srv.lockstep
    ls.served = []
    ticks, times = count_ticks(ls, counters)
    res = {}
    if ls.leader:
        got, errors, wall = staggered(
            [lambda p=p, n=n: srv.generate(p, n, top_k=1).output_ids
             for p, n in zip(pool_prompts, TP_POOL_OUTS)], TP_STAGGER)
        srv.close()
        res.update(errors=errors, wall=wall)
    else:
        srv.follow()
    b = srv.batcher
    res.update(served_counts(torch, kernels, ls, since, counters),
               ticks=(b.chunk_ticks, b.decode_ticks), tick_counts=ticks, times=times,
               expect=pool_launches(eng.stage[1], b))
    if ls.leader and not errors:
        res["gaps"] = [float(static_gaps(torch, eng1, p, ids[len(p):]).max())
                       for p, ids in zip(pool_prompts, got)]
    del srv, b
    dist.barrier()
    return res


def pp_launches(L, m_pre, m_dec, forwards):
    """Launches each rank must count for a static run of one prefill in
    ``m_pre`` microbatches and ``forwards`` decode forwards in ``m_dec``,
    on a stage of L layers: a whole-prompt prefill (m_pre = 1) runs K13's
    GEMM, the proj and down GEMMs and K5; a microbatched one each chunk as a
    chunk tick (K13 and the two GEMMs, the dense plain chunk attention); a
    decode microbatch K13's GEMV, K4 and K3; the int8 [V, H] head is a
    plain matmul."""
    pre = (expected_launches(L, 1, 0, 8, 0) if m_pre == 1 else
           {"fused_qkv_up": L * m_pre, "quant_matmul": L * 2 * m_pre})
    return add_counts(pre, expected_launches(L, 0, forwards * m_dec, 8, 0))


def pp_rank(rank, port, results):
    """A rank of phase 11 (a spawned process): its results, or the
    traceback, on ``results``."""
    try:
        res = _pp_rank(rank, port)
    except BaseException:  # noqa: BLE001 - the parent reports it
        import traceback

        res = {"error": traceback.format_exc()}
    results.put((rank, res))


def _pp_rank(rank, port):
    import dataclasses

    import torch
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    import fastertransformer4codefuse_tpu_torch as pkg
    from fastertransformer4codefuse_tpu_torch.engine import kv_cache
    from fastertransformer4codefuse_tpu_torch.engine.batcher import ContinuousBatcher
    from fastertransformer4codefuse_tpu_torch.ops import _cuda
    from fastertransformer4codefuse_tpu_torch.ops.attention import prefill_attention
    from fastertransformer4codefuse_tpu_torch.parallel import distributed as pd
    from fastertransformer4codefuse_tpu_torch.parallel.sharding import build_mesh

    global ROUTERS
    ROUTERS = (prefill_attention, kv_cache.attend_chunk, kv_cache.attend_decode)
    torch.backends.cuda.matmul.allow_tf32 = False
    _cuda.lib()  # built by the parent
    pd.init_distributed(f"127.0.0.1:{port}", 4, rank, backend="gloo", timeout_s=PP_TIMEOUT)
    meshes = {label: build_mesh(**kw) for label, kw in PP_MESHES}  # every rank, in one order
    kernels = kernel_table()
    counters = (pd.send_next, pd.recv_prev, pd.broadcast_last, pd.all_reduce, pd.all_gather)
    cfg = pkg.GptNeoXConfig(**{**pkg.GptNeoXConfig.codefuse_13b().__dict__,
                               "layer_num": PP_LAYERS})
    V = cfg.vocab_size
    params = pkg.init_params(cfg, seed=0, dtype="bf16", int8_mode=1, quantize_embeddings=True,
                             device="cuda")
    rt = pkg.RuntimeConfig(dtype="bf16", int8_mode=1, kv_cache_dtype="int8")
    eng1 = pkg.GptNeoXEngine(cfg, params, rt) if rank == 0 else None
    rng = np.random.default_rng(10)
    prompts = [rng.integers(0, V, n).tolist() for n in TP_PROMPTS]
    pool_prompts = [rng.integers(0, V, n).tolist() for n in TP_POOL_PROMPTS]
    out = {"backend": dist.get_backend(), "runs": {}}

    def read():
        return tuple(c.calls for c in counters)

    def counted(fn):
        """fn's result, its kernel launches and its (sends, receives,
        broadcasts, all-reduces, all-gathers)."""
        zero_counts(kernels)
        for c in counters:
            c.calls = 0
        res = fn()
        torch.cuda.synchronize()
        return res, read_counts(kernels), read()

    def timed(engine, n):
        if engine is not eng1:
            dist.barrier()
        torch.cuda.synchronize()
        t = time.time()
        g = engine.generate(prompts, n, top_k=1)
        torch.cuda.synchronize()
        return g, time.time() - t, engine.decode_forwards

    def ms(engine):
        """(prefill ms, decode ms/step): a prefill alone, then the whole call."""
        _, t_pre, _ = timed(engine, 1)
        _, t_all, f = timed(engine, TP_TOKENS)
        return t_pre * 1e3, (t_all - t_pre) / max(f, 1) * 1e3

    # the pp = 1 yardstick on rank 0, while the others wait for its tokens
    forced = lg1 = None
    if rank == 0:
        out["width"] = eng1._prepare(prompts, 1)[0].input_width
        out["width"] = eng1._prepare(prompts, 1)[0].input_width
        g1, _, _ = timed(eng1, TP_TOKENS)
        out["pp1_ids"], out["pp1_ms"] = g1.output_ids, ms(eng1)
        forced = np.stack([g1.output_ids[b, 0, n:n + TP_TOKENS]
                           for b, n in enumerate(TP_PROMPTS)])
        lg1 = tp_forced_logits(torch, eng1, prompts, forced)
    box = [forced]
    dist.broadcast_object_list(box, src=0)
    forced = box[0]

    for label, mesh in meshes.items():
        for M in PP_MICROBATCHES:
            eng = pkg.GptNeoXEngine(cfg, params, dataclasses.replace(rt, pp_microbatches=M),
                                    mesh=mesh)
            run = {"stage": mesh.pp_rank, "layers": eng.stage}
            (g, _, f), run["static_counts"], run["static_coll"] = counted(
                lambda: timed(eng, TP_TOKENS))
            run["static_ids"], run["static_forwards"] = g.output_ids, f
            lg, run["forced_counts"], run["forced_coll"] = counted(
                lambda: tp_forced_logits(torch, eng, prompts, forced))
            if rank == 0:
                run["forced_rel"] = [((lg[:, j] - lg1[:, j]).abs().max()
                                      / lg1[:, j].abs().max()).item() for j in range(TP_TOKENS)]
                run["parting"] = []  # the first parting of each row, on pp = 1's logits
                for b, n in enumerate(TP_PROMPTS):
                    a, c = g.output_ids[b, 0, n:n + TP_TOKENS], forced[b]
                    i = next((i for i in range(TP_TOKENS) if a[i] != c[i]), None)
                    if i is not None:
                        gap = (lg1[b, i, int(c[i])] - lg1[b, i, int(a[i])]) / lg1[b, i].abs().max()
                        run["parting"].append((b, i, int(a[i]), int(c[i]), gap.item()))
            del lg
            if M == 1:
                run["ms"] = ms(eng)

                def drive():
                    cb = ContinuousBatcher(eng, **PP_POOL)
                    uids = [cb.submit(p, n, top_k=1) for p, n in zip(pool_prompts, TP_POOL_OUTS)]
                    ticks = []  # (chunk steps, decode steps, the tick's counted calls)
                    while cb.pending or cb.running:
                        for c in counters:
                            c.calls = 0
                        c0, d0 = cb.chunk_ticks, cb.decode_ticks
                        cb.step()
                        ticks.append((cb.chunk_ticks - c0, cb.decode_ticks - d0, read()))
                    return cb, [cb.requests[u].output_ids[len(p):]
                                for u, p in zip(uids, pool_prompts)], ticks

                dist.barrier()
                t = time.time()
                (cb, pool_out, ticks), run["pool_counts"], _ = counted(drive)
                run["pool_s"] = time.time() - t
                run["pool_expect"] = pool_launches(eng.stage[1], cb)
                run["pool_out"], run["pool_ticks"] = pool_out, ticks
                run["pool_layers"] = int(cb._state["cache"]["k"].shape[0])
                if rank == 0:
                    run["pool_gaps"] = [float(static_gaps(torch, eng1, p, g).max())
                                        for p, g in zip(pool_prompts, pool_out)]
                del cb
                if label == PP_SERVED:
                    run["served"] = pp_served(torch, eng, eng1, pool_prompts, kernels, counters)
            out["runs"][label, M] = run
            del eng
            torch.cuda.empty_cache()
    dist.barrier()
    dist.destroy_process_group()
    return out


def check_pp_served(name, runs, tp, pp, L, kernels, launched):
    """Phase 11's served run from every rank's results: the same tokens and
    rounds on all four ranks, publishes = rounds, each stage's hops, one
    broadcast a step, L all-reduces a step and one all-gather a decode step,
    each rank's launches those of its ticks, and every token within
    POOL_GAP of the pp = 1 static program's argmax. Returns an error or
    None."""
    s0 = runs[0]["served"]
    if s0["errors"]:
        return f"{name}, served: requests failed: {s0['errors']}"
    for rank, r in runs.items():
        s, stage = r["served"], r["stage"]
        if s["served"] != s0["served"] or s["rounds"] != s0["rounds"]:
            return f"{name}, served: rank {rank} served other tokens or rounds than rank 0"
        if s["publishes"] != s["rounds"]:
            return f"{name}, served, rank {rank}: {s['publishes']} publishes, {s['rounds']} rounds"
        if sum(c + d for c, d, _ in s["tick_counts"]) != sum(s["ticks"]):
            return f"{name}, served, rank {rank}: ticks not all counted"
        for c, d, coll in [*s["tick_counts"], (*s["ticks"], s["coll"])]:  # each tick; all
            n = c + d
            want = (n if stage < pp - 1 else 0, n if stage > 0 else 0, n,
                    L * n if tp > 1 else 0, d if tp > 1 else 0)
            if tuple(coll) != want:
                return f"{name}, served, rank {rank}: {c} chunk and {d} decode steps counted " \
                       f"{coll}, expected {want}"
        expect = {k: 0 for k in s["counts"]}
        expect.update(s["expect"])
        if s["counts"] != expect:
            return f"{name}, served, rank {rank}: launches {s['counts']}, expected {expect}"
        for k in kernels:
            launched[k] += s["counts"][k]
    log(f"  {name}: served behind a BatchingServer (rank 0 the clients, 3 ranks following; "
        f"{CARD}): {len(TP_POOL_PROMPTS)} requests {TP_STAGGER} s apart in {s0['wall']:.2f} s, "
        f"{len(TP_POOL_PROMPTS) / s0['wall']:.2f} requests/s (four ranks share the card: no "
        f"multi-card time); {s0['rounds']} rounds, ticks (chunk, decode) {s0['ticks']}, the "
        f"same tokens on all four ranks; largest gap to the pp = 1 static argmax "
        f"{', '.join(f'{g:.2e}' for g in s0['gaps'])} (tol POOL_GAP {POOL_GAP:g})")
    for rank in sorted(runs):
        log(f"  {name}, served, rank {rank}: {control_line(runs[rank]['served']['times'])} "
            f"({CARD})")
    if max(s0["gaps"]) >= POOL_GAP:
        return f"{name}: served tokens part from the pp = 1 static program"
    return None


def phase_pp(torch, pkg, kernels, launched):
    """Phase 11: four ranks on the one card, spawned after the parent built
    the kernels, serve CodeFuse-13B int8 at full width and PP_LAYERS deep as
    pp = 2 (two copies of the mesh) and as tp 2 x pp 2, each at 1 and 2
    microbatches; a pp = 1 engine on rank 0 is the yardstick. Checks every
    rank's tokens the same bytes, the teacher-forced logits within 5e-2 of
    max |logits| of pp = 1's, greedy partings only below NEAR_TIE, each
    stage's layers, the counted hops, broadcasts, all-reduces and
    all-gathers of every static run and pool tick, each rank's launches,
    and a dense pool of 4 requests (each token within POOL_GAP of the pp = 1
    static program's argmax). Returns an error or None."""
    import socket

    import torch.multiprocessing as mp

    log(f"phase 11: pipeline parallelism, CodeFuse-13B int8 at full width, {PP_LAYERS} layers: "
        "pp = 2 (two copies) and tp 2 x pp 2, four ranks of a gloo group on the one card")
    t0 = time.time()
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=pp_rank, args=(r, port, q)) for r in range(4)]
    for p in procs:
        p.start()
    res, deadline = {}, time.time() + PP_TIMEOUT
    try:
        while len(res) < 4:
            try:
                rank, r = q.get(timeout=5)
                res[rank] = r
            except queue.Empty:
                dead = [p.exitcode for p in procs if not p.is_alive()]
                if len(dead) > len(res) or time.time() > deadline:
                    return f"a rank ended without a result (exit codes {dead}) or timed out"
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    for rank in range(4):
        if "error" in res[rank]:
            return f"rank {rank}: {res[rank]['error']}"
    r0 = res[0]
    if {r["backend"] for r in res.values()} != {"gloo"}:
        return "phase 11 runs on gloo"
    width, B = r0["width"], len(TP_PROMPTS)
    for (label, M), run0 in r0["runs"].items():
        tp, pp = dict(PP_MESHES)[label]["tp"], dict(PP_MESHES)[label]["pp"]
        L = PP_LAYERS // pp
        m_pre = M if width % M == 0 else 1
        m_dec = M if B % M == 0 else 1
        name = f"{label}, M = {M}"
        runs = {rank: r["runs"][label, M] for rank, r in res.items()}
        if any(not np.array_equal(r["static_ids"], run0["static_ids"]) for r in runs.values()) \
                or any(r.get("pool_out") != run0.get("pool_out") for r in runs.values()):
            return f"{name}: the ranks returned different tokens"
        for rank, r in runs.items():
            stage = r["stage"]
            if r["layers"] != (stage * L, L):
                return f"{name}, rank {rank}: stage {stage} holds layers {r['layers']}"
            for what, fwd, coll, counts in (
                    ("static generate", 1 + r["static_forwards"], r["static_coll"],
                     r["static_counts"]),
                    ("teacher-forced run", TP_TOKENS, r["forced_coll"], r["forced_counts"])):
                hops = m_pre + (fwd - 1) * m_dec
                want = (hops if stage < pp - 1 else 0, hops if stage > 0 else 0, fwd,
                        L * hops if tp > 1 else 0, fwd if tp > 1 else 0)
                if tuple(coll) != want:
                    return f"{name}, rank {rank}, {what}: (sends, receives, broadcasts, " \
                           f"all-reduces, all-gathers) {coll}, expected {want}"
                expect = {n: 0 for n in counts}
                expect.update(pp_launches(L, m_pre, m_dec, fwd - 1))
                if counts != expect:
                    return f"{name}, rank {rank}, {what}: launches {counts}, expected {expect}"
                for n in kernels:
                    launched[n] += counts[n]
            if M != 1:
                continue
            if r["pool_layers"] != L:
                return f"{name}, rank {rank}: the pool's slabs hold {r['pool_layers']} layers"
            for c, d, coll in r["pool_ticks"]:
                n = c + d
                want = (n if stage < pp - 1 else 0, n if stage > 0 else 0, n,
                        L * n if tp > 1 else 0, d if tp > 1 else 0)
                if tuple(coll) != want:
                    return f"{name}, rank {rank}: a pool tick of {c} chunk and {d} decode " \
                           f"steps counted {coll}, expected {want}"
            expect = {n: 0 for n in r["pool_counts"]}
            expect.update(r["pool_expect"])
            if r["pool_counts"] != expect:
                return f"{name}, rank {rank}, dense pool: launches {r['pool_counts']}, " \
                       f"expected {expect}"
            for n in kernels:
                launched[n] += r["pool_counts"][n]
        nonzero = {n: c for n, c in run0["static_counts"].items() if c}
        log(f"  {name}: every rank's hops, broadcasts, collectives and launches as expected "
            f"(rank 0, static: {nonzero}; {run0['static_coll']})")
        rel = run0["forced_rel"]
        log(f"  {name}: teacher-forced logits against pp = 1, max |d| / max |ref| after the "
            f"prefill and each step: {', '.join(f'{x:.2e}' for x in rel)} (tol 5e-2)")
        if max(rel) >= 5e-2:
            return f"{name}: logits disagree with pp = 1"
        same = [np.array_equal(run0["static_ids"][b, 0, n:n + TP_TOKENS],
                               r0["pp1_ids"][b, 0, n:n + TP_TOKENS])
                for b, n in enumerate(TP_PROMPTS)]
        log(f"  {name}: greedy tokens against pp = 1 equal {same}; partings (row, step, pp, "
            f"pp = 1, gap on the pp = 1 logits): {run0['parting']}")
        far = [x for x in run0["parting"] if x[4] >= NEAR_TIE]
        if far:
            return f"{name}: greedy parts from pp = 1 past NEAR_TIE: {far}"
        if M == 1:
            gaps = run0["pool_gaps"]
            log(f"  {name}: dense pool (4 requests of {list(TP_POOL_PROMPTS)} tokens): tokens' "
                f"largest gap to the pp = 1 static argmax "
                f"{', '.join(f'{g:.2e}' for g in gaps)} (tol POOL_GAP {POOL_GAP:g}); "
                f"{run0['pool_s']:.1f} s, {len(run0['pool_ticks'])} ticks")
            if max(gaps) >= POOL_GAP:
                return f"{name}: pool tokens part from the pp = 1 static program"
        if M == 1 and label == PP_SERVED:
            err = check_pp_served(name, runs, tp, pp, L, kernels, launched)
            if err:
                return err
    (p1, d1) = r0["pp1_ms"]
    times = "; ".join(f"{label} prefill {r0['runs'][label, 1]['ms'][0]:.1f} ms, decode "
                      f"{r0['runs'][label, 1]['ms'][1]:.2f} ms/step" for label, _ in PP_MESHES)
    log(f"  B = 2 prompts of {list(TP_PROMPTS)} tokens, 1 microbatch ({CARD}; four ranks share "
        f"the card, so these are no multi-card times): {times}; pp = 1 prefill {p1:.1f} ms, "
        f"decode {d1:.2f} ms/step")
    log(f"  phase 11: {time.time() - t0:.1f} s")
    return None


# Phase 12: training. proxy85m, the largest proxy QUALITY.md documents (12
# heads x 64, 12 layers, FFN 3072, byte vocab), trained in fp32 at B = 8 on
# the repository's text: TRAIN_STEPS at S = 256 (the trainer's default), then
# TRAIN_LONG_STEPS at S = 2048, the width at which the JAX trainer reaches
# the library kernels.
TRAIN_PROXY = dict(heads=12, dh=64, layers=12, inter=3072)
TRAIN_DEVICE = "cuda"
TRAIN_BATCH = 8
TRAIN_STEPS = 100
TRAIN_LONG_STEPS = 3
TRAIN_DROP = 0.8  # the loss of the last 5 steps at S = 256 below this x the first step's
# K5's fp32 instances and its backward: max |kernel - plain| / max |plain|
# (fp32 sums in another order over up to 2048 keys)
TRAIN_TOL = 1e-4
# the fastest route to fp32-accurate products on the card: 3xTF32, three
# TF32 tensor-core MMAs a product (495 TFLOP/s dense TF32, NVIDIA's data
# sheet, H100 SXM at 700 W, over 3), against 67 TFLOP/s of fp32 FMA: the
# fp32 K5 kernels' bound, whichever route each kernel takes
F32_FLOPS = 495e12 / 3
# the quality table's short form: its rows, the held-out bytes of its NLL and
# of its decode-path NLL, the greedy prompts and tokens
QT_ROWS = ("bf16", "int8", "int8 + int8 KV", "int4 g128")
QT_BYTES, QT_DECODE_BYTES, QT_PROMPTS, QT_GEN = 8192, 512, 2, 16
QT_INT8_DNLL = 0.02  # int8 against the float row, nats a byte
TRAIN_CASES = (("B=1 S=2048 40x128", 1, 2048, [2048], 40, 40, 128),
               ("B=8 S=2048 12x64 (proxy85m)", 8, 2048, [2048] * 8, 12, 12, 64),
               ("B=2 S=1024 lengths [1024, 700] 8x256", 2, 1024, [1024, 700], 8, 8, 256),
               ("B=1 S=2048 32x128 g=4", 1, 2048, [2048], 32, 8, 128))


def phase_train(torch, pkg, kernels, launched, records):
    """Training on the card: (a) K5's fp32 forward (with its log-sum-exp)
    and the two backward kernels against their plain versions (the gradient
    of sum(out * ct), ct seeded, by autograd of the plain forward) at
    CodeFuse-13B's 40 x 128 (B = 1, S = 2048), proxy85m's training shape,
    a dh-256 case with lengths below S and a GQA case (g = 4), timed with
    SDPA's fp32 causal forward (the forward's library yardstick) and its
    backward alone (the backward kernels'), bounds at 3xTF32's rate;
    (b) proxy85m trained through ``tools.train_proxy`` (autograd through the
    model's prefill: K5 fp32 forward, dK/dV and dQ kernels; exact launch
    counts; then one profiled step at each width); (c) ``save_params`` /
    ``load_params`` round trip; (d) a short
    bf16 quality table of the trained model (``tools.quality_table``:
    float, int8, int8 + int8 KV, int4 g128; K13, K1, K3, K4 and K7 counted).
    Returns an error or None."""
    import gc

    import torch.nn.functional as F

    from fastertransformer4codefuse_tpu_torch.ops.attention import (
        prefill_attention_flash, prefill_attention_flash_plain, prefill_flash_bwd_dkv,
        prefill_flash_bwd_dq, prefill_flash_bwd_plain, prefill_flash_forward,
        prefill_flash_lse_plain,
    )
    from fastertransformer4codefuse_tpu_torch.tools import quality_table as qt
    from fastertransformer4codefuse_tpu_torch.tools import train_proxy as tp

    log("phase 12: training on the card: K5 fp32 and its backward (dK/dV, dQ) against their "
        "plain versions, proxy85m trained on the repository's text, a checkpoint round trip, a "
        "short bf16 quality table")
    t_phase = time.time()
    gc.collect()
    torch.cuda.empty_cache()
    dev = torch.device(TRAIN_DEVICE)
    gen = torch.Generator(device=dev).manual_seed(4321)

    # (a) the kernels at the main path's widths; the first case fills the
    # records. Work: the (query, key) pairs the causal and length bounds
    # admit, 2 operations a pair and head dim a product: the forward takes
    # QK^T and PV, dK/dV recomputes QK^T and takes dO V^T, P^T dO and dS^T Q,
    # dQ recomputes QK^T and dO V^T and takes dS K.
    names = ("prefill_attention_flash_f32", "prefill_flash_bwd_dkv", "prefill_flash_bwd_dq")
    for ci, (label, B, S, lens, nH, nKV, dh) in enumerate(TRAIN_CASES):
        def randn(*shape):
            return torch.randn(shape, device=dev, generator=gen)

        q, k, v, ct = randn(B, S, nH, dh), randn(B, S, nKV, dh), randn(B, S, nKV, dh), \
            randn(B, S, nH, dh)
        ln = torch.tensor(lens, dtype=torch.int32, device=dev)
        sm = dh ** -0.5
        n_pairs = sum(n * (n + 1) // 2 + (S - n) * n for n in lens) * nH
        out, lse = prefill_flash_forward(q, k, v, ln, sm)
        delta = (ct * out).sum(-1).transpose(1, 2).contiguous()
        dk, dv = prefill_flash_bwd_dkv(q, k, v, ct, lse, delta, ln, sm)
        dq = prefill_flash_bwd_dq(q, k, v, ct, lse, delta, ln, sm)
        ref = prefill_attention_flash_plain(q, k, v, ln, sm)
        ref_lse = prefill_flash_lse_plain(q, k, ln, sm)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        o = prefill_attention_flash_plain(*leaves, ln, sm)
        gq, gk, gv = torch.autograd.grad((o * ct).sum(), leaves)
        del o, leaves
        # the autograd route (PrefillFlash) gives the kernels' bytes
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        (prefill_attention_flash(*leaves, ln, sm) * ct).sum().backward()
        same = all(torch.equal(a.grad, b) for a, b in zip(leaves, (dq, dk, dv)))
        del leaves
        torch.cuda.synchronize()
        errs = {"out": rel_err(torch, out, ref), "lse": rel_err(torch, lse, ref_lse),
                "dq": rel_err(torch, dq, gq), "dk": rel_err(torch, dk, gk),
                "dv": rel_err(torch, dv, gv)}
        finite = all(bool(torch.isfinite(t).all()) for t in (out, lse, dq, dk, dv))
        log(f"  {label}: max |kernel - plain| / max |plain| "
            + ", ".join(f"{n} {e[1]:.2e}" for n, e in errs.items())
            + f" (tol {TRAIN_TOL:g}); through PrefillFlash's autograd the same bytes: {same}")
        if not finite or not same or max(e[1] for e in errs.values()) > TRAIN_TOL:
            return f"K5 fp32 / backward {label}: disagrees with the plain version"
        for n, keys in zip(names, (("out", "lse"), ("dk", "dv"), ("dq",))):
            records[n]["max_abs_err"] = max(records[n]["max_abs_err"],
                                            *(errs[x][0] for x in keys))
        if ci < 2:  # timed at 13B's heads and at the training shape
            plain_all = lambda: prefill_flash_bwd_plain(q, k, v, ct, lse, delta, ln, sm)  # noqa
            qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))

            def sdpa():
                return F.scaled_dot_product_attention(qh, kh, vh, is_causal=True, scale=sm,
                                                      enable_gqa=nKV != nH)

            lh = [t.clone().requires_grad_() for t in (qh, kh, vh)]
            cth = ct.transpose(1, 2)

            # SDPA's backward alone: its forward once, the gradient of y
            # against ct timed (the graph kept for the next call)
            y_lib = F.scaled_dot_product_attention(*lh, is_causal=True, scale=sm,
                                                   enable_gqa=nKV != nH)

            def sdpa_bwd():
                return torch.autograd.grad(y_lib, lh, grad_outputs=cth, retain_graph=True)

            rw = nbytes(q, k, v, ln)
            fb = rw + nbytes(ct, lse, delta)
            timing = (
                (names[0], lambda: prefill_flash_forward(q, k, v, ln, sm),
                 lambda: (prefill_attention_flash_plain(q, k, v, ln, sm),
                          prefill_flash_lse_plain(q, k, ln, sm)),
                 sdpa, "sdpa fp32 is_causal forward", rw + nbytes(out, lse), 4 * n_pairs * dh),
                (names[1], lambda: prefill_flash_bwd_dkv(q, k, v, ct, lse, delta, ln, sm),
                 plain_all, sdpa_bwd, "sdpa fp32 is_causal backward alone",
                 fb + nbytes(dk, dv), 8 * n_pairs * dh),
                (names[2], lambda: prefill_flash_bwd_dq(q, k, v, ct, lse, delta, ln, sm),
                 plain_all, sdpa_bwd, "sdpa fp32 is_causal backward alone",
                 fb + nbytes(dq), 6 * n_pairs * dh))
            for n, fn_k, fn_p, fn_lib, lib_label, n_bytes, flops in timing:
                t_k = device_time_ms(torch, fn_k, reps=3, calls=3)
                t_p = device_time_ms(torch, fn_p, reps=3, calls=2)
                t_lib = device_time_ms(torch, fn_lib, reps=3, calls=3)
                t_b, t_f = n_bytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
                b_ms, b_by = (t_b, "bytes") if t_b >= t_f else (t_f, "operations")
                log(f"    {n:28s} kernel {t_k:.4f} ms  plain {t_p:.4f} ms  bound {b_ms:.4f} ms "
                    f"({b_by}, 3xTF32 165 TFLOP/s; {b_ms / t_k:.1%} of it)  library "
                    f"{t_lib:.4f} ms ({lib_label}; kernel {t_k / t_lib:.2f}x)")
                if ci == 0:
                    records[n].update(ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by,
                                      library_ms=t_lib, library=lib_label)
            del lh, y_lib
        del q, k, v, ct, out, lse, delta, dk, dv, dq, ref, ref_lse, gq, gk, gv
        gc.collect()
        torch.cuda.empty_cache()
    t_kernels = time.time() - t_phase

    # (b) proxy85m trained through the tool's step (a fresh fp32 cache and
    # the model's prefill each step, autograd, AdamW)
    cfg = tp.sized_config(**TRAIN_PROXY)
    train, held = tp.split_corpus(tp.load_tracked_corpus(REPO))
    params = pkg.init_params(cfg, seed=0, dtype=torch.float32, device=dev)
    n_params = sum(t.numel() for _, t in tp.flatten(params))
    opt = tp.make_optimizer(params)
    n_steps = TRAIN_STEPS + TRAIN_LONG_STEPS
    lr_at = tp.schedule_of(n_steps, 3e-4)
    rng = np.random.default_rng(0)
    L = cfg.layer_num
    torch.cuda.reset_peak_memory_stats()
    zero_counts(kernels)
    losses, step_ms = [], []
    for i in range(n_steps):
        S = 256 if i < TRAIN_STEPS else 2048
        ids = torch.from_numpy(tp.draw_batch(rng, train, TRAIN_BATCH, S)).to(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(tp.train_step(cfg, params, opt, lr_at(i), ids))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    losses = [float(x) for x in losses]
    expect = {"prefill_attention_flash": L * n_steps, "prefill_attention_flash_f32": L * n_steps,
              "prefill_flash_bwd_dkv": L * n_steps, "prefill_flash_bwd_dq": L * n_steps}
    err = check_run_counts(torch, kernels, launched, expect,
                           f"proxy85m, {n_steps} training steps (K5 fp32 forward, dK/dV and dQ: "
                           f"{L} a step each)")
    if err:
        return err
    first, last = losses[0], statistics.mean(losses[TRAIN_STEPS - 5: TRAIN_STEPS])
    long_losses = losses[TRAIN_STEPS:]
    log(f"  proxy85m ({n_params / 1e6:.1f}M params, fp32; corpus {len(train)} train / "
        f"{len(held)} held-out bytes): loss {first:.4f} at step 0 -> {last:.4f} (mean of steps "
        f"{TRAIN_STEPS - 5}-{TRAIN_STEPS - 1}; must be below {TRAIN_DROP} x the first), then at "
        f"S = 2048 {', '.join(f'{x:.4f}' for x in long_losses)}")
    log(f"  training ms/step at B = {TRAIN_BATCH}: S = 256 median "
        f"{statistics.median(step_ms[5:TRAIN_STEPS]):.1f} ms (steps 5-{TRAIN_STEPS - 1}; step 0 "
        f"{step_ms[0]:.1f} ms), S = 2048 {', '.join(f'{x:.1f}' for x in step_ms[TRAIN_STEPS:])} "
        f"ms; peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({CARD})")
    if not (np.isfinite(losses).all() and last < TRAIN_DROP * first and max(long_losses) < first):
        return "proxy85m: the training loss did not fall"
    # where a step goes: one more step at each width under torch.profiler
    # (kernel activity only), its device time against the median step's wall
    from fastertransformer4codefuse_tpu_torch.utils.profiling import summarize_trace, trace

    for S, wall in ((256, statistics.median(step_ms[5:TRAIN_STEPS])),
                    (2048, statistics.median(step_ms[TRAIN_STEPS:]))):
        ids = torch.from_numpy(tp.draw_batch(rng, train, TRAIN_BATCH, S)).to(dev)
        with trace(cpu=False) as prof:
            tp.train_step(cfg, params, opt, lr_at(n_steps - 1), ids)
        rows = [r[:3] for r in summarize_trace(prof, top=0)]
        dev_ms = sum(r[1] for r in rows)
        if not dev_ms:
            return "the profiled training step shows no device time"
        k5 = sum(ms for name, ms, _ in rows if "prefill_f32_" in name)
        log(f"  a profiled step at S = {S}: device {dev_ms:.1f} ms against the median wall "
            f"{wall:.1f} ms ({dev_ms / wall:.0%} busy); K5 fp32 + backward {k5:.1f} ms "
            f"({k5 / dev_ms:.1%} of the device time); by kernel:")
        for name, ms, n in rows[:6]:
            log(f"    {ms:9.3f} ms {n:5d}x  {name[:90]}")
    del opt

    # (c) the checkpoint round trip (of the params after the profiled steps)
    trained = tp.detached(params)
    del params
    path = os.path.join(REPO, "build", "phase12_proxy.npz")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    try:
        tp.save_params(path, trained)
        back = tp.load_params(path, device=dev)
    finally:
        if os.path.exists(path):
            os.remove(path)
    want, got = tp.flatten(trained), tp.flatten(back)
    same = [k for k, _ in got] == [k for k, _ in want] and all(
        torch.equal(a, b) for (_, a), (_, b) in zip(got, want))
    log(f"  save_params -> load_params: {len(want)} leaves, the same bytes: {same}")
    if not same:
        return "the checkpoint round trip changed the params"
    del back, got, want

    # (d) the short quality table of the trained model, bf16 activations
    zero_counts(kernels)
    t0 = time.time()
    rows = qt.quality_rows(cfg, trained, held[:QT_BYTES], "bf16", names=QT_ROWS,
                           prompts=QT_PROMPTS, gen_len=QT_GEN, decode_bytes=QT_DECODE_BYTES)
    torch.cuda.synchronize()
    counts = read_counts(kernels)
    for line in qt.table_lines(rows, "bf16"):
        log("    " + line)
    ran = {n: counts[n] for n in ("fused_qkv_up", "quant_matmul", "fused_proj_down",
                                   "flash_decode", "quant_matmul_w4_group")}
    log(f"  quality table ({len(rows)} rows over {QT_BYTES} held-out bytes, {time.time() - t0:.1f}"
        f" s): launches {({n: c for n, c in counts.items() if c})}; K13, K1, K3, K4, K7: {ran}")
    for n in kernels:
        launched[n] += counts[n]
    if counts["plain_routes"] or not all(ran.values()):
        return "quality table: a kernel of its routes was not launched, or a plain route taken"
    d8 = abs(rows[1][3])
    if not all(np.isfinite(r[1]) for r in rows) or d8 >= QT_INT8_DNLL:
        return f"quality table: int8 dNLL {d8:.4f} (limit {QT_INT8_DNLL})"
    del trained
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  phase 12: {time.time() - t_phase:.1f} s (the kernels {t_kernels:.1f} s)")
    return None


if __name__ == "__main__":
    sys.exit(main())
