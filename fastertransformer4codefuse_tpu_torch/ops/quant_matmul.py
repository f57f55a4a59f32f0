"""K1: weight-only int8 matmul, y = act(x @ W * scale + bias).

Port of ops/quant_matmul.py (``quant_matmul_pallas_stacked``, and through a
layer's view of the stacked weight the 2-D ``quant_matmul_pallas``). The CUDA
kernel is ``csrc/quant_matmul.cu``: a weight-streaming GEMV at decode widths
(M <= 32) and, above, a TMA + wgmma GEMM whose warps convert each raw int8
weight tile to bf16 A fragments in registers (``csrc/ftcf_gemm.cuh``). With
``group_size`` G the weight carries fp32 group scales [K/G, N] inside the
contraction (the JAX package's group-wise int8 weights, which it computes in
XLA, ``ops/linear.py:65``): the W_I8G instances of both bodies, counted also
in ``launches_g8``. ``quant_matmul_plain`` is the same function in plain
PyTorch: the CPU path and the kernel's oracle.

Launch plans: the GEMV's K ranges (``split_ranges``) and the GEMM's block
tile, group-M raster and ring depth (``GemmPlan``) come from the tile cache
(``ops/tile_tuning.py``) where it holds this shape on this card, else from
the defaults below (``gemv_splits``, ``gemm_plan``). Every wrapper of K1,
K3, K6-K8 and K13 resolves its plan through them; an entry the kernels cannot
serve raises.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from . import _cuda, tile_tuning
from .linear import ACT_CODES, apply_act

GEMV_MAX_M = 32  # widest x the weight-streaming path takes
GEMV_MAX_CHUNK = 3072  # K rows of a range the GEMV's x staging takes (csrc/ftcf_gemv.cuh)
# the prefill-width GEMM's default block (rows x columns) and its k tile, 64 in
# every instance (csrc/ftcf_gemm.cuh)
GEMM_BM, GEMM_BN, GEMM_BK = 128, 128, 64
# the block tiles (rows, columns) the GEMM has instances of (csrc/gemm_*.cu)
GEMM_TILES = ((128, 128), (64, 128), (128, 256), (256, 128))
GEMM_MAX_STAGES = 8

# (bits, group scales?, fp32 group scales?) -> csrc/ftcf_common.cuh WFmt, and
# each format's name in tile cache keys
WEIGHT_FORMATS = {(8, False, False): 0, (4, False, False): 1, (4, True, False): 2,
                  (8, True, True): 3, (4, True, True): 4}
FORMAT_NAMES = {0: "i8", 1: "i4", 2: "i4g", 3: "i8g", 4: "i4gf"}


def weight_format(bits, group_size, scale) -> int:
    """The kernels' format code of a weight with these scales."""
    grouped = bool(group_size)
    return WEIGHT_FORMATS[bits, grouped, grouped and scale.dtype == torch.float32]


def kernel_name(body: str, bits: int, group_size: int, scale) -> str:
    """A launch's kernel name in tile cache keys: body (``gemv``, ``gemm``,
    ``ncat_gemv``, ``ncat_gemm``, ``pd_gemv``) and weight format."""
    return f"{body}_{FORMAT_NAMES[weight_format(bits, group_size, scale)]}"


@dataclass(frozen=True)
class GemmPlan:
    """The prefill-width GEMM's launch plan (csrc/ftcf_gemm_plan.cuh)."""
    rows: int = GEMM_BM  # rows of x a block
    cols: int = GEMM_BN  # output channels a block
    group_m: int = 8  # row tiles a group of blocks sweeps
    stages: int = GEMM_MAX_STAGES  # cap on the ring's stages

    def args(self) -> tuple:
        return self.rows, self.cols, self.group_m, self.stages


DEFAULT_GEMM = GemmPlan()


def quant_matmul_plain(
    x: torch.Tensor,  # [M, K]
    w: torch.Tensor,  # [K, N] int8
    scale: torch.Tensor,  # [N] fp32, or [K/G, N] with group_size G
    bias: Optional[torch.Tensor] = None,  # [N]
    act: Optional[str] = None,
    group_size: int = 0,
) -> torch.Tensor:
    """fp32 contraction; scale, bias and activation on the fp32 result; one
    rounding to x's dtype at the end. Group scales multiply the weight
    (``w * scale[k // G]`` in fp32) before the contraction."""
    if group_size:
        K, N = w.shape
        wd = w.float().reshape(K // group_size, group_size, N) * scale.float()[:, None, :]
        y = x.float() @ wd.reshape(K, N)
    else:
        y = (x.float() @ w.float()) * scale.float()
    if bias is not None:
        y = y + bias.float()
    if act is not None:
        y = apply_act(y, act)
    return y.to(x.dtype)


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def split_ranges(K: int, N: int, sms: int, share: float = 1.0, bits: int = 8,
                 group_size: int = 0) -> tuple[int, int]:
    """The default K ranges of the weight-streaming GEMV (csrc/ftcf_gemv.cuh)
    for one segment on a card of ``sms`` SMs: ``(splits, chunk)``, ``chunk``
    K rows a range (the last one may be shorter); the kernel takes both as
    given. About four blocks per SM over the whole grid (``share`` is this
    segment's part of it) of 128-column tiles, at most 1024 K rows per range,
    at least 32 weight byte rows (one per k lane; an int4 byte row holds two
    K rows); then ``split_chunk``."""
    rows = K // 2 if bits == 4 else K
    max_rows = 512 if bits == 4 else 1024
    tiles = -(-N // 128)
    splits = max(-(-rows // max_rows), math.ceil(4 * sms * share / tiles))
    splits = max(1, min(splits, -(-rows // 32)))
    return split_chunk(K, splits, group_size)


def split_chunk(K: int, splits: int, group_size: int = 0) -> tuple[int, int]:
    """K in about ``splits`` ranges: ``(splits, chunk)``. A range is a whole
    number of units: 8 K rows (the x staging's 16-byte loads), and with group
    scales (G = ``group_size``) whole groups. The count then drops to the
    ranges that hold any, so no range is empty."""
    unit = math.lcm(8, group_size) if group_size else 8
    units = K // unit
    per = -(-units // min(splits, units))  # units a range
    return -(-units // per), unit * per


def gemv_ranges(K: int, N: int, device: torch.device, share: float = 1.0, bits: int = 8,
                group_size: int = 0) -> tuple[int, int]:
    """``split_ranges`` on ``device``'s SM count."""
    return split_ranges(K, N, _sm_count(device.index or 0), share, bits, group_size)


def gemv_splits(kernel: str, M: int, segs: Sequence[tuple], device: torch.device, bits: int,
                group_size: int = 0) -> list:
    """Each segment's ``(splits, chunk)`` for a GEMV launch of ``kernel`` at M
    rows over ``segs`` = [(K, N, share), ...] (one segment, or K13's two
    joined over N, or K3's two joined over K). The tile cache's entry keys
    the launch by K and N summed over the segments' joined axis; its
    ``splits`` name each segment's count. On a miss, ``split_ranges``."""
    sms = _sm_count(device.index or 0)
    Ks, Ns = [sg[0] for sg in segs], [sg[1] for sg in segs]
    joined_k = kernel.startswith("pd_")
    key, e = tile_tuning.resolve(kernel, M, sum(Ks) if joined_k else Ks[0],
                                 Ns[0] if joined_k else sum(Ns), group_size, sms)
    if e is None:
        return [split_ranges(K, N, sms, share, bits, group_size) for K, N, share in segs]
    splits = e.get("splits")
    _cuda.require(isinstance(splits, list) and len(splits) == len(segs),
                  f"tile cache entry {key!r}: 'splits' must list one count a segment "
                  f"({len(segs)}), got {splits!r}")
    out = []
    for (K, _, _), n in zip(segs, splits):
        ranges = split_chunk(K, n, group_size) if isinstance(n, int) and n >= 1 else None
        _cuda.require(ranges is not None and ranges[0] == n and ranges[1] <= GEMV_MAX_CHUNK,
                      f"tile cache entry {key!r}: {n!r} splits of K={K} is not a split the "
                      f"GEMV has: ranges of whole units of at most {GEMV_MAX_CHUNK} rows, "
                      f"none empty")
        out.append(ranges)
    return out


def gemm_plan(kernel: str, M: int, K: int, N: int, group_size: int,
              device: torch.device) -> GemmPlan:
    """The GEMM's plan for a launch of ``kernel`` at M rows (K13: ``N`` = N1 +
    N2): the tile cache's entry, else ``DEFAULT_GEMM``."""
    key, e = tile_tuning.resolve(kernel, M, K, N, group_size, _sm_count(device.index or 0))
    if e is None:
        return DEFAULT_GEMM
    plan = GemmPlan(e.get("rows"), e.get("bn"), e.get("group_m"), e.get("stages"))
    _cuda.require(
        (plan.rows, plan.cols) in GEMM_TILES and e.get("bk") == GEMM_BK
        and isinstance(plan.group_m, int) and plan.group_m >= 1
        and isinstance(plan.stages, int) and 2 <= plan.stages <= GEMM_MAX_STAGES,
        f"tile cache entry {key!r} names a GEMM plan the kernel has no instance for: rows "
        f"{plan.rows} x bn {plan.cols} (instances {GEMM_TILES}), bk {e.get('bk')} (only "
        f"{GEMM_BK}), group_m {plan.group_m}, stages {plan.stages} (2-{GEMM_MAX_STAGES})")
    return plan


def gemm_tiles(M: int, N1: int, N2: int = 0, plan: GemmPlan = DEFAULT_GEMM) -> int:
    """Blocks of one prefill-width GEMM launch over segments of N1 and N2
    columns (K13 joins two) under ``plan``: its rows x cols output tiles,
    each segment's own."""
    return -(-M // plan.rows) * (-(-N1 // plan.cols) + -(-N2 // plan.cols))


def gemm_group_rows(K: int, G: int) -> int:
    """Group-scale rows the GEMM's TMA brings with each 64-deep k tile (the
    k tile of every block tile): the most groups of G rows any k tile of K
    touches (csrc/ftcf_gemm.cuh ``gemm_group_rows``, the same rule)."""
    return max((min(k0 + GEMM_BK, K) - 1) // G - k0 // G + 1 for k0 in range(0, K, GEMM_BK))


def check_operands(x, w, scale, bias, name, bits=8, group_size=0):
    """Raise on what the kernels do not take (shared with K2/K3/K13 and K6-K8):
    x a contiguous bf16 [M, K]; w a contiguous int8 [K, N], or for ``bits=4``
    the packed [K/2, N]; scale a contiguous fp32 [N], or with ``group_size``
    G a contiguous, 16-byte aligned [K/G, N], bf16 or fp32 for int4 and fp32
    for int8 (``ckpt.quantize.group_scale_dtype``); bias a contiguous
    bf16/fp32 [N]."""
    req = _cuda.require
    dev = x.device
    req(x.dtype == torch.bfloat16, f"{name}: x must be bf16, got {x.dtype}")
    req(x.ndim == 2 and x.is_contiguous(), f"{name}: x must be a contiguous [M, K]")
    req(bits in (8, 4), f"{name}: bits must be 8 or 4, got {bits}")
    req(w.dtype == torch.int8 and w.ndim == 2 and w.is_contiguous(),
        f"{name}: w must be a contiguous int8 [{'K/2' if bits == 4 else 'K'}, N]")
    K = x.shape[1]
    N = w.shape[1]
    req(w.shape[0] * (2 if bits == 4 else 1) == K,
        f"{name}: x {tuple(x.shape)} vs {bits}-bit w {tuple(w.shape)}")
    req(K % 8 == 0 and N % 16 == 0, f"{name}: needs K % 8 == 0 and N % 16 == 0")
    req(x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0, f"{name}: x, w not 16-byte aligned")
    if group_size:
        sdt = (torch.bfloat16, torch.float32) if bits == 4 else (torch.float32,)
        req(group_size % 2 == 0 and K % group_size == 0,
            f"{name}: group size {group_size} must be even and divide K={K}")
        req(not 1 < x.shape[0] <= GEMV_MAX_M or group_size % 16 == 0,
            f"{name}: the GEMV at 2-{GEMV_MAX_M} rows takes groups of whole 16-row steps, "
            f"not {group_size}")
        req(scale.dtype in sdt and scale.shape == (K // group_size, N)
            and scale.is_contiguous() and scale.data_ptr() % 16 == 0,
            f"{name}: {bits}-bit group scale must be a contiguous, 16-byte aligned "
            f"{' or '.join(map(str, sdt))} [K/G, N]")
    else:
        req(scale.dtype == torch.float32 and scale.shape == (N,) and scale.is_contiguous(),
            f"{name}: scale must be a contiguous fp32 [N]")
    if bias is not None:
        req(bias.dtype in (torch.bfloat16, torch.float32) and bias.shape == (N,)
            and bias.is_contiguous(), f"{name}: bias must be a contiguous bf16/fp32 [N]")
    for t in (w, scale, bias):
        req(t is None or t.device == dev, f"{name}: operands on different devices")


def _scale_args(scale, group_size):
    """(scale, gscale, G) of K1's C entries: per-channel scales with G = 0,
    else the [K/G, N] group scales."""
    if group_size:
        return None, scale.data_ptr(), group_size
    return scale.data_ptr(), None, 0


def _bias_args(bias, act):
    return _cuda.ptr(bias), int(bias is not None and bias.dtype == torch.bfloat16), ACT_CODES[act]


def launch_gemv(x, w, scale, bias, act, out, group_size=0):
    """One int8 weight-streaming GEMV launch (partials + epilogue) into
    ``out``, its K ranges from ``gemv_splits``; ``group_size`` G: ``scale``
    the [K/G, N] group scales. No launch count: the public wrappers count
    their own launches."""
    M, K = x.shape
    N = w.shape[1]
    [(splits, chunk)] = gemv_splits(kernel_name("gemv", 8, group_size, scale), M,
                                    [(K, N, 1.0)], x.device, 8, group_size)
    ws = torch.empty(splits * M * N, dtype=torch.float32, device=x.device)
    err = _cuda.lib().ftcf_quant_matmul_gemv(
        x.data_ptr(), w.data_ptr(), *_scale_args(scale, group_size), M, K, N, splits, chunk,
        *_bias_args(bias, act), out.data_ptr(), ws.data_ptr(), _cuda.stream_of(x),
    )
    _cuda.check(err, "quant_matmul (gemv)")
    return out


def quant_matmul(
    x: torch.Tensor,  # [M, K] bf16
    w: torch.Tensor,  # [K, N] int8 (a layer's view of the stacked weight)
    scale: torch.Tensor,  # [N] fp32, or [K/G, N] fp32 with group_size G
    bias: Optional[torch.Tensor] = None,  # [N] bf16 or fp32
    act: Optional[str] = None,
    group_size: int = 0,
) -> torch.Tensor:
    """K1: ``act(x @ w * scale + bias)``, [M, N] in x's dtype; with
    ``group_size`` G each K group's scale row multiplies its part of the
    sum. A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises."""
    if not x.is_cuda:
        return quant_matmul_plain(x, w, scale, bias, act, group_size)
    check_operands(x, w, scale, bias, "quant_matmul", group_size=group_size)
    _cuda.require(act in ACT_CODES, f"quant_matmul: unknown activation {act!r}")
    M, K = x.shape
    N = w.shape[1]
    y = torch.empty(M, N, dtype=torch.bfloat16, device=x.device)
    if M <= GEMV_MAX_M:
        launch_gemv(x, w, scale, bias, act, y, group_size)
    else:
        plan = gemm_plan(kernel_name("gemm", 8, group_size, scale), M, K, N, group_size,
                         x.device)
        err = _cuda.lib().ftcf_quant_matmul_gemm(
            x.data_ptr(), w.data_ptr(), *_scale_args(scale, group_size), M, K, N,
            *_bias_args(bias, act), y.data_ptr(), *plan.args(), _cuda.stream_of(x),
        )
        _cuda.check(err, "quant_matmul (gemm)")
    quant_matmul.launches += 1
    quant_matmul.launches_g8 += bool(group_size)
    return y


quant_matmul.launches = 0
quant_matmul.launches_g8 = 0  # of them, on int8 weights with group scales
