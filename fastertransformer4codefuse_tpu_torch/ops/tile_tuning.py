"""Kernel tile autotune cache: the analog of the reference's gemm_config.in
(src/fastertransformer/utils/cublasAlgoMap.h:30-94 loads the per-shape best
cuBLAS algo recorded offline by gpt_gemm, utils/gemm_test/gpt_gemm_func.cc).

Port of the JAX package's ``ops/tile_tuning.py``, with its interface and key
format (``kernel|bm{b}|k{K}|n{N}|g{G}``) and its two variables:
``FTCF_TILE_CACHE=<path>`` points at a different cache file;
``FTCF_TILE_TUNE=0`` disables lookups entirely (defaults only). A copy, not an
import: the JAX package's ``__init__`` imports jax.

The port's tunables are the launch plans of its weight-only kernels,
recorded on the card by ``python -m fastertransformer4codefuse_tpu_torch.ops.
tile_autotune`` into ``tile_cache.json`` next to this module:

- ``b``: the M bucket, the next power of two of M from 1 to 4096 (``bucket``);
  the GEMV serves M <= 32, the GEMM the rest;
- ``kernel``: the body and the weight format, e.g. ``gemv_i8``, ``gemv_i4g``,
  ``gemm_i8``, ``ncat_gemv_i8`` / ``ncat_gemm_i4g`` (K13: two segments joined
  over N, ``N`` = N1 + N2) and ``pd_gemv_i8`` (K3: two segments joined over
  K, ``K`` = K1 + K2);
- a GEMV entry's ``splits``: the K ranges of each segment
  (``ops/quant_matmul.py split_chunk``); a GEMM entry's block tile (``rows``
  x ``bn`` output channels, ``bk`` 64), ``group_m`` and ``stages``.

Each entry also carries the card's name, power limit and SM count
(``card``, ``power_limit``, ``sms``), its time ``us`` and the default plan's
``default_us``. An entry recorded on a card with another SM count is a miss;
a miss launches the default plan. The kernels' wrappers resolve a plan
through ``resolve``, which counts ``hits`` and ``misses`` per kernel name.
"""
from __future__ import annotations

import json
import os
import threading
from collections import Counter
from typing import Optional, Tuple

_DEFAULT_PATH = os.path.join(os.path.dirname(__file__), "tile_cache.json")
_cache: Optional[dict] = None
_lock = threading.Lock()

MAX_BUCKET = 4096
# kernel name -> launches whose plan came from the cache / from the default
hits: Counter = Counter()
misses: Counter = Counter()


def cache_path() -> str:
    return os.environ.get("FTCF_TILE_CACHE") or _DEFAULT_PATH


def _key(kernel: str, bm: int, K: int, N: int, G: int) -> str:
    return f"{kernel}|bm{bm}|k{K}|n{N}|g{G}"


def _load() -> dict:
    global _cache
    if _cache is None:
        with _lock:
            if _cache is None:
                try:
                    with open(cache_path()) as f:
                        _cache = json.load(f)
                except (OSError, ValueError):
                    _cache = {}
    return _cache


def invalidate() -> None:
    """Drop the in-process cache (after record() or an env-path change)."""
    global _cache
    _cache = None


def enabled() -> bool:
    return os.environ.get("FTCF_TILE_TUNE", "1") != "0"


def bucket(M: int) -> int:
    """The M bucket of a launch: the next power of two of M, 1 to 4096."""
    return min(1 << max(int(M) - 1, 0).bit_length(), MAX_BUCKET)


def lookup(
    kernel: str, bm: int, K: int, N: int, G: int = 0
) -> Optional[Tuple[int, int]]:
    """Measured (bn, bk) for this kernel/shape, or None (use defaults)."""
    e = lookup_entry(kernel, bm, K, N, G)
    if not e:
        return None
    return int(e["bn"]), int(e["bk"])


def lookup_entry(
    kernel: str, bm: int, K: int, N: int, G: int = 0, sms: Optional[int] = None
) -> Optional[dict]:
    """Raw cache entry, or None. With ``sms`` (the card's SM count) an entry
    recorded on a card of another count, or with none, is a miss."""
    if not enabled():
        return None
    e = _load().get(_key(kernel, bm, K, N, G))
    if e is not None and sms is not None and e.get("sms") != sms:
        return None
    return e


def resolve(kernel: str, M: int, K: int, N: int, G: int, sms: int) -> Tuple[str, Optional[dict]]:
    """(key, entry or None) of a launch at M rows on a card of ``sms`` SMs,
    counted in ``hits`` or ``misses``."""
    bm = bucket(M)
    e = lookup_entry(kernel, bm, K, N, G, sms)
    (hits if e is not None else misses)[kernel] += 1
    return _key(kernel, bm, K, N, G), e


def record(
    kernel: str, bm: int, K: int, N: int, G: int,
    bn: int = 0, bk: int = 0, us: float = 0.0, note: str = "",
    path: Optional[str] = None, extra: Optional[dict] = None,
) -> None:
    """Persist a measured winner (sweep-tool entry point). ``extra`` holds
    kernel-specific fields beyond (bn, bk)."""
    path = path or cache_path()
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError):
        data = {}
    e = {"bn": int(bn), "bk": int(bk), "us": round(float(us), 2), "note": note}
    if extra:
        e.update(extra)
    data[_key(kernel, bm, K, N, G)] = e
    with open(path, "w") as f:
        json.dump(data, f, indent=1, sort_keys=True)
        f.write("\n")
    invalidate()
