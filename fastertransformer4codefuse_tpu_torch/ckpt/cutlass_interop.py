"""CUTLASS mixed-GEMM weight-layout interop, pure numpy index math (port of
ckpt/cutlass_interop.py, the same functions).

The reference's pre-quantized checkpoints (``.q.bin``, written by its
``quant_and_save.py`` through ``symmetric_quantize_last_axis_of_batched_matrix``)
store each weight matrix CUTLASS-preprocessed for tensor-core LDSM loads, not
row-major. The pipeline (the reference's ``cutlass_preprocessors.cc``) is:

  1. ``permute_B_rows_for_mixed_gemm``: within each tile of 16 (int8) / 32
     (int4) rows, rows are index-selected by a fixed map.
  2. ``subbyte_transpose``: row-major [K, N] -> column-major (the buffer
     holds the transpose, flat = W.T).
  3. ``interleave_column_major_tensor``: 64-element row tiles of
     ``columns_interleaved`` = 2 (int8) / 4 (int4) consecutive columns are
     interleaved into one fat column.
  4. ``add_bias_and_interleave_quantized_tensor_inplace``: values are biased
     to unsigned (+128 int8 / +8 int4) and each 32-bit register's elements
     are shuffled ([e0 e2 e1 e3] for int8, [e0 e2 e4 e6 e1 e3 e5 e7] for
     int4, little-endian element order).

Every step is a permutation (plus an affine bias), so it inverts exactly.
``ckpt.loader`` undoes it with ``q_layout="cutlass"``.

All transforms run in element space: int4 payloads are unpacked to one int8
per nibble (low nibble = even element), transformed, and repacked.
"""
from __future__ import annotations

import numpy as np

# permute_B_rows_for_mixed_gemm row maps (out_row -> in_row within a tile)
PERM16 = np.array([0, 1, 8, 9, 2, 3, 10, 11, 4, 5, 12, 13, 6, 7, 14, 15])
PERM32 = np.array(
    [0, 1, 8, 9, 16, 17, 24, 25, 2, 3, 10, 11, 18, 19, 26, 27,
     4, 5, 12, 13, 20, 21, 28, 29, 6, 7, 14, 15, 22, 23, 30, 31]
)
# add_bias_and_interleave register shuffles in little-endian element order
REG8 = np.array([0, 2, 1, 3])
REG4 = np.array([0, 2, 4, 6, 1, 3, 5, 7])


def unpack_int4(packed: np.ndarray) -> np.ndarray:
    """Packed int4 bytes -> sign-extended int8 elements (low nibble first)."""
    p = packed.astype(np.int8)
    low = ((p << 4) & -16).astype(np.int8) >> 4  # double shift sign-extends
    high = p >> 4
    return np.stack([low, high], axis=-1).reshape(*packed.shape[:-1], -1)


def pack_int4(elts: np.ndarray) -> np.ndarray:
    """Int8 elements in [-8, 7] -> packed int4 bytes (low nibble = even elt)."""
    e = elts.reshape(*elts.shape[:-1], -1, 2).astype(np.uint8)
    return ((e[..., 0] & 0xF) | ((e[..., 1] & 0xF) << 4)).view(np.int8)


def permute_b_rows(w: np.ndarray, bits: int, inverse: bool = False) -> np.ndarray:
    """Step 1 on an element-space [K, N] matrix."""
    perm = PERM16 if bits == 8 else PERM32
    if inverse:
        perm = np.argsort(perm)
    K, N = w.shape
    return w.reshape(K // perm.size, perm.size, N)[:, perm, :].reshape(K, N)


def register_interleave(flat: np.ndarray, bits: int, inverse: bool = False) -> np.ndarray:
    """Step 4's 32-bit-register element shuffle on a flat element array."""
    reg = REG8 if bits == 8 else REG4
    if inverse:
        reg = np.argsort(reg)
    return flat.reshape(-1, reg.size)[:, reg].reshape(-1)


def add_bias_and_interleave(flat: np.ndarray, bits: int) -> np.ndarray:
    """Step 4 forward: signed elements -> biased-unsigned, register-shuffled."""
    bias = 128 if bits == 8 else 8
    out = register_interleave(flat, bits)
    return (out.astype(np.int16) + bias).astype(np.uint8)


def un_bias_and_interleave(flat: np.ndarray, bits: int) -> np.ndarray:
    """Step 4 inverse: biased-unsigned elements -> signed, unshuffled."""
    bias = 128 if bits == 8 else 8
    vals = (flat.astype(np.int16) - bias).astype(np.int8)
    return register_interleave(vals, bits, inverse=True)


def _column_interleave(cm: np.ndarray, K: int, N: int, bits: int,
                       inverse: bool = False) -> np.ndarray:
    """Step 3 on a flat element-space column-major buffer (length K*N).

    rows_per_column_tile is 64 *elements* for both widths (ThreadblockK=64),
    so tiles of 64 K-elements from `il` consecutive columns interleave.
    """
    il = 2 if bits == 8 else 4
    t = K // 64
    if not inverse:
        v = cm.reshape(N // il, il, t, 64)
        return v.transpose(0, 2, 1, 3).reshape(-1)
    v = cm.reshape(N // il, t, il, 64)
    return v.transpose(0, 2, 1, 3).reshape(-1)


def preprocess_weights_for_mixed_gemm(w: np.ndarray, bits: int = 8) -> np.ndarray:
    """Row-major quantized [K, N] int8 elements -> CUTLASS-processed payload.

    Returns the on-disk byte layout (int8 array of K*N*bits//8 bytes), i.e.
    what the reference writes to ``.q.bin``.
    """
    K, N = w.shape
    tile = 16 if bits == 8 else 32
    il = 2 if bits == 8 else 4
    del tile, il  # constraints: permute tile + 64-row col tiles; MMA_SHAPE_N=8
    assert K % 64 == 0 and N % 8 == 0, (K, N, bits)
    x = permute_b_rows(w.astype(np.int8), bits)
    cm = np.ascontiguousarray(x.T).reshape(-1)  # subbyte transpose
    cm = _column_interleave(cm, K, N, bits)
    u = add_bias_and_interleave(cm, bits)
    if bits == 8:
        return u.view(np.int8)
    return pack_int4(u.view(np.int8))


def unpreprocess_weights(raw: np.ndarray, K: int, N: int, bits: int = 8) -> np.ndarray:
    """Inverse of :func:`preprocess_weights_for_mixed_gemm`.

    ``raw``: flat int8 payload as read from a reference ``.q.bin``.
    Returns the plain row-major [K, N] int8 element matrix.
    """
    raw = raw.reshape(-1)
    if bits == 8:
        elts = raw.view(np.uint8)
    else:
        b = raw.view(np.uint8)
        elts = np.stack([b & 0xF, b >> 4], axis=-1).reshape(-1)
    assert elts.size == K * N, (elts.size, K, N)
    cm = un_bias_and_interleave(elts, bits)
    cm = _column_interleave(cm, K, N, bits, inverse=True)
    x = np.ascontiguousarray(cm.reshape(N, K).T)  # undo subbyte transpose
    return permute_b_rows(x, bits, inverse=True)
