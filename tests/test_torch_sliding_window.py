"""K12, the port's banded sliding-window attention
(fastertransformer4codefuse_tpu_torch/ops/sliding_window.py, CUDA in
csrc/sliding_window.cu): its plain version against the JAX Pallas kernel in
interpret mode, and the dispatch that keeps CPU tensors on the plain version.

Tolerance: rtol 2e-5 / atol 2e-6 in fp32, the JAX test's own
(tests/test_longformer.py::test_sliding_window_kernel_matches_dense): the
two differ only in summation order (one dense softmax against the Pallas
kernel's online softmax over chunks)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fastertransformer4codefuse_tpu.ops.sliding_window import (
    sliding_window_attention as jax_swa,
)
from fastertransformer4codefuse_tpu_torch.ops import sliding_window as sw

torch.set_num_threads(2)


def _inputs(seed, B, S, nH, dh, lens):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, S, nH, dh).astype(np.float32) * 0.3
    k = rng.randn(B, S, nH, dh).astype(np.float32) * 0.3
    v = rng.randn(B, S, nH, dh).astype(np.float32)
    is_masked = np.arange(S)[None, :] >= np.asarray(lens)[:, None]
    return q, k, v, is_masked


def _port(q, k, v, w, is_masked, causal, chunk=128):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    return sw.sliding_window_attention(t(q), t(k), t(v), w, t(is_masked), chunk=chunk,
                                       causal=causal).numpy()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("chunk", [16, 128])
@pytest.mark.parametrize("w", [3, 16, 17, 64])
def test_k12_plain_matches_jax_interpret(causal, chunk, w):
    """S = 40 is not a multiple of chunk 16; w = 3 and 17 are not multiples
    of it, w = 64 is wider than S; the second row is padded from 23."""
    lens = [40, 23]
    q, k, v, is_masked = _inputs(0, 2, 40, 2, 16, lens)
    want = np.asarray(jax_swa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), w,
                              jnp.asarray(is_masked), chunk=chunk, interpret=True,
                              causal=causal))
    got = _port(q, k, v, w, is_masked, causal, chunk=chunk)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)
    assert not got[1, 23:].any()  # padded rows are 0


@pytest.mark.parametrize("causal", [False, True])
def test_k12_plain_ragged_batch_with_an_empty_row(causal):
    """Three rows: full, ragged at 9 (not a multiple of anything), and
    length 1, against JAX at the default chunk."""
    lens = [29, 9, 1]
    q, k, v, is_masked = _inputs(1, 3, 29, 3, 8, lens)
    want = np.asarray(jax_swa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 5,
                              jnp.asarray(is_masked), interpret=True, causal=causal))
    got = _port(q, k, v, 5, is_masked, causal)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)


def test_k12_plain_is_the_dense_band():
    """Against the band written out with numpy (the JAX test's oracle), and
    w = 0: each row returns its own value vector."""
    lens = np.array([40, 23])
    q, k, v, is_masked = _inputs(2, 2, 40, 4, 16, lens)
    i = np.arange(40)
    for w in (2, 7, 16):
        allow = (np.abs(i[:, None] - i[None, :]) <= w)[None] & ~is_masked[:, None, :]
        scores = np.einsum("bqhd,bkhd->bhqk", q, k)
        scores = np.where(allow[:, None], scores, np.finfo(np.float32).min)
        probs = np.exp(scores - scores.max(-1, keepdims=True))
        probs /= probs.sum(-1, keepdims=True)
        want = np.where(is_masked[:, :, None, None], 0.0, np.einsum("bhqk,bkhd->bqhd", probs, v))
        np.testing.assert_allclose(_port(q, k, v, w, is_masked, False), want, rtol=2e-5,
                                   atol=2e-6)
    got = _port(q, k, v, 0, is_masked, False)
    np.testing.assert_allclose(got, np.where(is_masked[:, :, None, None], 0.0, v), rtol=1e-6)


def test_k12_cpu_tensors_take_the_plain_version():
    """A CPU tensor never reaches the kernel: no launch is counted, and the
    result is the plain version's, bf16 in and out (probabilities rounded to
    bf16, as on the card)."""
    q, k, v, is_masked = _inputs(3, 2, 37, 2, 64, [37, 20])
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    m = torch.from_numpy(is_masked)
    before = (sw.sliding_window_attention.launches, sw.sliding_window_attention.launches_causal)
    for causal in (False, True):
        got = sw.sliding_window_attention(tq, tk, tv, 6, m, causal=causal)
        want = sw.sliding_window_attention_plain(tq, tk, tv, 6, m, causal=causal)
        assert got.dtype == torch.bfloat16 and got.shape == tq.shape
        assert torch.equal(got, want)
    assert (sw.sliding_window_attention.launches,
            sw.sliding_window_attention.launches_causal) == before


# The band's edges at the CUDA kernel's 128-key tiles (its blocks walk the
# band from their first row's first key, so a band edge may fall anywhere in
# a tile): w = 0, w not a multiple of 128 (130), w as wide as S and wider,
# lengths off the tile boundaries (129, 257), and an empty row (length 0).
BAND_EDGES = [
    (0, [300, 129]),
    (130, [300, 257]),
    (300, [300, 1]),
    (400, [257, 0]),
]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("w,lens", BAND_EDGES)
def test_k12_plain_at_the_band_edges_matches_jax_interpret(causal, w, lens):
    """S = 300 at the JAX kernel's default chunk (128, as the CUDA tiles):
    every row equals the JAX kernel's, padded and empty rows 0."""
    q, k, v, is_masked = _inputs(4, 2, 300, 2, 16, lens)
    want = np.asarray(jax_swa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), w,
                              jnp.asarray(is_masked), interpret=True, causal=causal))
    got = _port(q, k, v, w, is_masked, causal)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)
    for b, n in enumerate(lens):
        assert not got[b, n:].any()
