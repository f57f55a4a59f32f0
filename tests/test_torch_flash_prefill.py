"""K5, the port's causal prefill flash attention (fastertransformer4codefuse_tpu_torch/
ops/attention.py prefill_attention_flash, CUDA in csrc/prefill_flash.cu): its
plain version against the JAX package's prefill paths, and the dispatch that
sends CUDA tensors to the kernel.

Tolerances: against the JAX Pallas flash kernel in interpret mode (bf16
inputs, tests/test_flash_prefill.py's cases) within 5e-2 on the valid rows
(the kernel's pads attend only pads there, and no caller reads them);
against the JAX XLA prefill (fp32) within 1e-5 on every row, MHA and GQA
(summation order only)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from fastertransformer4codefuse_tpu.ops import attention as jatt
from fastertransformer4codefuse_tpu_torch.ops import attention as att

torch.set_num_threads(2)


@pytest.mark.parametrize("B,S,lengths", [(1, 2048, [2048]), (2, 2048, [2048, 1300])])
def test_k5_plain_matches_jax_flash_interpret(B, S, lengths):
    rng = np.random.default_rng(0)
    nH, dh = 1, 128
    a = [rng.standard_normal((B, S, nH, dh)).astype(np.float32) for _ in range(3)]
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in a)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in a)
    sm = 1.0 / float(np.sqrt(dh))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jatt.prefill_attention_flash(
            jq, jk, jv, jnp.asarray(lengths, jnp.int32), sm).astype(jnp.float32))
    got = att.prefill_attention_flash(tq, tk, tv, torch.tensor(lengths, dtype=torch.int32), sm)
    assert got.dtype == torch.bfloat16 and got.shape == (B, S, nH, dh)
    got = got.float().numpy()
    for b, n in enumerate(lengths):
        assert np.abs(got[b, :n] - want[b, :n]).max() < 5e-2, b


@pytest.mark.parametrize("nH,nKV", [(4, 4), (4, 2)])
def test_k5_plain_matches_jax_xla_on_every_row(nH, nKV):
    """Rows past a row's length attend its valid prefix in both."""
    rng = np.random.default_rng(1)
    B, S, dh = 3, 256, 16
    lengths = np.array([256, 100, 1], np.int32)
    q = rng.standard_normal((B, S, nH, dh)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, nKV, dh)).astype(np.float32) for _ in range(2))
    sm = 1.0 / float(np.sqrt(dh))
    jl = jnp.asarray(lengths)
    want = jatt.prefill_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  jatt.make_prefill_mask(jl, S), sm)
    tl = torch.from_numpy(lengths)
    got = att.prefill_attention_flash(*map(torch.from_numpy, (q, k, v)), tl, sm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # the model's call (no mask: the plain path builds it from the lengths)
    again = att.prefill_attention(*map(torch.from_numpy, (q, k, v)), None, sm, tl)
    assert torch.equal(again, got)


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself on the card, to follow the dispatch."""

    @property
    def is_cuda(self):
        return True


def _on_card(t):
    return torch.Tensor._make_subclass(_OnCard, t)


def test_dispatch_sends_cuda_tensors_with_lengths_to_k5(monkeypatch):
    calls = []
    monkeypatch.setattr(att, "prefill_attention_flash",
                        lambda *a: calls.append(a) or a[0])
    q = torch.zeros(1, 8, 2, 128, dtype=torch.bfloat16)
    lens = torch.tensor([5], dtype=torch.int32)
    mask = att.make_prefill_mask(lens, 8)
    att.prefill_attention(_on_card(q), q, q, None, 0.1, lens)
    assert len(calls) == 1  # CUDA with lengths: K5, at any S (no S >= 2048 gate)
    att.prefill_attention(q, q, q, None, 0.1, lens)
    att.prefill_attention(q, q, q, mask, 0.1)
    assert len(calls) == 1  # CPU tensors take the plain math


def test_k5_raises_on_what_it_does_not_take():
    """On a CUDA tensor the wrapper launches K5 or raises: these never reach
    the library."""
    lens = torch.tensor([8], dtype=torch.int32)
    bad = [
        (torch.zeros(1, 8, 2, 96, dtype=torch.bfloat16), lens),  # dh 96 (64 is served)
        (torch.zeros(1, 8, 2, 128), lens),  # fp32
        (torch.zeros(1, 8, 2, 128, dtype=torch.bfloat16), lens.long()),  # int64 lengths
    ]
    for q, ln in bad:
        with pytest.raises(ValueError):
            att.prefill_attention_flash(_on_card(q), q, q, ln, 0.1)
    q = torch.zeros(1, 8, 3, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple"):
        att.prefill_attention_flash(_on_card(q), q[:, :, :2], q[:, :, :2], lens, 0.1)
