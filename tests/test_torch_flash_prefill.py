"""K5, the port's causal prefill flash attention (fastertransformer4codefuse_tpu_torch/
ops/attention.py prefill_attention_flash, CUDA in csrc/prefill_flash.cu): its
plain version against the JAX package's prefill paths, and the dispatch that
sends CUDA tensors to the kernel.

Tolerances: against the JAX Pallas flash kernel in interpret mode (bf16
inputs, tests/test_flash_prefill.py's cases) within 5e-2 on the valid rows
(the kernel's pads attend only pads there, and no caller reads them);
against the JAX XLA prefill (fp32) within 1e-5 on every row, MHA and GQA
(summation order only).

K5's gradient (fp32, the training path): the plain version differentiated by
autograd against ``jax.grad`` of the JAX package's K5 (the library Pallas
flash_attention, whose backward is its dK/dV and dQ kernels) in interpret
mode, full lengths, within 1e-4 of max |grad| (summation order over S
keys); against ``jax.grad`` of the XLA prefill with lengths below S and GQA
within 1e-5; the backward kernels' plain version (``prefill_flash_bwd_plain``,
from lse and delta) against autograd within 1e-5; and ``PrefillFlash``'s
plumbing (delta, the operands handed to the two backward kernels, the
gradients' order) with the launches replaced by their plain versions."""
import numpy as np
import pytest
import torch

import jax
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
        (torch.zeros(1, 8, 2, 128, dtype=torch.float16), lens),  # fp16 (bf16 and fp32 are served)
        (torch.zeros(1, 8, 2, 128, dtype=torch.bfloat16), lens.long()),  # int64 lengths
    ]
    for q, ln in bad:
        with pytest.raises(ValueError):
            att.prefill_attention_flash(_on_card(q), q, q, ln, 0.1)
    q = torch.zeros(1, 8, 3, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple"):
        att.prefill_attention_flash(_on_card(q), q[:, :, :2], q[:, :, :2], lens, 0.1)


def _grad_case(rng, B, S, nH, nKV, dh):
    q = rng.standard_normal((B, S, nH, dh)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, nKV, dh)).astype(np.float32) for _ in range(2))
    ct = rng.standard_normal((B, S, nH, dh)).astype(np.float32)
    return q, k, v, ct


def _port_grads(q, k, v, ct, lengths, sm):
    """d sum(out * ct) / d (q, k, v) of the port's K5 on the CPU (autograd of
    the plain version)."""
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = att.prefill_attention_flash(tq, tk, tv, torch.tensor(lengths, dtype=torch.int32), sm)
    (out * torch.from_numpy(ct)).sum().backward()
    return [t.grad.numpy() for t in (tq, tk, tv)]


def _close_to_max(got, want, tol):
    for g, w, name in zip(got, want, "qkv"):
        err = np.abs(g - np.asarray(w)).max() / np.abs(np.asarray(w)).max()
        assert err <= tol, (name, err)


@pytest.mark.parametrize("S", [256, 2048])
def test_k5_gradient_matches_the_jax_flash_backward_interpret(S):
    """The library kernel's dK/dV and dQ kernels run in interpret mode."""
    rng = np.random.default_rng(3)
    q, k, v, ct = _grad_case(rng, 1, S, 2, 2, 64)
    sm = 1.0 / 8.0
    lens = jnp.asarray([S], jnp.int32)

    def loss(a, b, c):
        return jnp.sum(jatt.prefill_attention_flash(a, b, c, lens, sm) * ct)

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    _close_to_max(_port_grads(q, k, v, ct, [S], sm), want, 1e-4)


@pytest.mark.parametrize("nH,nKV", [(4, 4), (4, 2)])
def test_k5_gradient_matches_jax_xla_with_lengths_and_gqa(nH, nKV):
    rng = np.random.default_rng(4)
    B, S, dh = 3, 128, 16
    lengths = [128, 70, 1]
    q, k, v, ct = _grad_case(rng, B, S, nH, nKV, dh)
    sm = 1.0 / 4.0
    mask = jatt.make_prefill_mask(jnp.asarray(lengths, jnp.int32), S)

    def loss(a, b, c):
        return jnp.sum(jatt.prefill_attention(a, b, c, mask, sm) * ct)

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    _close_to_max(_port_grads(q, k, v, ct, lengths, sm), want, 1e-5)


@pytest.mark.parametrize("nH,nKV,dh", [(2, 2, 64), (4, 1, 16)])
def test_k5_backward_plain_from_lse_and_delta_equals_autograd(nH, nKV, dh):
    """What the dK/dV and dQ kernels compute, from the forward's lse and
    delta = rowsum(dO * O), is the gradient of the plain forward; so are the
    CPU paths of their wrappers."""
    rng = np.random.default_rng(5)
    B, S = 2, 96
    lengths = torch.tensor([96, 40], dtype=torch.int32)
    q, k, v, ct = (torch.from_numpy(x) for x in _grad_case(rng, B, S, nH, nKV, dh))
    sm = dh ** -0.5
    want = _port_grads(*(x.numpy() for x in (q, k, v, ct)), lengths.tolist(), sm)
    out = att.prefill_attention_flash_plain(q, k, v, lengths, sm)
    lse = att.prefill_flash_lse_plain(q, k, lengths, sm)
    assert lse.shape == (B, nH, S)
    delta = (ct * out).sum(-1).transpose(1, 2).contiguous()
    got = att.prefill_flash_bwd_plain(q, k, v, ct, lse, delta, lengths, sm)
    _close_to_max([g.numpy() for g in got], want, 1e-5)
    dk, dv = att.prefill_flash_bwd_dkv(q, k, v, ct, lse, delta, lengths, sm)
    dq = att.prefill_flash_bwd_dq(q, k, v, ct, lse, delta, lengths, sm)
    for a, b in zip((dq, dk, dv), got):
        assert torch.equal(a, b)


def _tf32_rna(x):
    """fp32 -> TF32 (10 mantissa bits) rounded to nearest, ties away from
    zero, as ``cvt.rna.tf32.f32``: by integer ops on the float's bits, half
    a unit of the 13 dropped bits added to the magnitude, then cleared."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _tf32_einsum(terms):
    """A plain model of the backward kernels' product (csrc/ftcf_mma.cuh):
    each operand split into big = rna(x) and small = rna(x - big), and
    big*big + big*small + small*big summed in fp32 (``terms`` 3), or the
    one-term TF32 product big*big (``terms`` 1). TF32 products are exact in
    fp32, so each einsum is the tensor cores' partial sum."""
    def einsum(eq, a, b):
        ab, bb = _tf32_rna(a), _tf32_rna(b)
        out = torch.einsum(eq, ab, bb)
        if terms == 3:
            out = (torch.einsum(eq, ab, _tf32_rna(b - bb))
                   + torch.einsum(eq, _tf32_rna(a - ab), bb)) + out
        return out

    return einsum


@pytest.mark.parametrize("B,S,nH,nKV,dh,lens", [(2, 256, 4, 2, 64, [256, 150]),
                                                (2, 200, 4, 1, 128, [200, 77]),
                                                (1, 160, 2, 2, 128, [97])])
def test_k5_backward_3xtf32_holds_fp32(B, S, nH, nKV, dh, lens):
    """Why the backward kernels multiply in 3xTF32 and not TF32: the plain
    backward with every one of its five products made the 3xTF32 way stays
    within 1e-4 of max |fp32 plain| in dq, dk and dv (lengths below S, GQA,
    dh 64 and 128); the one-term TF32 product lands farther from fp32."""
    rng = np.random.default_rng(8)
    q, k, v, ct = (torch.from_numpy(x) for x in _grad_case(rng, B, S, nH, nKV, dh))
    lengths = torch.tensor(lens, dtype=torch.int32)
    sm = dh ** -0.5
    out = att.prefill_attention_flash_plain(q, k, v, lengths, sm)
    lse = att.prefill_flash_lse_plain(q, k, lengths, sm)
    delta = (ct * out).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, ct, lse, delta, lengths, sm)
    want = att.prefill_flash_bwd_plain(*args)
    x = torch.tensor([1.0 + 2 ** -12, 1.0 + 2 ** -11, -(1.0 + 3 * 2 ** -12)])
    assert _tf32_rna(x).tolist() == [1.0, 1.0 + 2 ** -10, -(1.0 + 2 ** -10)]  # a tie: away
    errs = {}
    for terms in (3, 1):
        got = att.prefill_flash_bwd_plain(*args, einsum=_tf32_einsum(terms))
        errs[terms] = [float((g - w).abs().max() / w.abs().max()) for g, w in zip(got, want)]
    assert max(errs[3]) < 1e-4, errs
    assert all(e1 > e3 for e1, e3 in zip(errs[1], errs[3])), errs


def test_prefill_flash_function_wires_the_backward_kernels(monkeypatch):
    """``PrefillFlash`` with each launch replaced by its plain version: the
    forward saves lse, the backward hands (q, k, v, dO, lse, delta) to the
    dK/dV and dQ kernels, and autograd gets (dq, dk, dv)."""
    rng = np.random.default_rng(6)
    B, S, nH, nKV, dh = 2, 64, 4, 2, 64
    lengths = torch.tensor([64, 33], dtype=torch.int32)
    q, k, v, ct = (torch.from_numpy(x) for x in _grad_case(rng, B, S, nH, nKV, dh))
    sm = 0.125
    seen = []

    def fwd(q, k, v, lens, scale):
        return (att.prefill_attention_flash_plain(q, k, v, lens, scale),
                att.prefill_flash_lse_plain(q, k, lens, scale))

    def dkv(*a):
        seen.append("dkv")
        return att.prefill_flash_bwd_plain(*a)[1:]

    def dq(*a):
        seen.append("dq")
        return att.prefill_flash_bwd_plain(*a)[0]

    monkeypatch.setattr(att, "prefill_flash_forward", fwd)
    monkeypatch.setattr(att, "prefill_flash_bwd_dkv", dkv)
    monkeypatch.setattr(att, "prefill_flash_bwd_dq", dq)
    tq, tk, tv = (t.clone().requires_grad_() for t in (q, k, v))
    out = att.PrefillFlash.apply(tq, tk, tv, lengths, sm)
    (out * ct).sum().backward()
    assert seen == ["dkv", "dq"]
    want = _port_grads(*(x.numpy() for x in (q, k, v, ct)), lengths.tolist(), sm)
    _close_to_max([t.grad.numpy() for t in (tq, tk, tv)], want, 1e-5)


def test_k5_refuses_a_gradient_off_fp32():
    """A bf16 gradient has no backward kernel: the wrapper raises before any
    launch; without a gradient bf16 is served."""
    lens = torch.tensor([8], dtype=torch.int32)
    q = torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16, requires_grad=True)
    with pytest.raises(ValueError, match="fp32 only"):
        att.prefill_attention_flash(_on_card(q), q, q, lens, 0.1)
    k32 = torch.zeros(1, 8, 2, 64)
    with pytest.raises(ValueError, match="must be one of"):  # mixed dtypes
        att.prefill_attention_flash(_on_card(k32), k32, q.detach(), lens, 0.1)
