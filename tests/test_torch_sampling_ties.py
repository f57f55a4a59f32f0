"""Tied logits: each sampling filter of the port keeps the ids its JAX
counterpart keeps (ROADMAP queue 3, item 1).

The JAX full-sort path ranks by ``argsort(argsort(logits))[:, ::-1]``, so
among equal logits the higher id ranks first; its capped path takes
``lax.top_k``, the lower id first. The port's ``top_k_top_p_filter`` and
``top_k_top_p_filter_capped`` are held to the kept sets of
``sample_top_k_top_p`` and ``sample_top_k_top_p_capped`` read through their
draws (``jax_sample_probe``).
"""
import numpy as np
import torch
from hypothesis import given, settings, strategies as st

from fastertransformer4codefuse_tpu_torch.sampling.sample import (
    top_k_top_p_filter, top_k_top_p_filter_capped,
)
from jax_sample_probe import jax_kept

CAP = 64


def port_kept(logits, k, p, cap=0):
    t = torch.from_numpy(np.asarray(logits, np.float32))
    kt, pt = torch.from_numpy(np.asarray(k, np.int32)), torch.from_numpy(np.asarray(p, np.float32))
    if not cap:
        return (top_k_top_p_filter(t, kt, pt) > -1e30).numpy()
    masked, ids, _ = top_k_top_p_filter_capped(t, kt, pt, cap)
    kept = np.zeros(t.shape, bool)
    for b in range(t.shape[0]):
        kept[b, ids[b][masked[b] > -1e30].numpy()] = True
    return kept


def test_the_queue_case_keeps_the_jax_ids():
    """Logits [1, 64], zero except 1.0 at ids 0, 7, ..., 63; top_k 3, top_p 0:
    the full sort keeps {49, 56, 63}, the capped path {0, 7, 14}."""
    logits = np.zeros((1, 64), np.float32)
    logits[0, ::7] = 1.0
    for cap, want in ((0, [49, 56, 63]), (CAP, [0, 7, 14])):
        ref = jax_kept(logits, [3], [0.0], cap=cap)
        got = port_kept(logits, [3], [0.0], cap=cap)
        assert np.flatnonzero(ref[0]).tolist() == want
        np.testing.assert_array_equal(got, ref)


@settings(max_examples=40, deadline=None)
@given(
    V=st.sampled_from([16, 72]),  # two shapes: the JAX samplers compile once each
    levels=st.integers(1, 4),
    k=st.integers(1, CAP),
    p=st.sampled_from([0.0, 0.27, 0.55, 0.83]),
    seed=st.integers(0, 2 ** 31 - 1),
)
def test_tie_heavy_logits_keep_the_jax_sets(V, levels, k, p, seed):
    """Logits drawn from a few levels (many ties), any k <= cap and p: both
    port filters against both JAX samplers."""
    rows = 2
    rng = np.random.RandomState(seed)
    logits = rng.randint(0, levels, size=(rows, V)).astype(np.float32) * 0.75
    ks, ps = np.full(rows, min(k, V), np.int32), np.full(rows, p, np.float32)
    for cap in (0, CAP):
        np.testing.assert_array_equal(port_kept(logits, ks, ps, cap), jax_kept(logits, ks, ps,
                                                                               cap))
