"""The kept set of the JAX package's samplers, read through their draws.

``sample_top_k_top_p`` and ``sample_top_k_top_p_capped`` filter the logits
inside and return only the drawn token. With the Gumbel noise replaced by a
large bump at one position, a draw returns that position's id when the
filter kept it and another kept id when it did not; so the ids drawn over
one probe per position are exactly the kept set.
"""
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np

from fastertransformer4codefuse_tpu.sampling import sample as jsample


def _bump(key, shape, dtype=jnp.float32):
    # the probe's position rides in the second word of its legacy PRNG key
    return jnp.where(jnp.arange(shape[0]) == key[1] % shape[0], 1e4, 0.0).astype(dtype)


def jax_kept(logits, top_k, top_p, cap: int = 0) -> np.ndarray:
    """[B, V] bool: the ids the JAX full-sort sampler (``cap`` 0) or its
    capped path (``lax.top_k`` of ``cap``) may draw from each row of
    ``logits`` [B, V] under per-row ``top_k`` / ``top_p``."""
    logits = np.asarray(logits, np.float32)
    B, V = logits.shape
    n = min(cap, V) if cap else V
    rows = np.repeat(logits, n, axis=0)
    keys = jnp.asarray(np.stack([np.zeros(B * n, np.uint32),
                                 np.tile(np.arange(n, dtype=np.uint32), B)], axis=1))
    k = jnp.asarray(np.repeat(np.asarray(top_k, np.int32), n))
    p = jnp.asarray(np.repeat(np.asarray(top_p, np.float32), n))
    with mock.patch.object(jax.random, "gumbel", _bump):
        if cap:
            res = jsample.sample_top_k_top_p_capped(keys, jnp.asarray(rows), k, p, cap=cap,
                                                    need_log_probs=False)
        else:
            res = jsample.sample_top_k_top_p(keys, jnp.asarray(rows), k, p, need_log_probs=False)
    drawn = np.asarray(res.tokens).reshape(B, n)
    kept = np.zeros((B, V), bool)
    for b in range(B):
        kept[b, drawn[b]] = True
    return kept
