"""The attention routes' head-dim predicates, the decode kernels' split plan,
and the configurations of chip_smoke.py ROUTE_CONFIGS, whose attention
shapes lie off the CodeFuse-13B path (a 64-wide head, 16 query heads a KV
head, a float paged pool on pages of 4, a 32-wide head), each served by the
port and held to the JAX engine token for token on the CPU (weights made by
the JAX package, carried over with ``from_jax_params``; fp32, int8 weights
and embeddings).

On the card, a head dim no kernel has an instance for (one the JAX package
sends to XLA too) goes to the plain version and counts in the dispatcher's
``plain_routes`` (tests/test_torch_kernels_cuda.py serves the same
configurations there); on the CPU every route is the plain one. Tolerance:
greedy tokens identical (fp32 on both sides, summation order only)."""
import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax

from chip_smoke import ROUTE_CONFIGS
from chip_smoke import ROUTE_PROMPTS as PROMPTS
from fastertransformer4codefuse_tpu import GptNeoXConfig as JaxConfig
from fastertransformer4codefuse_tpu import GptNeoXEngine as JaxEngine
from fastertransformer4codefuse_tpu import RuntimeConfig as JaxRuntime
from fastertransformer4codefuse_tpu import init_params as jax_init_params
from fastertransformer4codefuse_tpu.engine.batcher import ContinuousBatcher as JaxBatcher
from fastertransformer4codefuse_tpu_torch import (
    GptNeoXConfig,
    GptNeoXEngine,
    RuntimeConfig,
    from_jax_params,
)
from fastertransformer4codefuse_tpu_torch.engine.batcher import ContinuousBatcher
from fastertransformer4codefuse_tpu_torch.ops.attention import prefill_kernel_takes
from fastertransformer4codefuse_tpu_torch.ops.flash_decode import (
    KV_BF16,
    KV_FORMATS,
    KV_I4,
    KV_I8,
    chunk_kernel_takes,
    decode_kernel_takes,
    decode_split,
    decode_splits,
    decode_workspace,
)

torch.set_num_threads(2)


@pytest.mark.parametrize("dh,takes", [(64, True), (96, False), (128, True), (256, True),
                                      (32, False)])
def test_prefill_predicate(dh, takes):
    """K5 takes the head dims of the JAX package's flash kernel."""
    assert prefill_kernel_takes(dh) is takes


@pytest.mark.parametrize("dh,takes", [
    (64, True), (128, True), (256, True), (96, False), (32, False), (16, False),
    (80, False), (512, False), (0, False),
])
def test_decode_predicate(dh, takes):
    """K4/K9/K11 take dh 64, 128 and 256 (whatever g and KV format)."""
    assert decode_kernel_takes(dh) is takes


@pytest.mark.parametrize("dh,takes", [
    (128, True), (256, True), (64, False), (96, False), (32, False), (16, False),
    (80, False), (512, False), (192, False),
])
def test_chunk_predicate(dh, takes):
    """K10 takes dh 128 and 256, as the JAX package's chunk kernel (any
    page size and format)."""
    assert chunk_kernel_takes(dh) is takes


@pytest.mark.parametrize("dh,fmt,split", [
    (128, (KV_I8, KV_I8), 256), (128, (KV_BF16, KV_BF16), 128), (128, (KV_I4, KV_I4), 256),
    (128, (KV_I8, KV_I4), 256), (64, (KV_I4, KV_I4), 256), (64, (KV_BF16, KV_BF16), 256),
    (256, (KV_BF16, KV_BF16), 128), (256, (KV_I8, KV_I8), 128), (256, (KV_I4, KV_I4), 256),
])
def test_decode_split_sizes(dh, fmt, split):
    """256 positions a split, or 128 where 256 would hold more than 64 KB of
    K and V (the table the wrappers pass to csrc/flash_decode.cuh)."""
    assert decode_split(dh, *fmt) == split


@settings(max_examples=200, deadline=None)
@given(S=st.integers(1, 5000), dh=st.sampled_from([64, 128, 256]),
       fmt=st.sampled_from(KV_FORMATS), B=st.integers(1, 9), g=st.integers(1, 100))
def test_decode_splits_cover_each_position_once(S, dh, fmt, B, g):
    """Every position below S lies in exactly one split, the splits are
    fixed runs of decode_split positions, and the workspace holds the same
    splits for every row whatever the batch."""
    splits = decode_splits(S, dh, fmt)
    n = decode_split(dh, *fmt)
    covered = np.zeros(S, np.int64)
    for i, (a, b) in enumerate(splits):
        assert a == i * n and a < b <= min(a + n, S)
        covered[a:b] += 1
    assert (covered == 1).all()
    assert len(splits) == -(-S // n)
    per_row = g * (dh + 4) * 3 * len(splits)  # nKV = 3
    assert decode_workspace(B, 3, g, S, dh, *fmt, "cpu").numel() == B * per_row


def _models(name):
    jcfg = JaxConfig.tiny(vocab_size=128, activation="gelu-tanh", end_id=127,
                          **ROUTE_CONFIGS[name][0])
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0), dtype="fp32", int8_mode=1,
                         quantize_embeddings=True)
    cfg = GptNeoXConfig(**dataclasses.asdict(jcfg))
    return jcfg, jp, cfg, from_jax_params(jp, device="cpu")


@pytest.mark.parametrize("name,kv", [("dh64", "int8"), ("dh64", None), ("gqa16", "int8"),
                                     ("gqa16", "int4"), ("dh32", "int8")])
def test_static_greedy_matches_jax(name, kv):
    jcfg, jp, cfg, tp = _models(name)
    kw = dict(dtype="fp32", int8_mode=1, kv_cache_dtype=kv, seq_bucket=8)
    want = JaxEngine(jcfg, jp, JaxRuntime(**kw)).generate(PROMPTS, output_len=8, top_k=1)
    got = GptNeoXEngine(cfg, tp, RuntimeConfig(**kw)).generate(PROMPTS, output_len=8, top_k=1)
    np.testing.assert_array_equal(got.output_ids, want.output_ids)
    np.testing.assert_array_equal(got.sequence_lengths, want.sequence_lengths)


def _pool_tokens(cls, engine, name):
    """Greedy requests through a pool on pages of 4 (chunked prefill over
    pages, then decode ticks); two arrive after three ticks."""
    cb = cls(engine, max_slots=2, max_seq_len=32, prompt_bucket=4,
             paged=dict(num_pages=17, page_size=4))
    reqs = [dict(prompt=p, output_len=n, top_k=1) for p, n in zip(PROMPTS, (7, 5, 6))]
    uids = [cb.submit(**r) for r in reqs[:1]]
    for _ in range(3):
        cb.step()
    uids += [cb.submit(**r) for r in reqs[1:]]
    done = cb.run(max_ticks=400)
    return [done[u].output_ids for u in uids]


@pytest.mark.parametrize("name", ["pages4", "dh64"])
def test_paged_pool_greedy_matches_jax(name):
    jcfg, jp, cfg, tp = _models(name)
    kw = dict(dtype="fp32", int8_mode=1, seq_bucket=8)
    want = _pool_tokens(JaxBatcher, JaxEngine(jcfg, jp, JaxRuntime(**kw)), name)
    got = _pool_tokens(ContinuousBatcher, GptNeoXEngine(cfg, tp, RuntimeConfig(**kw)), name)
    assert got == want
