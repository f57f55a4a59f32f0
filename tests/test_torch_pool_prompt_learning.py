"""Prompt learning served from the port's dense pool
(fastertransformer4codefuse_tpu_torch/engine/batcher.py ``prompt_table=``)
against the JAX pool, on the cases of tests/test_pool_prompt_learning.py:
prompted and unprompted requests of two tasks sharing two slots mid-flight,
on an fp32 and an int8 KV cache, and the JAX pool's refusals. The same
JAX-made fp32 weights and prefix tables go to both.

Tolerance: every request's tokens identical to the JAX pool's and to the
port's static engine run alone with the same task."""
import dataclasses

import numpy as np
import pytest
import torch

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
from fastertransformer4codefuse_tpu_torch.engine.server import BatchingServer

torch.set_num_threads(2)

PROMPTS = [[3, 4, 5], [9, 8, 7, 6, 5], [11, 12], [20, 21, 22, 23]]
OUT_LENS = [5, 4, 6, 3]


def mk(kv_dtype=None):
    jcfg = JaxConfig.tiny(head_num=4, size_per_head=8, vocab_size=64)
    jp = jax_init_params(jcfg, dtype="fp32")
    rt = dict(dtype="fp32", seq_bucket=8, kv_cache_dtype=kv_dtype)
    je = JaxEngine(jcfg, jp, JaxRuntime(**rt))
    cfg = GptNeoXConfig(**{f.name: getattr(jcfg, f.name)
                           for f in dataclasses.fields(GptNeoXConfig)})
    te = GptNeoXEngine(cfg, from_jax_params(jp, device="cpu"), RuntimeConfig(**rt))
    rng = np.random.RandomState(0)
    table = {
        7: (rng.randn(cfg.layer_num, 2, cfg.head_num, 5, cfg.size_per_head)
            .astype(np.float32) * 0.3, 5),
        9: (rng.randn(cfg.layer_num, 2, cfg.head_num, 3, cfg.size_per_head)
            .astype(np.float32) * 0.3, 3),
    }
    te.set_prompt_learning_table(table)
    return je, te, table


def run_pool(cls, eng, table, tasks):
    cb = cls(eng, max_slots=2, max_seq_len=32, prompt_bucket=8, prompt_table=table)
    uids = [cb.submit(p, ol, top_k=1, prompt_task_id=t)
            for p, ol, t in zip(PROMPTS, OUT_LENS, tasks)]
    done = cb.run(max_ticks=300)
    assert all(done[u].done for u in uids)
    return [list(done[u].output_ids) for u in uids]


def static(te, tasks):
    out = []
    for p, ol, t in zip(PROMPTS, OUT_LENS, tasks):
        kw = {} if t is None else dict(prompt_learning_task_name_ids=[t])
        o = te.generate([p], output_len=ol, top_k=1, **kw)
        out.append(o.output_ids[0, 0, : int(o.sequence_lengths[0, 0])].tolist())
    return out


@pytest.mark.parametrize("kv,tasks", [(None, [7, None, 9, 7]), ("int8", [9, 7, None, 9])])
def test_pooled_prompt_learning_matches_jax_pool_and_static(kv, tasks):
    """Mixed tasks and task-free requests sharing slots mid-flight."""
    je, te, table = mk(kv)
    got = run_pool(ContinuousBatcher, te, table, tasks)
    assert got == run_pool(JaxBatcher, je, table, tasks)
    assert got == static(te, tasks)


def test_pooled_prompt_learning_server_threads():
    """The same pool behind BatchingServer: requests from the client side
    give the static engine's tokens."""
    _, te, table = mk()
    srv = BatchingServer(te, max_slots=2, max_seq_len=32, prompt_bucket=8, prompt_table=table)
    try:
        tasks = [7, 9, None, 7]
        got = [srv.generate(p, ol, top_k=1, prompt_task_id=t).output_ids
               for p, ol, t in zip(PROMPTS, OUT_LENS, tasks)]
    finally:
        srv.close()
    assert [list(g) for g in got] == static(te, tasks)


def test_pooled_prompt_learning_rejections():
    """The JAX pool's refusals: an unknown task, a task on a pool without a
    table, a table on a paged pool, a packed cache, a speculative pool."""
    je, te, table = mk()
    cb = ContinuousBatcher(te, max_slots=2, max_seq_len=32, prompt_bucket=8, prompt_table=table)
    with pytest.raises(ValueError, match="unknown prompt task"):
        cb.submit([1, 2], 3, prompt_task_id=42)
    cb2 = ContinuousBatcher(te, max_slots=2, max_seq_len=32, prompt_bucket=8)
    with pytest.raises(ValueError, match="prompt_table"):
        cb2.submit([1, 2], 3, prompt_task_id=7)
    with pytest.raises(ValueError, match="paged pools"):
        ContinuousBatcher(te, max_slots=2, max_seq_len=32, prompt_bucket=8, prompt_table=table,
                          paged=dict(num_pages=8, page_size=8))
    t4 = GptNeoXEngine(te.config, te.params,
                       RuntimeConfig(dtype="fp32", seq_bucket=8, kv_cache_dtype="int4"))
    with pytest.raises(ValueError, match="unpacked KV cache"):
        ContinuousBatcher(t4, max_slots=2, max_seq_len=32, prompt_bucket=8, prompt_table=table)
    from fastertransformer4codefuse_tpu_torch.engine.spec_pool import SpecPool
    with pytest.raises(ValueError, match="prompt learning"):
        SpecPool(te, k=2, max_slots=2, max_seq_len=32, prompt_bucket=8, prompt_table=table)
