"""GPT-2 in the port (``registry.get("gpt")``, ckpt/convert_gpt2.py: Conv1D
kernels, learned positions, the head tied to wte) on the cases of
tests/test_gpt2.py: logits and greedy tokens against HF, the pool's chunked
prefill (positions gathered per row) against the static engine, the ini
round trip, the registry; and against the JAX package on the same HF weights
(fp32 logits within atol=2e-4, rtol=1e-4; greedy tokens equal on the static
engine and a paged pool; ``from_jax_params``); a prefix prompt with learned
positions against the JAX pool; and a cache or pool past the position table
refused as the JAX package's assert refuses it."""
import numpy as np
import pytest
import torch
import transformers

from fastertransformer4codefuse_tpu.engine.batcher import ContinuousBatcher as JaxBatcher
from fastertransformer4codefuse_tpu_torch.engine import kv_cache as kvc
from fastertransformer4codefuse_tpu_torch.engine.batcher import ContinuousBatcher
from fastertransformer4codefuse_tpu_torch.models import gptneox as tm

import torch_family_util as fu

torch.set_num_threads(2)


def make_hf_gpt2(seed=0):
    torch.manual_seed(seed)
    cfg = transformers.GPT2Config(
        vocab_size=96, n_positions=64, n_embd=64, n_layer=2, n_head=4, bos_token_id=0,
        eos_token_id=95, attn_implementation="eager",
    )
    return transformers.GPT2LMHeadModel(cfg).eval()


@pytest.fixture(scope="module")
def gpt():
    return fu.convert("gpt", make_hf_gpt2(seed=3))


def test_gpt2_logits_parity():
    f = fu.convert("gpt", make_hf_gpt2())
    assert f.cfg.position_embedding == "learned" and f.cfg.rotary_embedding_dim == 0
    fu.check_logits(f, hf_atol=3e-4)


def test_gpt2_greedy_parity():
    fu.check_greedy_vs_hf(fu.convert("gpt", make_hf_gpt2(seed=1)))


def test_gpt2_batcher_chunked_prefill(gpt):
    """The pool's chunked prefill adds each row's positions from the learned
    table (the chunk's start counted): every request its static greedy run."""
    te, _ = fu.engines(gpt)
    refs = [fu.static_tokens(te, [p], 4)[0] for p in fu.PROMPTS]
    cb = ContinuousBatcher(te, max_slots=2, max_seq_len=32, prompt_bucket=4)
    assert fu.pool_tokens(cb, fu.PROMPTS, 4) == refs


def test_gpt2_matches_jax_static_and_paged(gpt):
    fu.check_tokens_vs_jax(gpt)


def test_gpt2_from_jax_params(gpt):
    fu.check_from_jax_params(gpt)


def test_gpt2_prefix_prompt_matches_the_jax_pool(gpt):
    """A prefix prompt (prompt learning) with learned positions: the input
    sits after the prefix, and its position rows count from the prefix's
    length. The static engine and a dense pool give the JAX pool's tokens."""
    te, je = fu.engines(gpt)
    cfg = gpt.cfg
    P = 5
    kv = np.random.RandomState(4).randn(cfg.layer_num, 2, cfg.kv_heads, P,
                                        cfg.size_per_head).astype(np.float32) * 0.5
    table = {0: (kv, P)}
    te.set_prompt_learning_table(table)
    prompts = [[3, 4, 5, 6], [20, 21, 22, 23, 24, 25]]
    kw = dict(max_slots=2, max_seq_len=32, prompt_bucket=4, prompt_table=table)
    jcb = JaxBatcher(je, **kw)
    juids = [jcb.submit(p, 5, top_k=1, prompt_task_id=0) for p in prompts]
    jdone = jcb.run(max_ticks=400)
    want = [list(map(int, jdone[u].output_ids)) for u in juids]
    cb = ContinuousBatcher(te, **kw)
    uids = [cb.submit(p, 5, top_k=1, prompt_task_id=0) for p in prompts]
    done = cb.run(max_ticks=400)
    assert [list(map(int, done[u].output_ids)) for u in uids] == want
    for p, w in zip(prompts, want):
        out = te.generate([p], output_len=5, top_k=1, prompt_learning_task_name_ids=[0])
        assert list(map(int, out.output_ids[0, 0, :out.sequence_lengths[0, 0]])) == w


def test_gpt2_cache_past_the_position_table_raises(gpt):
    """A cache or pool longer than the 64-row table is refused, as the JAX
    package's assert refuses it (a gather past the table would clamp)."""
    cfg, p = gpt.cfg, gpt.params
    ids = torch.tensor([[3, 4, 5]])
    with pytest.raises(ValueError, match="position table"):
        tm.decode_step(cfg, p, ids[:, 0], torch.tensor([3], dtype=torch.int32),
                       kvc.init_cache(cfg, 1, 65, torch.float32, "cpu"))
    with pytest.raises(ValueError, match="position table"):
        tm.prefill(cfg, p, torch.zeros((1, 65), dtype=torch.long),
                   torch.tensor([65], dtype=torch.int32),
                   kvc.init_cache(cfg, 1, 65, torch.float32, "cpu"))
    te, _ = fu.engines(gpt)
    cb = ContinuousBatcher(te, max_slots=2, max_seq_len=128, prompt_bucket=4)
    cb.submit([3, 4, 5], 4, top_k=1)
    with pytest.raises(ValueError, match="position table"):
        cb.run(max_ticks=10)
    # the longest cache the table covers serves
    tm.decode_step(cfg, p, ids[:, 0], torch.tensor([3], dtype=torch.int32),
                   kvc.init_cache(cfg, 1, 64, torch.float32, "cpu"))


def test_gpt2_config_ini_roundtrip(tmp_path):
    back = fu.check_ini_roundtrip(fu.convert("gpt", make_hf_gpt2()).cfg, tmp_path)
    assert back.position_embedding == "learned"


def test_gpt2_registry():
    assert fu.check_registry("gpt", make_hf_gpt2()).position_embedding == "learned"
