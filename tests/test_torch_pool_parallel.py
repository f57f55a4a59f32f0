"""The port's serving pools under tensor parallelism (engine/batcher.py,
engine/paged_kv.py, engine/beam_pool.py, engine/spec_pool.py on a mesh)
against tests/test_pool_parallel.py's cases (all but the pipeline ones,
which are the next slice) and tests/test_beam_pool.py's
``test_beam_pool_under_tp_mesh``.

One group of four gloo ranks runs every case; each rank drives its pool in
lockstep (the same submissions, the same ``step`` calls). Greedy requests
emit the tokens of the JAX package's unsharded one-shot engine (the JAX
tests' references), the int8 paged pool the JAX tp = 2 pool's; sampled ones
the port's own tp = 1 pool's (another generator than the JAX package's).
The slabs hold kv_heads / tp heads, and a decode tick runs L all-reduces
and one all-gather, a tick with a chunk step 2L.
"""
import pytest

from fastertransformer4codefuse_tpu import GptNeoXConfig as JaxConfig
from fastertransformer4codefuse_tpu import GptNeoXEngine as JaxEngine
from fastertransformer4codefuse_tpu import RuntimeConfig as JaxRuntime
from fastertransformer4codefuse_tpu import init_params as jax_init_params
from fastertransformer4codefuse_tpu.ckpt.quantize import quantize_params
from fastertransformer4codefuse_tpu.engine.batcher import ContinuousBatcher as JaxBatcher
from fastertransformer4codefuse_tpu.parallel.sharding import build_mesh
from test_torch_parallel import port_cfg
from torch_tp_util import POOL_OUT_LENS, POOL_PROMPTS, np_tree, run_group

WORLD = 4
SAMPLING = [
    dict(top_k=1),
    dict(top_k=4, random_seed=7, temperature=0.8, repetition_penalty=1.3),
    dict(top_k=1),
    dict(top_k=8, random_seed=123, presence_penalty=0.5, min_length=2),
    dict(top_k=1),
]
PAGED = dict(paged=dict(num_pages=9, page_size=8))
# (case, model, tp, pool kind, pool kwargs, sampling, runtime knobs, tp = 1 pool too)
CASES = [
    ("dense_pool_tp4", "fp", 4, "dense", {}, None, {}, False),
    ("dense_pool_tp4_heterogeneous_sampling", "fp", 4, "dense", dict(max_slots=3), SAMPLING,
     {}, True),
    ("paged_pool_tp4", "fp", 4, "paged", PAGED, None, {}, False),
    ("paged_pool_tp2_int8_kv", "fp", 2, "paged", PAGED, None, dict(kv_cache_dtype="int8"), True),
    ("int8_weights_pool_tp2", "int8", 2, "dense", {}, None, dict(int8_mode=1), False),
    ("spec_pool_tp4", "fp", 4, "spec", {}, None, {}, False),
    ("beam_pool_tp4", "fp", 4, "beam", {}, None, {}, False),
]


def _cfg():
    return JaxConfig.tiny(head_num=8, size_per_head=8, vocab_size=64, layer_num=2)


@pytest.fixture(scope="module")
def group():
    cfg = _cfg()
    p = jax_init_params(cfg, dtype="fp32")
    ms = {"fp": (cfg, p), "int8": (cfg, quantize_params(p))}
    data = {n: (port_cfg(c), np_tree(q)) for n, (c, q) in ms.items()}
    cases = [(name, "pool_case", dict(model=m, tp=tp, kind=kind, pool=pool, sampling=smp,
                                      runtime=rt, compare_tp1=tp1))
             for name, m, tp, kind, pool, smp, rt, tp1 in CASES]
    return ms, run_group(WORLD, cases, data)


def _refs(cfg, params, int8=0):
    """The JAX unsharded engine's one-shot greedy outputs."""
    eng = JaxEngine(cfg, params, JaxRuntime(dtype="fp32", seq_bucket=8, int8_mode=int8))
    out = []
    for p, ol in zip(POOL_PROMPTS, POOL_OUT_LENS):
        o = eng.generate([p], output_len=ol, top_k=1)
        out.append([int(x) for x in o.output_ids[0, 0, : int(o.sequence_lengths[0, 0])]])
    return out


def _jax_int8_kv_pool_tp2(cfg, params):
    eng = JaxEngine(cfg, params, JaxRuntime(dtype="fp32", seq_bucket=8, tensor_para_size=2,
                                            kv_cache_dtype="int8"), mesh=build_mesh(tp=2))
    cb = JaxBatcher(eng, max_slots=2, max_seq_len=32, prompt_bucket=8,
                    paged=dict(num_pages=9, page_size=8))
    uids = [cb.submit(p, ol, top_k=1) for p, ol in zip(POOL_PROMPTS, POOL_OUT_LENS)]
    done = cb.run(max_ticks=300)
    return [done[u].output_ids for u in uids]


def _jax_static_beams(cfg, params):
    eng = JaxEngine(cfg, params, JaxRuntime(dtype="fp32", seq_bucket=8))
    out = []
    for p, ol in zip(POOL_PROMPTS, POOL_OUT_LENS):
        o = eng.generate([p], output_len=ol, beam_width=2)
        out.append([[int(x) for x in o.output_ids[0, j, : o.sequence_lengths[0, j]]]
                    for j in range(2)])
    return out


@pytest.mark.parametrize("name,model,tp,kind,pool,sampling,rt,tp1", CASES,
                         ids=[c[0] for c in CASES])
def test_pool_under_the_mesh(group, name, model, tp, kind, pool, sampling, rt, tp1):
    ms, results = group
    res = results[name]
    for r in res:
        assert "error" not in r, r["error"]
    got = res[0]["tp"]
    for r in res[1:]:  # every rank emits the same tokens
        assert r["tp"]["outs"] == got["outs"] and r["tp"]["beams"] == got["beams"]
    cfg, params = ms[model]
    # the slabs (or pages) hold this rank's KV heads
    assert got["kv_heads"] == cfg.head_num // tp
    if kind == "beam":
        assert got["beams"] == res[0]["static"] == _jax_static_beams(cfg, params)
        return
    if name == "paged_pool_tp2_int8_kv":
        want = _jax_int8_kv_pool_tp2(cfg, params)
        assert got["outs"] == res[0]["tp1"]["outs"] == want
        return
    want = _refs(cfg, params, int8=rt.get("int8_mode", 0))
    for i, out in enumerate(got["outs"]):
        if sampling is None or sampling[i].get("top_k", 1) == 1:
            assert out == want[i], f"request {i}: {out} != {want[i]}"
    if tp1:  # sampled requests: the port's tp = 1 pool
        assert got["outs"] == res[0]["tp1"]["outs"]


def test_pool_tick_single_psum_per_layer_tp4(group):
    """The pool's decode tick keeps one all-reduce a layer (the JAX test
    counts the compiled tick's psums): L all-reduces and the logits'
    all-gather; a tick that also runs a chunk step adds the chunk's L."""
    ms, results = group
    L = ms["fp"][0].layer_num
    for name in ("dense_pool_tp4", "paged_pool_tp4"):
        ticks = results[name][0]["tp"]["ticks"]
        assert any(c == 0 and d == 1 for c, d, _, _ in ticks)
        for chunks, decodes, ar, ag in ticks:
            assert (ar, ag) == ((chunks + decodes) * L, decodes), (name, ticks)
