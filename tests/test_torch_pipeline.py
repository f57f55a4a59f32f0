"""Pipeline parallelism of the port (parallel/pipeline.py, the pp mesh of
parallel/sharding.py, the engine's and the dense pool's pp routes) against
the JAX package: tests/test_parallel.py's ``test_pp_*`` cases,
tests/test_pool_parallel.py's tp 2 x pp 2 pool and paged refusal, and
tests/test_prompt_learning.py's pp = 2 prompts.

One group of four gloo ranks (``torch_tp_util.run_group``) runs every
multi-rank case; a pp = 2 case runs on two copies of the mesh. Each case is
held to the JAX engine (or pool) under the same mesh shape on the forced
8-device CPU mesh: greedy rows' ids equal, their cum log-probs within the
JAX test's 1e-4; every row (sampled ones draw from the port's generators)
equal to the port's own pp = 1 run; every rank the same output. The counted
calls are exact: a forward of M microbatches sends M hops from every stage
but the last and receives M on every stage but the first, broadcasts the
last stage's hidden once, and under tp runs L/pp * M all-reduces (parallel
residual) and one all-gather of the logits on each rank.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fastertransformer4codefuse_tpu import GptNeoXConfig as JaxConfig
from fastertransformer4codefuse_tpu import GptNeoXEngine as JaxEngine
from fastertransformer4codefuse_tpu import RuntimeConfig as JaxRuntime
from fastertransformer4codefuse_tpu import init_params as jax_init_params
from fastertransformer4codefuse_tpu.ckpt.quantize import quantize_params
from fastertransformer4codefuse_tpu.engine.batcher import ContinuousBatcher as JaxBatcher
from fastertransformer4codefuse_tpu.models import gptneox as jmodel
from fastertransformer4codefuse_tpu.parallel import sharding as jsharding
from fastertransformer4codefuse_tpu_torch import GptNeoXEngine, RuntimeConfig
from fastertransformer4codefuse_tpu_torch.engine.batcher import ContinuousBatcher
from fastertransformer4codefuse_tpu_torch.engine.beam_pool import BeamPool
from fastertransformer4codefuse_tpu_torch.engine.server import BatchingServer
from fastertransformer4codefuse_tpu_torch.engine.spec_pool import SpecPool
from fastertransformer4codefuse_tpu_torch.engine.speculative import speculative_generate
from fastertransformer4codefuse_tpu_torch.models.params import from_jax_params
from fastertransformer4codefuse_tpu_torch.parallel import sharding
from fastertransformer4codefuse_tpu_torch.parallel.distributed import Mesh
from test_torch_parallel import LEARNED, RUN_KW, _leaves, port_cfg
from torch_tp_util import POOL_OUT_LENS, POOL_PROMPTS, PROMPTS, np_tree, run_group

WORLD = 4
PROMPT = [11, 7, 42, 13, 5]  # the prompt-learning prefix
TAIL = [21, 22, 23]


def pp_cfg(**kw):
    """tests/test_parallel.py's ``pp_cfg``: 4 layers, so pp 2 and 4 divide."""
    base = dict(head_num=8, size_per_head=8, vocab_size=128, inter_size=256, layer_num=4)
    base.update(kw)
    return JaxConfig.tiny(**base)


def models():
    cfg = pp_cfg()
    p = jax_init_params(cfg, dtype="fp32")
    learned = pp_cfg(**LEARNED)
    return {"base": (cfg, p, {}), "int8": (cfg, quantize_params(p), dict(int8_mode=1)),
            "learned": (learned, jax_init_params(learned, dtype="fp32"), {})}


# (case, model, tp, pp, microbatches, generate kwargs, output length)
ENGINE_CASES = [
    ("pp4", "base", 1, 4, 1, RUN_KW, 6),
    ("tp2_pp2", "base", 2, 2, 1, RUN_KW, 6),
    ("tp2_pp2_int8", "int8", 2, 2, 1, RUN_KW, 6),
    ("pp2_microbatches2", "base", 1, 2, 2, RUN_KW, 6),
    # B = 2 rows: decode falls back to M = 1, the prefill pipelines 4 chunks
    ("pp2_microbatches4", "base", 1, 2, 4, RUN_KW, 6),
    ("pp4_microbatches2", "base", 1, 4, 2, RUN_KW, 6),
    ("tp2_pp2_int8_microbatches2", "int8", 2, 2, 2, RUN_KW, 6),
    ("pp2_beam", "base", 1, 2, 1, dict(beam_width=2), 5),
]
# (case, tp, pp, microbatches): one prefill and one decode step, counted
COUNT_CASES = [("counts_pp4", 1, 4, 1), ("counts_tp2_pp2_m2", 2, 2, 2)]
POOL_CASE = ("dense_pool_tp2_pp2", "base", 2, 2)


def _prefix_kv(cfg, params, prompt):
    """A prefix table [L, 2, nH, P, dh]: the prompt's K/V from the JAX
    model's own prefill (tests/test_prompt_learning.py)."""
    cache = jmodel.init_kv_cache(cfg, 1, len(prompt), jnp.float32)
    _, cache = jmodel.prefill(cfg, params, jnp.asarray([prompt], jnp.int32),
                              jnp.asarray([len(prompt)], jnp.int32), cache)
    return np.stack([np.asarray(cache["k"][:, 0]), np.asarray(cache["v"][:, 0])], axis=1)


@pytest.fixture(scope="module")
def group():
    ms = models()
    cfg, p, _ = ms["base"]
    data = {name: (port_cfg(c), np_tree(q)) for name, (c, q, _) in ms.items()}
    data["base_prompts"] = (_prefix_kv(cfg, p, PROMPT),
                            np.asarray(p["embed"])[PROMPT][None].astype(np.float32))
    cases = [(name, "engine_case", dict(model=m, tp=tp, pp=pp,
                                        runtime={**ms[m][2], "pp_microbatches": M}, gen=gen,
                                        out_len=n, first_logits="beam_width" not in gen))
             for name, m, tp, pp, M, gen, n in ENGINE_CASES]
    cases += [("pp2_learned_positions", "engine_case",
               dict(model="learned", tp=1, pp=2, gen=dict(top_k=1, return_cum_log_probs=True)))]
    cases += [(name, "pp_counts_case", dict(model="base", tp=tp, pp=pp, microbatches=M))
              for name, tp, pp, M in COUNT_CASES]
    name, m, tp, pp = POOL_CASE
    cases += [(name, "pool_case", dict(model=m, tp=tp, pp=pp))]
    cases += [(f"prompt_{kind}_pp2", "prompt_case",
               dict(model="base", pp=2, kind=kind, prompt=PROMPT, tail=TAIL))
              for kind in ("prefix", "soft")]
    return ms, run_group(WORLD, cases, data)


def _ok(res):
    for r in res:
        assert "error" not in r, r["error"]
    return res


def _jax_engine(jcfg, jparams, knobs, tp, pp, M=1, seq_bucket=4):
    return JaxEngine(jcfg, jparams,
                     JaxRuntime(dtype="fp32", seq_bucket=seq_bucket, tensor_para_size=tp,
                                pipeline_para_size=pp, pp_microbatches=M, **knobs),
                     mesh=jsharding.build_mesh(tp=tp, pp=pp))


def _forward_ms(M, width, rows, beam_width=1):
    """(prefill, decode) microbatches the engine takes: M where it divides
    the padded width / the rows (whole beam groups a microbatch), else 1."""
    dec = M if rows % M == 0 and (rows // M) % beam_width == 0 else 1
    return (M if width % M == 0 else 1), dec


def _check_hops(r, pp, stage, n_pre, n_dec, forwards):
    """A stage's (sends, receives, broadcasts): hops on every edge it has."""
    hops = n_pre + (forwards - 1) * n_dec
    want = (hops if stage < pp - 1 else 0, hops if stage > 0 else 0, forwards)
    assert tuple(r) == want, (r, want)


@pytest.mark.parametrize("name,model,tp,pp,M,gen,out_len", ENGINE_CASES,
                         ids=[c[0] for c in ENGINE_CASES])
def test_pp_engine_matches_jax_under_the_mesh(group, name, model, tp, pp, M, gen, out_len):
    """``test_pp_matches_single_device`` (tp 1 x pp 4, tp 2 x pp 2),
    ``test_pp_int8_matches_single_device``,
    ``test_pp_microbatched_matches_single_device`` ((pp, M) = (2, 2), (2, 4),
    (4, 2)), ``test_pp_microbatched_int8_matches_single_device`` and
    ``test_pp_beam_matches_single_device`` of tests/test_parallel.py, with
    the counted hops, broadcasts and collectives of the whole call."""
    ms, results = group
    res = _ok(results[name])
    jcfg, jparams, knobs = ms[model]
    L = jcfg.layer_num
    for r in res[1:]:  # every rank returns the same output
        for key in ("ids", "lens", "cum"):
            np.testing.assert_array_equal(r["tp"][key], res[0]["tp"][key])
    got, own = res[0]["tp"], res[0]["tp1"]
    jeng = _jax_engine(jcfg, jparams, knobs, tp, pp, M)
    ref = jeng.generate(PROMPTS, output_len=out_len, **gen)
    bw = gen.get("beam_width", 1)
    if bw > 1:  # every beam: the JAX engine's under the same mesh
        np.testing.assert_array_equal(got["ids"], np.asarray(ref.output_ids))
        np.testing.assert_allclose(got["cum"], np.asarray(ref.cum_log_probs), atol=1e-4)
    else:
        for b in range(len(PROMPTS)):
            if np.atleast_1d(gen["top_k"])[b] == 1:  # greedy rows
                np.testing.assert_array_equal(got["ids"][b], np.asarray(ref.output_ids)[b])
                np.testing.assert_allclose(got["cum"][b], np.asarray(ref.cum_log_probs)[b],
                                           atol=1e-4)
    # every row: the port's own pp = 1 engine over the same weights
    np.testing.assert_array_equal(got["ids"], own["ids"])
    np.testing.assert_array_equal(got["lens"], own["lens"])
    np.testing.assert_allclose(got["cum"], own["cum"], atol=1e-4)
    width = -(-max(len(p) for p in PROMPTS) // 4) * 4
    n_pre, n_dec = _forward_ms(M, width, len(PROMPTS) * bw, bw)
    for rank, r in enumerate(res):
        stage = rank // tp % pp
        assert r["layers"] == L // pp  # the stage's block of the layers
        forwards = 1 + r["forwards"]
        _check_hops(r["hops"], pp, stage, n_pre, n_dec, forwards)
        per_fwd = L // pp if tp > 1 else 0
        assert r["all_reduce"] == per_fwd * (n_pre + (forwards - 1) * n_dec)
        assert r["all_gather"] == (forwards if tp > 1 else 0)
    if bw > 1:
        return
    # the prefill's logits under the mesh: the JAX single-device model's
    ids = np.full((len(PROMPTS), width), jcfg.end_id, np.int32)
    for i, p in enumerate(PROMPTS):
        ids[i, : len(p)] = p
    lens = jnp.asarray([len(p) for p in PROMPTS], jnp.int32)
    cache = jmodel.init_kv_cache(jcfg, len(PROMPTS), width + out_len, jnp.float32)
    hidden, _ = jmodel.prefill(jcfg, jparams, jnp.asarray(ids), lens, cache)
    want = np.asarray(jmodel.lm_logits(jcfg, jparams, jmodel.last_token_hidden(hidden, lens)))
    np.testing.assert_allclose(res[0]["logits"], want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name,tp,pp,M", COUNT_CASES, ids=[c[0] for c in COUNT_CASES])
def test_pp_hops_at_stage_edges(group, name, tp, pp, M):
    """``test_pp_collective_permute_at_stage_edges``: the JAX test finds the
    collective-permutes of the compiled decode step; here the counted calls
    of one prefill and of one decode step of the model on the pp mesh,
    exact on every rank, and their logits equal on every rank and to the
    JAX single-device model's."""
    ms, results = group
    res = _ok(results[name])
    jcfg, jparams, _ = ms["base"]
    L = jcfg.layer_num
    for rank, r in enumerate(res):
        stage = rank // tp % pp
        for phase in ("prefill", "decode"):
            sends, recvs, bcasts, ar, ag = r[phase]
            _check_hops((sends, recvs, bcasts), pp, stage, M, M, 1)
            assert (ar, ag) == ((L // pp * M, 1) if tp > 1 else (0, 0)), (phase, r[phase])
        for a, b in zip(r["logits"], res[0]["logits"]):
            np.testing.assert_array_equal(a, b)
    ids = jnp.asarray([[3, 4, 5, 9], [6, 7, 8, 2]], jnp.int32)
    lens = jnp.asarray([4, 3], jnp.int32)
    cache = jmodel.init_kv_cache(jcfg, 2, 16, jnp.float32)
    hidden, cache = jmodel.prefill(jcfg, jparams, ids, lens, cache)
    lp = jmodel.lm_logits(jcfg, jparams, hidden[:, 2])
    hidden, _ = jmodel.decode_step(jcfg, jparams, jnp.asarray([1, 2], jnp.int32), lens, cache)
    ld = jmodel.lm_logits(jcfg, jparams, hidden)
    for got, want in zip(res[0]["logits"], (lp, ld)):
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-4, rtol=1e-4)


def test_dense_pool_tp2_pp2_matches_the_jax_pool(group):
    """``test_dense_pool_tp2_pp2_matches_unsharded_oneshot``: the dense pool
    at tp 2 x pp 2 (chunk and decode ticks through the stages)
    emits the JAX pool's tokens under the same mesh; its slabs hold the
    stage's L/pp layers and kv_heads/tp heads; a tick of c chunk and d
    decode steps hops c + d times an edge, broadcasts c + d times, runs
    (c + d) L/pp all-reduces and d all-gathers."""
    ms, results = group
    name, model, tp, pp = POOL_CASE
    res = _ok(results[name])
    jcfg, jparams, _ = ms[model]
    L = jcfg.layer_num
    for r in res[1:]:
        assert r["tp"]["outs"] == res[0]["tp"]["outs"]
    jeng = _jax_engine(jcfg, jparams, {}, tp, pp, seq_bucket=8)
    cb = JaxBatcher(jeng, max_slots=2, max_seq_len=32, prompt_bucket=8)
    uids = [cb.submit(p, ol, top_k=1) for p, ol in zip(POOL_PROMPTS, POOL_OUT_LENS)]
    done = cb.run(max_ticks=300)
    assert res[0]["tp"]["outs"] == [done[u].output_ids for u in uids]
    for rank, r in enumerate(res):
        got = r["tp"]
        assert (got["layers"], got["kv_heads"]) == (L // pp, jcfg.head_num // tp)
        stage = rank // tp % pp
        assert any(c == 0 and d == 1 for c, d, _, _ in got["ticks"])
        for (c, d, ar, ag), hops in zip(got["ticks"], got["hops"]):
            n = c + d  # forwards of the tick, one microbatch each
            assert tuple(hops) == (n if stage < pp - 1 else 0, n if stage > 0 else 0, n)
            assert (ar, ag) == (n * L // pp, d), got["ticks"]


@pytest.mark.parametrize("kind", ["prefix", "soft"])
def test_prompt_learning_pp2_matches_jax(group, kind):
    """``test_prompt_learning_pp2_matches_single_device``: prefix (the
    table cut to each stage's layers) and soft prompts at pp = 2 give the
    JAX pp = 2 engine's tokens and cum log-probs, and the port's pp = 1
    engine's."""
    ms, results = group
    res = _ok(results[f"prompt_{kind}_pp2"])
    jcfg, jparams, _ = ms["base"]
    jeng = _jax_engine(jcfg, jparams, {}, 1, 2, seq_bucket=8)
    if kind == "prefix":
        jeng.set_prompt_learning_table({1: (_prefix_kv(jcfg, jparams, PROMPT), len(PROMPT))})
        kw = dict(prompt_learning_task_name_ids=[1])
    else:
        emb = np.asarray(jparams["embed"])[PROMPT][None]
        kw = dict(request_prompt_embedding=emb, request_prompt_lengths=[len(PROMPT)])
    ref = jeng.generate([TAIL], output_len=5, top_k=1, return_cum_log_probs=True, **kw)
    for r in res:
        np.testing.assert_array_equal(r["pp"]["ids"], np.asarray(ref.output_ids))
        np.testing.assert_allclose(r["pp"]["cum"], np.asarray(ref.cum_log_probs), atol=1e-4)
        np.testing.assert_array_equal(r["pp"]["ids"], r["pp1"]["ids"])
        np.testing.assert_allclose(r["pp"]["cum"], r["pp1"]["cum"], atol=1e-4)
    # the input's chunk (after the soft prompt's own chunk) and each decode
    # forward: one hop and one broadcast each
    for rank, r in enumerate(res):
        n = 1 + (kind == "soft") + r["pp_forwards"]
        assert r["pp_hops"] == ((n, 0, n) if rank % 2 == 0 else (0, n, n))


def test_learned_positions_under_pp_are_added_unlike_the_jax_pipeline(group):
    """A learned-position family (GPT-2 / OPT / StarCoder style) at pp = 2:
    the port's stages add the position rows as the single-rank model does,
    so its tokens and cum log-probs are the JAX single-device engine's. The
    JAX pipeline embeds without them (``parallel/pipeline.py`` passes only
    ``embed`` and ``final_ln_w`` to ``_embed_lookup``): its pp = 2 run
    differs from its own single-device run. A fault of the JAX package,
    not copied."""
    ms, results = group
    res = _ok(results["pp2_learned_positions"])
    jcfg, jparams, _ = ms["learned"]
    gen = dict(top_k=1, return_cum_log_probs=True)
    single = JaxEngine(jcfg, jparams, JaxRuntime(dtype="fp32", seq_bucket=4)).generate(
        PROMPTS, output_len=6, **gen)
    for r in res:
        np.testing.assert_array_equal(r["tp"]["ids"], np.asarray(single.output_ids))
        np.testing.assert_allclose(r["tp"]["cum"], np.asarray(single.cum_log_probs), atol=1e-4)
        np.testing.assert_array_equal(r["tp"]["ids"], r["tp1"]["ids"])
    jpp = _jax_engine(jcfg, jparams, {}, 1, 2).generate(PROMPTS, output_len=6, **gen)
    assert not np.allclose(np.asarray(jpp.cum_log_probs), np.asarray(single.cum_log_probs),
                           atol=1e-3)


# ------------------------------------------------- the stage slices ----

SLICE_MODELS = {
    "float": {},
    "int8": dict(quant=dict()),
    "int4_g16": dict(quant=dict(weight_bits=4, group_size=16)),
    "int8_rowwise_head_vocab61": dict(cfg=dict(vocab_size=61), init=dict(
        int8_mode=1, quantize_embeddings=True)),
}


@pytest.mark.parametrize("model", list(SLICE_MODELS))
def test_stage_slices_are_the_jax_addressable_shards(model):
    """shard_params at tp 2 x pp 2, rank r at (pp, tp) = (r // 2, r % 2),
    against jax.device_put of the JAX shardings on device r of a
    ``build_mesh(tp=2, pp=2)`` mesh: the stage's block of every stacked
    layer weight, then its tp slice; the top weights replicated over pp."""
    knobs = SLICE_MODELS[model]
    jcfg = pp_cfg(**knobs.get("cfg", {}))
    jp = jax_init_params(jcfg, dtype="fp32", **knobs.get("init", {}))
    if "quant" in knobs:
        jp = quantize_params(jp, **knobs["quant"])
    mesh = jsharding.build_mesh(tp=2, pp=2)
    placed = dict(_leaves(jsharding.shard_params(jcfg, jp, mesh)))
    devices = list(mesh.devices.reshape(-1))
    full = from_jax_params(np_tree(jp), device="cpu")
    cfg = port_cfg(jcfg)
    for r in range(4):
        mine = dict(_leaves(sharding.shard_params(cfg, full,
                                                  Mesh(tp=2, pp=2, tp_rank=r % 2,
                                                       pp_rank=r // 2))))
        assert mine.keys() == placed.keys()
        for key, arr in placed.items():
            shard = next(s for s in arr.addressable_shards if s.device == devices[r])
            want = np.asarray(shard.data)
            got = mine[key]
            got = (got.view(torch.int16).numpy().view(want.dtype)
                   if got.dtype == torch.bfloat16 else got.numpy())
            np.testing.assert_array_equal(got, want, err_msg=f"{model} rank {r} {key}")


# ------------------------------------------------------- refusals ----

def _pp_engine(**rt):
    """An engine at stage 0 of a pp = 2 mesh (no process group: the
    refusals come before any hop)."""
    jcfg = pp_cfg()
    full = from_jax_params(np_tree(jax_init_params(jcfg, dtype="fp32")), device="cpu")
    return GptNeoXEngine(port_cfg(jcfg), full, RuntimeConfig(dtype="fp32", seq_bucket=8, **rt),
                         mesh=Mesh(pp=2))


def test_pp_refusals():
    """What pp does not serve is refused, in the JAX package's words where
    it has them: layers that do not split over the stages (JAX
    engine.py:189-191), paged pools (batcher.py:189-193), beam pools
    (beam_pool.py:81) and speculative pools (spec_pool.py:55); and what
    runs the whole stack on one rank (static speculative decoding, the
    DEBUG sweep), a server on a mesh without its process group, or a
    ``pipeline_para_size`` that is not the mesh's."""
    jcfg = pp_cfg(layer_num=6)
    full = from_jax_params(np_tree(jax_init_params(jcfg, dtype="fp32")), device="cpu")
    with pytest.raises(ValueError, match="layer_num 6 does not split over pp 4"):
        GptNeoXEngine(port_cfg(jcfg), full, RuntimeConfig(dtype="fp32"), mesh=Mesh(pp=4))
    eng = _pp_engine()
    assert eng.stage == (0, 2) and eng.params["layers"]["qkv_w"].shape[0] == 2
    pool = dict(max_slots=2, max_seq_len=32, prompt_bucket=8)
    with pytest.raises(ValueError, match="paged pools under pipeline parallelism"):
        ContinuousBatcher(eng, paged=dict(num_pages=9, page_size=8), **pool)
    with pytest.raises(ValueError, match="beam pools under pipeline parallelism"):
        BeamPool(eng, beam_width=2, **pool)
    with pytest.raises(ValueError, match="speculative pool under pp>1"):
        SpecPool(eng, k=4, ngram=2, **pool)
    with pytest.raises(ValueError, match="serves over its process group: run every rank under "
                                         "torchrun"):
        BatchingServer(eng, **pool)
    with pytest.raises(ValueError, match="not served under pipeline parallelism"):
        speculative_generate(eng, [3, 4, 5], 4)
    with pytest.raises(NotImplementedError, match="not served under pipeline parallelism"):
        _pp_engine(debug_level="DEBUG").generate([[3, 4, 5]], 3)
    with pytest.raises(ValueError, match="pipeline_para_size 4 needs a mesh"):
        _pp_engine(pipeline_para_size=4)
    assert dataclasses.replace(RuntimeConfig(), pp_microbatches=2).pp_microbatches == 2
