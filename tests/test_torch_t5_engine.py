"""The port's T5Engine (fastertransformer4codefuse_tpu_torch/engine/t5_engine.py)
against the JAX package's engine/t5_engine.py and HF ``generate``, on
tests/test_t5_engine.py's tiny config and HF weights, fp32 on the CPU.

Greedy and beam tokens equal HF's and the JAX engine's token for token
(every (beam width, length penalty, seed) of the JAX test, and
early_stopping=True), beam scores within the JAX test's rtol 1e-4; sampling
on the JAX engine's Gumbel noise gives its tokens, and at each
teacher-forced step the processed logits and the filtered distribution
equal JAX's within 1e-5; int8 weights give the tokens of the dequantized
float weights. (The JAX tests' tensor-parallel cases run in
tests/test_torch_parallel_families.py.)"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax
import jax.numpy as jnp

from fastertransformer4codefuse_tpu.engine.t5_engine import T5Engine as JaxT5Engine
from fastertransformer4codefuse_tpu.models import t5 as jt5
from fastertransformer4codefuse_tpu_torch.engine.t5_engine import T5Engine, top_k_stable
from fastertransformer4codefuse_tpu_torch.models import t5
from fastertransformer4codefuse_tpu_torch.sampling.sample import top_k_top_p_filter
from test_t5_engine import ids_for, make_hf_t5

torch.set_num_threads(2)


def mk(seed):
    hf = make_hf_t5(seed)
    cfg = t5.config_from_hf_t5(hf.config)
    params = t5.params_from_hf_t5_state_dict(cfg, hf.state_dict(), device="cpu")
    jcfg = jt5.config_from_hf_t5(hf.config)
    return hf, cfg, params, JaxT5Engine(jcfg, jt5.params_from_hf_t5_state_dict(jcfg,
                                                                              hf.state_dict()))


def _rows(ids):
    return [list(r) for r in ids]


def test_greedy_matches_hf_and_jax():
    hf, cfg, params, jeng = mk(seed=2)
    ids = ids_for(cfg, 2, 8)
    with torch.no_grad():
        want = hf.generate(torch.from_numpy(ids).long(), max_new_tokens=8, do_sample=False,
                           num_beams=1).numpy()[:, 1:]
    out = T5Engine(cfg, params).generate(_rows(ids), 8)
    ref = jeng.generate(_rows(ids), 8)
    np.testing.assert_array_equal(out.output_ids, ref.output_ids)
    np.testing.assert_array_equal(out.sequence_lengths, ref.sequence_lengths)
    for b in range(2):
        for i in range(want.shape[1]):
            assert out.output_ids[b, 0, i] == want[b, i], (b, i)
            if want[b, i] == cfg.end_id:
                break


@pytest.mark.parametrize("bw,lp,seed", [(2, 1.0, 0), (3, 1.0, 1), (2, 0.6, 2), (4, 2.0, 5)])
def test_beams_match_hf_and_jax_exactly(bw, lp, seed):
    hf, cfg, params, jeng = mk(seed=seed)
    ids = ids_for(cfg, 2, 7, seed=seed + 10)
    OUT = 10
    with torch.no_grad():
        hf_out = hf.generate(
            torch.from_numpy(ids).long(), max_new_tokens=OUT, do_sample=False, num_beams=bw,
            num_return_sequences=bw, length_penalty=lp, early_stopping=False,
            output_scores=True, return_dict_in_generate=True)
    want = hf_out.sequences.numpy()[:, 1:]
    want_scores = hf_out.sequences_scores.numpy()
    out = T5Engine(cfg, params).generate(_rows(ids), OUT, beam_width=bw, length_penalty=lp)
    ref = jeng.generate(_rows(ids), OUT, beam_width=bw, length_penalty=lp)
    np.testing.assert_array_equal(out.output_ids, ref.output_ids)
    np.testing.assert_array_equal(out.sequence_lengths, ref.sequence_lengths)
    np.testing.assert_allclose(out.scores, ref.scores, rtol=1e-5)
    for b in range(2):
        for j in range(bw):
            n = int(out.sequence_lengths[b, j])
            ref_row = want[b * bw + j]
            for i in range(min(n, len(ref_row))):
                assert out.output_ids[b, j, i] == ref_row[i], (b, j, i)
            np.testing.assert_allclose(out.scores[b, j], want_scores[b * bw + j], rtol=1e-4)


def test_beams_match_hf_and_jax_with_early_stopping():
    hf, cfg, params, jeng = mk(seed=7)
    ids = ids_for(cfg, 2, 6, seed=20)
    with torch.no_grad():
        want = hf.generate(torch.from_numpy(ids).long(), max_new_tokens=8, do_sample=False,
                           num_beams=2, num_return_sequences=2, early_stopping=True,
                           return_dict_in_generate=True).sequences.numpy()[:, 1:]
    out = T5Engine(cfg, params).generate(_rows(ids), 8, beam_width=2, early_stopping=True)
    ref = jeng.generate(_rows(ids), 8, beam_width=2, early_stopping=True)
    np.testing.assert_array_equal(out.output_ids, ref.output_ids)
    for b in range(2):
        for j in range(2):
            n = int(out.sequence_lengths[b, j])
            for i in range(min(n, want.shape[1])):
                assert out.output_ids[b, j, i] == want[b * 2 + j, i], (b, j, i)


@settings(max_examples=12, deadline=None)
@given(data=st.data(), rows=st.integers(1, 3), n=st.integers(2, 40), k=st.integers(1, 8))
def test_top_k_order_equals_lax_top_k_on_ties(data, rows, n, k):
    """Scores drawn from a few values, so ties are common: the values and
    indices equal jax.lax.top_k's (equal scores, lower index first)."""
    k = min(k, n)
    vals = data.draw(st.lists(st.sampled_from([-1e9, -2.5, -1.0, 0.0, 0.5]),
                              min_size=rows * n, max_size=rows * n))
    x = np.asarray(vals, np.float32).reshape(rows, n)
    got_v, got_i = top_k_stable(torch.from_numpy(x), k)
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), k)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


def _jax_noise(seeds, step, n):
    """The JAX engine's Gumbel noise at decoder step ``step``."""
    keys = jax.vmap(jax.random.PRNGKey)(jnp.asarray(seeds, jnp.uint32))
    rngs = jax.vmap(jax.random.fold_in)(keys, jnp.full((len(seeds),), step))
    return np.array(jax.vmap(lambda k: jax.random.gumbel(k, (n,), jnp.float32))(rngs))


def test_sampling_matches_jax_on_its_noise_and_teacher_forced_distributions():
    hf, cfg, params, jeng = mk(seed=4)
    ids = ids_for(cfg, 2, 6, seed=8)
    OUT = 6
    kw = dict(top_k=[5, 0], top_p=[0.0, 0.9], temperature=[0.7, 1.3], random_seed=[123, 9])
    eng = T5Engine(cfg, params)
    # top_k=1 is greedy, whatever the seed
    np.testing.assert_array_equal(eng.generate(_rows(ids), OUT).output_ids,
                                  eng.generate(_rows(ids), OUT, top_k=1,
                                               random_seed=9).output_ids)
    # the same seeds give the same tokens (each row its own generator)
    s1 = eng.generate(_rows(ids), OUT, **kw)
    s2 = eng.generate(_rows(ids), OUT, **kw)
    np.testing.assert_array_equal(s1.output_ids, s2.output_ids)
    # on the JAX engine's noise, the JAX engine's tokens
    eng._step_noise = lambda gens, step, n: torch.from_numpy(_jax_noise(kw["random_seed"],
                                                                        step, n))
    got = eng.generate(_rows(ids), OUT, **kw)
    ref = jeng.generate(_rows(ids), OUT, **kw)
    np.testing.assert_array_equal(got.output_ids, ref.output_ids)
    np.testing.assert_array_equal(got.sequence_lengths, ref.sequence_lengths)
    # teacher-forced through both decoders: processed logits and the filtered
    # distribution at every step
    lens = np.array([6, 6], np.int32)
    temp = torch.tensor(kw["temperature"])
    state = t5.init_decoder_state(cfg, params, t5.encode(cfg, params, ids, lens), lens, OUT + 1)
    jenc = jt5.encode(jeng.config, jeng.params, jnp.asarray(ids), jnp.asarray(lens))
    jstate = jt5.init_decoder_state(jeng.config, jeng.params, jenc, jnp.asarray(lens), OUT + 1)
    tok = np.full((2,), cfg.start_id, np.int32)
    k, p = torch.tensor(kw["top_k"]), torch.tensor(kw["top_p"])
    for i in range(OUT):
        logits, state = t5.decode_step(cfg, params, state, tok, i)
        jlogits, jstate = jt5.decode_step(jeng.config, jeng.params, jstate, jnp.asarray(tok),
                                          jnp.int32(i))
        proc = logits / temp[:, None]
        jproc = torch.from_numpy(np.array(jlogits / jnp.asarray(kw["temperature"])[:, None]))
        np.testing.assert_allclose(proc.numpy(), jproc.numpy(), atol=1e-5, rtol=0)
        dist = torch.softmax(top_k_top_p_filter(proc, k, p), dim=-1)
        jdist = torch.softmax(top_k_top_p_filter(jproc, k, p), dim=-1)
        np.testing.assert_allclose(dist.numpy(), jdist.numpy(), atol=1e-5, rtol=0)
        tok = got.output_ids[:, 0, i].astype(np.int32)


def test_int8_gives_the_tokens_of_the_dequantized_weights():
    _, cfg, params, _ = mk(seed=6)
    qp = t5.quantize_t5_params(params)
    deq = dict(params, **{side: {n: (v.dequantize() if hasattr(v, "dequantize") else v)
                                 for n, v in qp[side].items()} for side in ("enc", "dec")})
    ids = _rows(ids_for(cfg, 2, 6, seed=11))
    for bw in (1, 2):
        a = T5Engine(cfg, qp).generate(ids, 6, beam_width=bw)
        b = T5Engine(cfg, deq).generate(ids, 6, beam_width=bw)
        np.testing.assert_array_equal(a.output_ids, b.output_ids)


def test_engine_refuses_a_mesh_and_defaults_to_the_params_device():
    _, cfg, params, _ = mk(seed=3)
    # a mesh is served (tests/test_torch_parallel_families.py); one whose tp
    # does not split the heads is refused
    from fastertransformer4codefuse_tpu_torch.parallel.distributed import Mesh

    with pytest.raises(ValueError, match="do not split"):
        T5Engine(cfg, params, mesh=Mesh(tp=3))
    assert T5Engine(cfg, params).device == torch.device("cpu")
