"""The port's T5 (fastertransformer4codefuse_tpu_torch/models/t5.py) against
the JAX package's models/t5.py and HF T5ForConditionalGeneration, on
tests/test_t5.py's tiny config and HF weights, fp32 on the CPU.

Tolerances: against HF the JAX tests' own (encoder atol 5e-4 / rtol 3e-3,
decoder logits atol 1e-3 / rtol 3e-3); against the JAX package atol 2e-4 /
rtol 1e-4; greedy tokens equal token for token; the relative-position bucket
tables and the int8 weights exactly equal."""
import functools

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax.numpy as jnp

from fastertransformer4codefuse_tpu.models import t5 as jt5
from fastertransformer4codefuse_tpu_torch.models import registry, t5
from fastertransformer4codefuse_tpu_torch.models.params import QuantizedTensor, from_jax_params
from test_t5 import make_hf_t5

torch.set_num_threads(2)
JAX_TOL = dict(atol=2e-4, rtol=1e-4)


@functools.lru_cache(maxsize=1)
def _shared():
    return _both(seed=0)


def _both(seed):
    hf = make_hf_t5(seed=seed)
    cfg = t5.config_from_hf_t5(hf.config)
    params = t5.params_from_hf_t5_state_dict(cfg, hf.state_dict(), device="cpu")
    jcfg = jt5.config_from_hf_t5(hf.config)
    return hf, cfg, params, jcfg, jt5.params_from_hf_t5_state_dict(jcfg, hf.state_dict())


@pytest.mark.parametrize("seed,lens", [(0, [9, 6]), (3, [5, 5])])
def test_encoder_matches_hf_and_jax(seed, lens):
    hf, cfg, params, jcfg, jparams = _both(seed)
    B, S = len(lens), max(lens)
    ids = np.random.RandomState(seed).randint(2, cfg.vocab_size, size=(B, S)).astype(np.int32)
    ln = np.asarray(lens, np.int32)
    am = (np.arange(S)[None, :] < ln[:, None]).astype(np.int64)
    with torch.no_grad():
        want = hf.encoder(torch.from_numpy(ids).long(),
                          attention_mask=torch.from_numpy(am)).last_hidden_state.numpy()
    got = t5.encode(cfg, params, ids, ln).numpy()
    ref = np.asarray(jt5.encode(jcfg, jparams, jnp.asarray(ids), jnp.asarray(ln)))
    for b, n in enumerate(lens):
        np.testing.assert_allclose(got[b, :n], want[b, :n], atol=5e-4, rtol=3e-3)
    np.testing.assert_allclose(got, ref, **JAX_TOL)


def test_decoder_logits_match_hf_and_jax_teacher_forced():
    """Per-step logits through the incremental cache (causal bucket bias,
    cross-attention K/V projected once) against HF's full forward and the
    JAX decode_step."""
    hf, cfg, params, jcfg, jparams = _both(seed=1)
    B, S, T = 2, 7, 5
    rng = np.random.RandomState(1)
    ids = rng.randint(2, cfg.vocab_size, size=(B, S)).astype(np.int32)
    dec_in = np.concatenate([np.zeros((B, 1), np.int64),
                             rng.randint(2, cfg.vocab_size, size=(B, T - 1))], axis=1)
    lens = np.array([S, 4], np.int32)
    am = (np.arange(S)[None, :] < lens[:, None]).astype(np.int64)
    with torch.no_grad():
        want = hf(input_ids=torch.from_numpy(ids).long(), attention_mask=torch.from_numpy(am),
                  decoder_input_ids=torch.from_numpy(dec_in)).logits.numpy()
    enc = t5.encode(cfg, params, ids, lens)
    state = t5.init_decoder_state(cfg, params, enc, lens, T + 1)
    jenc = jt5.encode(jcfg, jparams, jnp.asarray(ids), jnp.asarray(lens))
    jstate = jt5.init_decoder_state(jcfg, jparams, jenc, jnp.asarray(lens), T + 1)
    for t in range(T):
        logits, state = t5.decode_step(cfg, params, state, dec_in[:, t], t)
        jlogits, jstate = jt5.decode_step(jcfg, jparams, jstate,
                                          jnp.asarray(dec_in[:, t], jnp.int32), jnp.int32(t))
        np.testing.assert_allclose(logits.numpy(), want[:, t], atol=1e-3, rtol=3e-3)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **JAX_TOL)


def test_greedy_generate_matches_hf_and_jax():
    hf, cfg, params, jcfg, jparams = _both(seed=2)
    B, S, OUT = 2, 8, 8
    ids = np.random.RandomState(3).randint(2, cfg.vocab_size, size=(B, S)).astype(np.int32)
    lens = np.full((B,), S, np.int32)
    with torch.no_grad():
        want = hf.generate(torch.from_numpy(ids).long(), max_new_tokens=OUT, do_sample=False,
                           num_beams=1).numpy()[:, 1:]
    got = t5.greedy_generate(cfg, params, ids, lens, OUT)
    ref = jt5.greedy_generate(jcfg, jparams, jnp.asarray(ids), jnp.asarray(lens), OUT)
    np.testing.assert_array_equal(got, ref)
    for b in range(B):
        for i in range(min(want.shape[1], got.shape[1])):
            assert got[b, i] == want[b, i], (b, i, got[b], want[b])
            if want[b, i] == cfg.end_id:
                break


@pytest.mark.parametrize("bidirectional", [True, False])
@pytest.mark.parametrize("num_buckets,max_distance", [(32, 128), (8, 32), (32, 64), (16, 20)])
def test_bucket_tables_equal_jax_exactly(bidirectional, num_buckets, max_distance):
    """Every relative position in [-4 max_distance, 4 max_distance]: the
    float32 log truncated to an integer lands in the JAX package's bucket."""
    rel = np.arange(-4 * max_distance, 4 * max_distance + 1)
    got = t5._rel_bucket(torch.from_numpy(rel), bidirectional, num_buckets, max_distance)
    want = np.asarray(jt5._rel_bucket(jnp.asarray(rel), bidirectional, num_buckets,
                                      max_distance))
    np.testing.assert_array_equal(got.numpy(), want)


@settings(max_examples=6, deadline=None)
@given(q0=st.integers(0, 300), nq=st.integers(1, 6), k0=st.integers(0, 300),
       nk=st.integers(1, 6), bidirectional=st.booleans())
def test_pos_bias_equals_jax_on_drawn_positions(q0, nq, k0, nk, bidirectional):
    _, cfg, params, jcfg, jparams = _shared()
    q, k = np.arange(q0, q0 + nq), np.arange(k0, k0 + nk)
    got = t5._pos_bias(cfg, params["dec_rel_bias"], torch.from_numpy(q), torch.from_numpy(k),
                       bidirectional)
    want = jt5._pos_bias(jcfg, jparams["dec_rel_bias"], jnp.asarray(q), jnp.asarray(k),
                         bidirectional)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_int8_weights_equal_jax_and_outputs_match_jax_int8():
    hf, cfg, params, jcfg, jparams = _both(seed=6)
    qp = t5.quantize_t5_params(params)
    jqp = jt5.quantize_t5_params(jparams)
    for side in ("enc", "dec"):
        for name in (n for n in params[side] if n in t5._GEMM_NAMES):
            w, jw = qp[side][name], jqp[side][name]
            assert isinstance(w, QuantizedTensor) and w.bits == 8 and w.k_axis == -2
            np.testing.assert_array_equal(w.q.numpy(), np.asarray(jw.q))
            np.testing.assert_array_equal(w.scale.numpy(), np.asarray(jw.scale))
    ids = np.random.RandomState(4).randint(2, cfg.vocab_size, size=(2, 6)).astype(np.int32)
    lens = np.array([6, 4], np.int32)
    enc = t5.encode(cfg, qp, ids, lens)
    jenc = jt5.encode(jcfg, jqp, jnp.asarray(ids), jnp.asarray(lens))
    np.testing.assert_allclose(enc.numpy(), np.asarray(jenc), **JAX_TOL)
    state = t5.init_decoder_state(cfg, qp, enc, lens, 3)
    jstate = jt5.init_decoder_state(jcfg, jqp, jenc, jnp.asarray(lens), 3)
    np.testing.assert_allclose(state["cross_k"].numpy(), np.asarray(jstate["cross_k"]),
                               **JAX_TOL)
    tok = np.zeros((2,), np.int32)
    for t in range(2):
        logits, state = t5.decode_step(cfg, qp, state, tok, t)
        jlogits, jstate = jt5.decode_step(jcfg, jqp, jstate, jnp.asarray(tok), jnp.int32(t))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **JAX_TOL)
        tok = logits.argmax(-1).numpy().astype(np.int32)
    # the JAX tree carried across by from_jax_params is the port's tree
    carried = from_jax_params(jqp, device="cpu")
    assert torch.equal(carried["dec"]["wi"].q, qp["dec"]["wi"].q)


def test_registry_serves_t5():
    from fastertransformer4codefuse_tpu_torch.engine.t5_engine import T5Engine

    fam = registry.get("t5")
    assert fam.encode is t5.encode and fam.prefill is t5.encode
    assert fam.decode_step is t5.decode_step
    hf = make_hf_t5(seed=2)
    cfg = fam.config_from_hf(hf.config)
    params = fam.params_from_hf(cfg, hf.state_dict(), device="cpu")
    eng = fam.make_engine(cfg, params)
    assert isinstance(eng, T5Engine)
    out = eng.generate([[5, 6, 7, 8, 9, 10]], 5)
    assert out.output_ids.shape[:2] == (1, 1)


def test_params_default_to_the_card(monkeypatch):
    """Without device= the converter builds on CUDA, and raises without a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    hf = make_hf_t5(seed=0)
    cfg = t5.config_from_hf_t5(hf.config)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t5.params_from_hf_t5_state_dict(cfg, hf.state_dict())
