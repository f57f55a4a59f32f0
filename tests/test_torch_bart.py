"""The port's BART and Marian (fastertransformer4codefuse_tpu_torch/models/bart.py)
against the JAX package's models/bart.py and HF BartForConditionalGeneration /
MarianMTModel, on tests/test_bart.py's tiny configs and HF weights, fp32 on
the CPU.

Tolerances: against HF the JAX tests' own (encoder rtol 2e-4 / atol 2e-5,
decoder logits rtol 2e-4 / atol 2e-4); against the JAX package atol 2e-4 /
rtol 1e-4; greedy tokens equal token for token. Marian's published
activation is swish: the port maps it to SiLU as HF does, the JAX package to
gelu (pinned below, not copied)."""
import numpy as np
import pytest
import torch
import transformers

import jax.numpy as jnp

from fastertransformer4codefuse_tpu.models import bart as jbart
from fastertransformer4codefuse_tpu_torch.models import bart, registry
from test_bart import make_hf, make_hf_marian

torch.set_num_threads(2)
JAX_TOL = dict(atol=2e-4, rtol=1e-4)


def _both(hf, marian=False):
    parse = bart.config_from_hf_marian if marian else bart.config_from_hf_bart
    jparse = jbart.config_from_hf_marian if marian else jbart.config_from_hf_bart
    cfg, jcfg = parse(hf.config), jparse(hf.config)
    params = bart.params_from_hf_bart_state_dict(cfg, hf.state_dict(), device="cpu")
    return cfg, params, jcfg, jbart.params_from_hf_bart_state_dict(jcfg, hf.state_dict())


def test_encoder_matches_hf_and_jax():
    hf = make_hf(seed=0)
    cfg, params, jcfg, jparams = _both(hf)
    ids = np.random.RandomState(1).randint(3, 96, size=(2, 9)).astype(np.int64)
    lens = np.array([9, 6], np.int32)
    am = (np.arange(9)[None, :] < lens[:, None]).astype(np.int64)
    with torch.no_grad():
        want = hf.model.encoder(input_ids=torch.from_numpy(ids),
                                attention_mask=torch.from_numpy(am)).last_hidden_state.numpy()
    got = bart.encode(cfg, params, ids, lens).numpy()
    ref = np.asarray(jbart.encode(jcfg, jparams, jnp.asarray(ids), jnp.asarray(lens)))
    for b, n in enumerate(lens):
        np.testing.assert_allclose(got[b, :n], want[b, :n], rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got, ref, **JAX_TOL)


@pytest.mark.parametrize("marian", [False, True])
def test_decoder_logits_match_hf_and_jax_teacher_forced(marian):
    hf = make_hf_marian(seed=2) if marian else make_hf(seed=2)
    cfg, params, jcfg, jparams = _both(hf, marian)
    ids = np.random.RandomState(3).randint(3, 96, size=(2, 7)).astype(np.int64)
    lens = np.array([7, 5], np.int32)
    am = (np.arange(7)[None, :] < lens[:, None]).astype(np.int64)
    dec_in = np.array([[cfg.start_id, 5, 9, 11], [cfg.start_id, 40, 7, 3]])
    with torch.no_grad():
        want = hf(input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(am),
                  decoder_input_ids=torch.from_numpy(dec_in)).logits.numpy()
    enc = bart.encode(cfg, params, ids, lens)
    state = bart.init_decoder_state(cfg, params, enc, lens, dec_in.shape[1] + 1)
    jenc = jbart.encode(jcfg, jparams, jnp.asarray(ids), jnp.asarray(lens))
    jstate = jbart.init_decoder_state(jcfg, jparams, jenc, jnp.asarray(lens), dec_in.shape[1] + 1)
    for t in range(dec_in.shape[1]):
        logits, state = bart.decode_step(cfg, params, state, dec_in[:, t], t)
        jlogits, jstate = jbart.decode_step(jcfg, jparams, jstate,
                                            jnp.asarray(dec_in[:, t], jnp.int32), jnp.int32(t))
        np.testing.assert_allclose(logits.numpy(), want[:, t], rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **JAX_TOL)


@pytest.mark.parametrize("marian,seed", [(False, 4), (True, 6)])
def test_greedy_generate_matches_hf_and_jax(marian, seed):
    hf = make_hf_marian(seed=seed) if marian else make_hf(seed=seed)
    cfg, params, jcfg, jparams = _both(hf, marian)
    if marian:
        assert "enc_eln_w" not in params and cfg.pos_offset == 0
    ids = np.random.RandomState(seed + 1).randint(3, 96, size=(2, 8)).astype(np.int64)
    lens = np.full((2,), 8, np.int32)
    with torch.no_grad():
        want = hf.generate(torch.from_numpy(ids), max_new_tokens=8, do_sample=False,
                           num_beams=1).numpy()[:, 1:]
    got = bart.greedy_generate(cfg, params, ids, lens, 8)
    ref = jbart.greedy_generate(jcfg, jparams, jnp.asarray(ids), jnp.asarray(lens), 8)
    np.testing.assert_array_equal(got, ref)
    for b in range(2):
        for i in range(min(want.shape[1], got.shape[1])):
            assert got[b, i] == want[b, i], (b, i, got[b], want[b])
            if want[b, i] == cfg.end_id:
                break


def test_marian_swish_is_silu_as_in_hf_not_the_jax_packages_gelu():
    """Fault pinned (ROADMAP queue 3): the JAX config parser maps Marian's
    published activation "swish" to gelu; HF runs SiLU. The port maps it to
    SiLU, and its logits match HF's where the JAX package's do not."""
    torch.manual_seed(8)
    hf = transformers.MarianMTModel(transformers.MarianConfig(
        vocab_size=96, d_model=32, encoder_layers=2, decoder_layers=2,
        encoder_attention_heads=4, decoder_attention_heads=4, encoder_ffn_dim=64,
        decoder_ffn_dim=64, max_position_embeddings=64, decoder_start_token_id=1,
        pad_token_id=1, eos_token_id=0, activation_function="swish")).eval()
    with torch.no_grad():  # FFN inputs of order 1, where swish and gelu part
        for name, t in hf.named_parameters():
            if ".fc1." in name:
                t.mul_(30.0)
    cfg, params, jcfg, jparams = _both(hf, marian=True)
    assert cfg.activation == "silu" and jcfg.activation == "gelu"
    ids = np.random.RandomState(9).randint(3, 96, size=(1, 7)).astype(np.int64)
    lens = np.array([7], np.int32)
    with torch.no_grad():
        want = hf(input_ids=torch.from_numpy(ids),
                  decoder_input_ids=torch.tensor([[cfg.start_id]])).logits.numpy()[:, 0]
    state = bart.init_decoder_state(cfg, params, bart.encode(cfg, params, ids, lens), lens, 2)
    got, _ = bart.decode_step(cfg, params, state, [cfg.start_id], 0)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    jenc = jbart.encode(jcfg, jparams, jnp.asarray(ids), jnp.asarray(lens))
    jstate = jbart.init_decoder_state(jcfg, jparams, jenc, jnp.asarray(lens), 2)
    jgot, _ = jbart.decode_step(jcfg, jparams, jstate, jnp.asarray([cfg.start_id], jnp.int32),
                                jnp.int32(0))
    assert np.abs(np.asarray(jgot) - want).max() > 10 * 2e-4  # ten times the HF tolerance


@pytest.mark.parametrize("name", ["bart", "marian"])
def test_registry_serves_bart_and_marian(name):
    fam = registry.get(name)
    assert fam.encode is bart.encode and fam.decode_step is bart.decode_step
    hf = make_hf_marian(seed=0) if name == "marian" else make_hf(seed=0)
    cfg = fam.config_from_hf(hf.config)
    params = fam.params_from_hf(cfg, hf.state_dict(), device="cpu")
    ids = np.random.RandomState(0).randint(3, 96, size=(1, 6)).astype(np.int32)
    assert fam.encode(cfg, params, ids, np.array([6])).shape == (1, 6, 32)
