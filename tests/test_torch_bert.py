"""The port's BERT (fastertransformer4codefuse_tpu_torch/models/bert.py) against
the JAX package's ``encode`` and HF ``BertModel`` on tests/test_bert.py's
tiny config: fp32, and int8 weights whose GEMMs go to K1 (its plain version
on the CPU).

Tolerances: atol 5e-4 / rtol 3e-3 against HF (the JAX test's own); against
the JAX package rtol 2e-5 / atol 2e-6 in fp32 (summation order only), the
int8 weights bit-identical (the same quantizer), and their outputs within
rtol 2e-5 / atol 2e-6 of the JAX int8 path."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fastertransformer4codefuse_tpu.models import bert as jbert
from fastertransformer4codefuse_tpu_torch.models import bert
from fastertransformer4codefuse_tpu_torch.models import registry
from fastertransformer4codefuse_tpu_torch.models.params import QuantizedTensor
from fastertransformer4codefuse_tpu_torch.ops import quant_matmul as qm
from test_bert import make_hf_bert

torch.set_num_threads(2)
HF_TOL = dict(atol=5e-4, rtol=3e-3)
JAX_TOL = dict(rtol=2e-5, atol=2e-6)


def _both(seed):
    hf = make_hf_bert(seed=seed)
    cfg = bert.config_from_hf_bert(hf.config)
    params = bert.params_from_hf_bert_state_dict(cfg, hf.state_dict(), device="cpu")
    jparams = jbert.params_from_hf_bert_state_dict(jbert.config_from_hf_bert(hf.config),
                                                   hf.state_dict())
    return hf, cfg, params, jparams


def _ragged(cfg, B, S, lens, seed):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    tt = (rng.rand(B, S) > 0.5).astype(np.int32)
    return ids, tt, np.asarray(lens, np.int32)


@pytest.mark.parametrize("seed,lens", [(0, [10, 10]), (1, [12, 7])])
def test_fp32_matches_hf_and_jax(seed, lens):
    hf, cfg, params, jparams = _both(seed)
    B, S = len(lens), max(lens)
    ids, tt, ln = _ragged(cfg, B, S, lens, seed=2)
    am = (np.arange(S)[None, :] < ln[:, None]).astype(np.int64)
    with torch.no_grad():
        out = hf(torch.from_numpy(ids).long(), attention_mask=torch.from_numpy(am),
                 token_type_ids=torch.from_numpy(tt).long())
    got_h, got_p = bert.encode(cfg, params, torch.from_numpy(ids), torch.from_numpy(ln),
                               torch.from_numpy(tt))
    want_h, want_p = jbert.encode(jbert.config_from_hf_bert(hf.config), jparams,
                                  jnp.asarray(ids), jnp.asarray(ln), jnp.asarray(tt))
    for b, n in enumerate(lens):
        np.testing.assert_allclose(got_h.numpy()[b, :n], out.last_hidden_state.numpy()[b, :n],
                                   **HF_TOL)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **JAX_TOL)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), **JAX_TOL)
    if lens[0] == lens[1]:
        np.testing.assert_allclose(got_p.numpy(), out.pooler_output.numpy(), **HF_TOL)


def test_int8_matches_jax_int8_and_goes_through_k1():
    hf, cfg, params, jparams = _both(seed=3)
    qp = bert.quantize_bert_params(params)
    jqp = jbert.quantize_bert_params(jparams)
    for name in ("qkv_w", "proj_w", "up_w", "down_w"):
        w, jw = qp["layers"][name], jqp["layers"][name]
        assert isinstance(w, QuantizedTensor) and w.bits == 8 and w.k_axis == -2
        np.testing.assert_array_equal(w.q.numpy(), np.asarray(jw.q))
        np.testing.assert_array_equal(w.scale.numpy(), np.asarray(jw.scale))
    ids, _, ln = _ragged(cfg, 2, 10, [10, 7], seed=5)
    launches = qm.quant_matmul.launches
    got_h, got_p = bert.encode(cfg, qp, ids, ln)
    assert qm.quant_matmul.launches == launches  # CPU: the plain version of K1
    want_h, want_p = jbert.encode(jbert.config_from_hf_bert(hf.config), jqp, jnp.asarray(ids),
                                  jnp.asarray(ln))
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **JAX_TOL)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), **JAX_TOL)
    # and the int8 model stays near the float one (quantization error only)
    fp_h, _ = bert.encode(cfg, params, ids, ln)
    assert (got_h - fp_h).abs().max() < 0.1


def test_engine_takes_numpy_and_tensors_and_refuses_a_mesh():
    hf, cfg, params, _ = _both(seed=4)
    ids, _, ln = _ragged(cfg, 2, 9, [9, 6], seed=6)
    eng = registry.get("bert").make_engine(cfg, params)
    a_h, a_p = eng.encode(ids, ln)
    b_h, b_p = eng.encode(torch.from_numpy(ids), torch.from_numpy(ln))
    ref_h, ref_p = bert.encode(cfg, params, torch.from_numpy(ids), torch.from_numpy(ln))
    assert torch.equal(a_h, ref_h) and torch.equal(b_h, ref_h) and torch.equal(b_p, ref_p)
    # a mesh is served (tests/test_torch_parallel_families.py); one whose tp
    # does not split the heads is refused
    from fastertransformer4codefuse_tpu_torch.parallel.distributed import Mesh

    with pytest.raises(ValueError, match="do not split"):
        bert.BertEngine(cfg, params, mesh=Mesh(tp=3))


def test_params_default_to_the_card():
    """Without device= the converter builds on CUDA, and raises without a card."""
    hf = make_hf_bert(seed=0)
    cfg = bert.config_from_hf_bert(hf.config)
    if torch.cuda.is_available():
        p = bert.params_from_hf_bert_state_dict(cfg, hf.state_dict())
        assert p["embed"].is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bert.params_from_hf_bert_state_dict(cfg, hf.state_dict())
