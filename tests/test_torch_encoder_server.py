"""The port's EncoderBatchingServer (fastertransformer4codefuse_tpu_torch/
engine/encoder_server.py) and model registry, against tests/test_encoder_server.py:
concurrent requests coalesce into batched forwards, each result equal to its
solo encode, for BERT and for Longformer on its K12 route (the plain version
on the CPU); an oversize request is refused and the server lives on; a
failing batch fails its own requests only.

Tolerance: rtol 2e-5 / atol 2e-6 in fp32, the JAX test's own (a batched row
differs from a solo one only in summation order)."""
import threading

import numpy as np
import pytest
import torch
import transformers

import jax.numpy as jnp

from fastertransformer4codefuse_tpu.models import bert as jbert
from fastertransformer4codefuse_tpu_torch.engine.encoder_server import (
    EncoderBatchingServer,
    T5BatchingServer,
)
from fastertransformer4codefuse_tpu_torch.models import bert, longformer, registry
from test_bert import make_hf_bert
from test_longformer import make_hf

torch.set_num_threads(2)
TOL = dict(rtol=2e-5, atol=2e-6)


def _serve_all(srv, reqs):
    """Submit every request from its own thread; their results in order."""
    results = [None] * len(reqs)

    def call(i):
        results[i] = srv.encode(reqs[i], timeout=120)

    ts = [threading.Thread(target=call, args=(i,)) for i in range(len(reqs))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert all(r is not None for r in results)
    return results


def _solo(engine, ids, bucket):
    W = -(-len(ids) // bucket) * bucket
    padded = np.zeros((1, W), np.int32)
    padded[0, : len(ids)] = ids
    h, p = engine.encode(padded, np.array([len(ids)], np.int32))
    return h.numpy()[0, : len(ids)], p.numpy()[0]


def test_bert_batches_and_matches_solo_and_jax():
    hf = make_hf_bert(seed=0)
    cfg = bert.config_from_hf_bert(hf.config)
    params = bert.params_from_hf_bert_state_dict(cfg, hf.state_dict(), device="cpu")
    jcfg = jbert.config_from_hf_bert(hf.config)
    jparams = jbert.params_from_hf_bert_state_dict(jcfg, hf.state_dict())
    eng = registry.get("bert").make_engine(cfg, params)
    rng = np.random.RandomState(1)
    reqs = [list(rng.randint(0, cfg.vocab_size, size=(n,)))
            for n in (5, 9, 3, 12, 7, 9, 4, 11, 6, 8)]
    srv = EncoderBatchingServer(eng, max_batch=8, seq_bucket=8, max_seq_len=32)
    try:
        results = _serve_all(srv, reqs)
        assert srv.batches_run < len(reqs), srv.batches_run  # batching happened
        assert srv.requests_served == len(reqs)
    finally:
        srv.close()
    for i, ((h, p), ids) in enumerate(zip(results, reqs)):
        assert h.dtype == np.float32 and h.shape == (len(ids), cfg.hidden_size)
        sh, sp = _solo(eng, ids, 8)
        np.testing.assert_allclose(h, sh, err_msg=str(i), **TOL)
        np.testing.assert_allclose(p, sp, **TOL)
        W = -(-len(ids) // 8) * 8
        padded = np.zeros((1, W), np.int32)
        padded[0, : len(ids)] = ids
        jh, jp = jbert.encode(jcfg, jparams, jnp.asarray(padded),
                              jnp.asarray([len(ids)], jnp.int32))
        np.testing.assert_allclose(h, np.asarray(jh)[0, : len(ids)], err_msg=str(i), **TOL)
        np.testing.assert_allclose(p, np.asarray(jp)[0], **TOL)


def test_longformer_batches_and_matches_solo():
    """Longformer behind the server rides K12's route (use_kernel=True)."""
    hf = make_hf(seed=4, window=[4, 8], layers=2)
    cfg = longformer.config_from_hf_longformer(hf.config)
    params = longformer.params_from_hf_longformer_state_dict(cfg, hf.state_dict(), device="cpu")
    eng = registry.get("longformer").make_engine(cfg, params)
    rng = np.random.RandomState(2)
    reqs = [list(rng.randint(2, 96, size=(n,))) for n in (21, 5, 13, 30, 8, 17)]
    srv = EncoderBatchingServer(eng, max_batch=4, seq_bucket=8, max_seq_len=32)
    try:
        results = _serve_all(srv, reqs)
        assert srv.batches_run < len(reqs) and srv.requests_served == len(reqs)
    finally:
        srv.close()
    for i, ((h, p), ids) in enumerate(zip(results, reqs)):
        sh, sp = _solo(eng, ids, 8)
        np.testing.assert_allclose(h, sh, err_msg=str(i), **TOL)
        np.testing.assert_allclose(p, sp, **TOL)


def test_rejects_oversize_and_survives():
    hf = make_hf_bert(seed=1)
    cfg = bert.config_from_hf_bert(hf.config)
    params = bert.params_from_hf_bert_state_dict(cfg, hf.state_dict(), device="cpu")
    srv = EncoderBatchingServer(registry.get("bert").make_engine(cfg, params), max_batch=4,
                                seq_bucket=8, max_seq_len=16)
    try:
        with pytest.raises(ValueError):
            srv.encode(list(range(40)))
        with pytest.raises(ValueError):
            srv.encode([])
        h, p = srv.encode([1, 2, 3], timeout=120)
        assert h.shape == (3, cfg.hidden_size) and p.shape == (cfg.hidden_size,)
    finally:
        srv.close()


class _FlakyEngine:
    """Fails its first batch, then returns the ids as the hidden state."""

    def __init__(self):
        self.calls = 0

    def encode(self, ids, lens):
        self.calls += 1
        if self.calls == 1:
            raise ValueError("boom")
        return torch.from_numpy(ids).float()[..., None], None


def test_a_failed_batch_fails_its_requests_and_the_server_lives_on():
    srv = EncoderBatchingServer(_FlakyEngine(), max_batch=4, seq_bucket=4)
    try:
        with pytest.raises(RuntimeError, match="encoder batch failed"):
            srv.encode([1, 2], timeout=60)
        h, p = srv.encode([7, 8, 9], timeout=60)
        assert p is None and h[:, 0].tolist() == [7.0, 8.0, 9.0]
        assert srv.batches_run == 1 and srv.requests_served == 1
    finally:
        srv.close()


def test_t5_server_is_not_ported_yet():
    with pytest.raises(NotImplementedError, match="item 18"):
        T5BatchingServer(object())


def test_registry_holds_the_ported_families_only():
    from fastertransformer4codefuse_tpu_torch import GptNeoXConfig, init_params
    from fastertransformer4codefuse_tpu_torch.engine.engine import GptNeoXEngine
    from fastertransformer4codefuse_tpu_torch.models import gptneox

    assert set(registry.families()) == {"gptneox", "bert", "longformer"}
    with pytest.raises(KeyError, match="registered: \\['bert', 'gptneox', 'longformer'\\]"):
        registry.get("t5")
    fam = registry.get("gptneox")
    assert fam.prefill is gptneox.prefill and fam.decode_step is gptneox.decode_step
    assert fam.lm_logits is gptneox.lm_logits and fam.encode is None
    from fastertransformer4codefuse_tpu_torch.ckpt import convert

    assert fam.config_from_hf is convert.config_from_hf
    hf_cfg = transformers.GPTNeoXConfig(vocab_size=64, hidden_size=32, num_hidden_layers=1,
                                        num_attention_heads=4, intermediate_size=64)
    hf = transformers.GPTNeoXForCausalLM(hf_cfg).eval()
    tcfg = fam.config_from_hf(hf.config)
    tp = fam.params_from_hf(tcfg, hf.state_dict(), device="cpu")
    assert tp["layers"]["qkv_w"].shape == (1, 32, 96) and tp["embed"].device.type == "cpu"
    cfg = GptNeoXConfig.tiny(vocab_size=64)
    eng = fam.make_engine(cfg, init_params(cfg, device="cpu"))
    assert isinstance(eng, GptNeoXEngine)
    assert registry.get("bert").make_engine is bert.BertEngine
    assert registry.get("bert").encode is bert.encode
    assert registry.get("longformer").encode is longformer.encode
