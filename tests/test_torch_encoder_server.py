"""The port's EncoderBatchingServer (fastertransformer4codefuse_tpu_torch/
engine/encoder_server.py) and model registry, against tests/test_encoder_server.py:
concurrent requests coalesce into batched forwards, each result equal to its
solo encode, for BERT and for Longformer on its K12 route (the plain version
on the CPU); an oversize request is refused and the server lives on; a
failing batch fails its own requests only.

Tolerance: rtol 2e-5 / atol 2e-6 in fp32, the JAX test's own (a batched row
differs from a solo one only in summation order)."""
import threading
import time

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


class _HeldEngine:
    """An engine whose first ``method`` call (the server's first batch)
    waits until the test's other requests are all in the server's mailbox,
    so that they coalesce for certain rather than as the threads happen to
    arrive. ``srv``, the server driving it, is set after the server is
    built. Every other attribute is the engine's."""

    def __init__(self, engine, method, total):
        self.engine, self.total, self.srv = engine, total, None
        self.queued = threading.Event()  # set once the rest are queued
        real = getattr(engine, method)

        def held(ids, *args, **kw):
            if not self.queued.is_set():
                deadline = time.monotonic() + 60
                while (len(self.srv._mailbox) + len(ids) < self.total
                       and time.monotonic() < deadline):
                    time.sleep(0.005)
                self.queued.set()
            return real(ids, *args, **kw)

        setattr(self, method, held)

    def __getattr__(self, name):
        return getattr(self.engine, name)


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
    held = _HeldEngine(eng, "encode", len(reqs))
    srv = held.srv = EncoderBatchingServer(held, max_batch=8, seq_bucket=8, max_seq_len=32)
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
    held = _HeldEngine(eng, "encode", len(reqs))
    srv = held.srv = EncoderBatchingServer(held, max_batch=4, seq_bucket=8, max_seq_len=32)
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
    """Once a refusal naming ROADMAP item 18; the T5 server is ported now
    and serves (``test_t5_server_batches_and_matches_solo`` holds it)."""
    srv = T5BatchingServer(_FlakyT5Engine(), max_batch=2)
    try:
        out = srv.generate([5, 6, 7], 3, timeout=60)
        assert out.output_ids.tolist() == [[5, 6, 7]] and srv.batches_run == 1
    finally:
        srv.close()


class _FlakyT5Engine:
    """Echoes each request's first ``output_len`` ids as its one beam; fails
    when a request asks for an output of 99."""

    def generate(self, ids, output_len, beam_width=1, **kw):
        from fastertransformer4codefuse_tpu_torch.engine.t5_engine import T5Output

        if output_len == 99:
            raise ValueError("boom")
        out = np.array([list(r[:output_len]) + [0] * (output_len - len(r[:output_len]))
                        for r in ids])[:, None]
        n = len(ids)
        return T5Output(out, np.full((n, 1), output_len), np.zeros((n, 1), np.float32))


def test_t5_server_batches_and_matches_solo():
    """tests/test_encoder_server.py's T5 case: concurrent greedy requests
    and a seeded sampled one with the same statics coalesce into fewer
    engine calls, each equal to its solo run through the same engine and to
    the JAX engine's; a beam request (other statics) runs in a batch of its
    own and equals the engine's beams; the telemetry counts the calls."""
    from fastertransformer4codefuse_tpu.engine.t5_engine import T5Engine as JaxT5Engine
    from fastertransformer4codefuse_tpu.models import t5 as jt5
    from fastertransformer4codefuse_tpu_torch.engine.t5_engine import T5Engine
    from fastertransformer4codefuse_tpu_torch.models import t5
    from test_t5_engine import ids_for, make_hf_t5

    hf = make_hf_t5(seed=2)
    cfg = t5.config_from_hf_t5(hf.config)
    eng = T5Engine(cfg, t5.params_from_hf_t5_state_dict(cfg, hf.state_dict(), device="cpu"))
    jcfg = jt5.config_from_hf_t5(hf.config)
    jeng = JaxT5Engine(jcfg, jt5.params_from_hf_t5_state_dict(jcfg, hf.state_dict()))
    ids = ids_for(cfg, 6, 7)
    reqs = [(list(ids[i][: 4 + i % 4]), dict(top_k=1) if i != 3 else
             dict(top_k=5, top_p=0.9, temperature=0.8, random_seed=77)) for i in range(6)]
    solo = [eng.generate([r], 6, **kw) for r, kw in reqs]
    held = _HeldEngine(eng, "generate", len(reqs))
    srv = held.srv = T5BatchingServer(held, max_batch=8, seq_bucket=8, max_seq_len=32)
    try:
        results = [None] * 6

        def call(i):
            results[i] = srv.generate(reqs[i][0], 6, timeout=120, **reqs[i][1])

        ts = [threading.Thread(target=call, args=(i,)) for i in range(6)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        for i, (r, kw) in enumerate(reqs):
            np.testing.assert_array_equal(results[i].output_ids, solo[i].output_ids[0])
            np.testing.assert_array_equal(results[i].sequence_lengths,
                                          solo[i].sequence_lengths[0])
            if i != 3:  # greedy: the JAX engine's tokens too
                np.testing.assert_array_equal(results[i].output_ids,
                                              jeng.generate([r], 6, **kw).output_ids[0])
        assert srv.batches_run < 6 and srv.requests_served == 6
        runs = srv.batches_run
        ob = srv.generate(reqs[0][0], 6, beam_width=2, timeout=120)
        ref = eng.generate([reqs[0][0]], 6, beam_width=2)
        np.testing.assert_array_equal(ob.output_ids, ref.output_ids[0])
        np.testing.assert_allclose(ob.scores, ref.scores[0], rtol=1e-6)
        assert srv.batches_run == runs + 1 and srv.requests_served == 7
    finally:
        srv.close()


def test_t5_server_coalesces_by_statics_and_fails_only_the_failing_batch():
    """While a first batch runs, five requests queue: the head's
    (output_len, beam_width, length_penalty) peers ride its batch (at most
    max_batch), the others wait for the next; a batch that raises fails its
    own requests only."""
    eng = _FlakyT5Engine()
    srv = T5BatchingServer(eng, max_batch=2)
    calls, gate = [], threading.Event()
    real = eng.generate

    def recording(ids, output_len, **kw):
        calls.append([list(r) for r in ids])
        gate.wait(60)  # the first batch holds the server's thread until all are queued
        return real(ids, output_len, **kw)

    eng.generate = recording
    reqs = [([1], 2, 1.0), ([1, 2, 3], 2, 1.0), ([4, 5], 3, 1.0), ([6, 7, 8], 2, 1.0),
            ([9], 2, 1.0), ([3, 3], 2, 0.5)]
    results = [None] * len(reqs)

    def call(i):
        ids, n, lp = reqs[i]
        results[i] = srv.generate(ids, n, length_penalty=lp, timeout=60)

    ts = [threading.Thread(target=call, args=(i,)) for i in range(len(reqs))]
    try:
        for i, t in enumerate(ts):
            t.start()
            # one at a time: the first taken by the server's thread, the rest queued in order
            while not (calls if i == 0 else len(srv._mailbox) == i):
                threading.Event().wait(0.01)
        gate.set()
        for t in ts:
            t.join(timeout=60)
        assert [r.output_ids.tolist() for r in results] == [
            [[1, 0]], [[1, 2]], [[4, 5, 0]], [[6, 7]], [[9, 0]], [[3, 3]]]
        assert calls == [[[1]], [[1, 2, 3], [6, 7, 8]], [[4, 5]], [[9]], [[3, 3]]]
        assert srv.batches_run == 5 and srv.requests_served == 6
        with pytest.raises(RuntimeError, match="t5 batch failed"):
            srv.generate([1, 2], 99, timeout=60)
        assert srv.generate([8, 9], 1, timeout=60).output_ids.tolist() == [[8]]
        with pytest.raises(ValueError):
            srv.generate([], 2)
    finally:
        gate.set()
        srv.close()


def test_registry_holds_the_ported_families_only():
    """Every family the JAX registry serves, under its name and with its
    fields: the ten of the decoder graph and the encoders, and the
    encoder-decoder, vision and audio families."""
    from fastertransformer4codefuse_tpu.models import registry as jregistry
    from fastertransformer4codefuse_tpu_torch import GptNeoXConfig, init_params
    from fastertransformer4codefuse_tpu_torch.engine.engine import GptNeoXEngine
    from fastertransformer4codefuse_tpu_torch.models import gptneox

    assert set(registry.families()) == set(jregistry.families()) == {
        "gptneox", "llama", "qwen2", "gpt", "opt", "starcoder", "gptj", "mixtral", "bert",
        "longformer", "t5", "bart", "marian", "vit", "swin", "deberta", "xlnet", "conformer"}
    for name, jfam in jregistry.families().items():
        fam = registry.get(name)
        for field in ("decode_step", "lm_logits", "encode"):
            assert (getattr(fam, field) is None) == (getattr(jfam, field) is None), (name, field)
    with pytest.raises(KeyError, match="registered: \\['bart', 'bert', 'conformer', "):
        registry.get("t5x")
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
