"""The port against HuggingFace GPTNeoXForCausalLM through the port's own HF
converter (``ckpt/convert.py``), on the CPU: the cases of
tests/test_hf_parity.py. Logits within atol 2e-4 / rtol 2e-3 (fp32), greedy
tokens identical up to the end token; both residual modes, and a ragged
batch against per-sequence HF decoding. HF's ``hidden_act="gelu"`` is the
exact gelu, so the quantized form of the parallel-residual model decodes
through K13 + K3."""
import numpy as np
import pytest
import torch
import transformers

from fastertransformer4codefuse_tpu_torch import GptNeoXEngine, RuntimeConfig
from fastertransformer4codefuse_tpu_torch.ckpt.convert import config_from_hf, params_from_hf_state_dict
from fastertransformer4codefuse_tpu_torch.ckpt.quantize import quantize_params
from fastertransformer4codefuse_tpu_torch.engine import kv_cache as kvc
from fastertransformer4codefuse_tpu_torch.models import gptneox as model

torch.set_num_threads(2)


def make_hf(parallel_residual=True, seed=0):
    torch.manual_seed(seed)
    hf_cfg = transformers.GPTNeoXConfig(
        vocab_size=96, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=256, rotary_pct=0.25, max_position_embeddings=128,
        use_parallel_residual=parallel_residual, bos_token_id=0, eos_token_id=95,
        hidden_act="gelu",
    )
    return transformers.GPTNeoXForCausalLM(hf_cfg).eval()


def _port(hf):
    cfg = config_from_hf(hf.config)
    return cfg, params_from_hf_state_dict(cfg, hf.state_dict(), dtype="fp32", device="cpu")


@pytest.mark.parametrize("parallel_residual", [True, False])
def test_logits_parity(parallel_residual):
    hf = make_hf(parallel_residual)
    cfg, params = _port(hf)
    assert cfg.use_gptj_residual == parallel_residual and cfg.activation == "gelu"
    B, S = 2, 12
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size, size=(B, S))
    with torch.no_grad():
        hf_logits = hf(torch.tensor(ids, dtype=torch.long)).logits.numpy()
    cache = kvc.init_cache(cfg, B, S, torch.float32, "cpu")
    hidden, _ = model.prefill(cfg, params, torch.tensor(ids), torch.full((B,), S, dtype=torch.int32),
                              cache)
    ours = model.lm_logits(cfg, params, hidden).numpy()
    np.testing.assert_allclose(ours, hf_logits, atol=2e-4, rtol=2e-3)


def hf_greedy(hf, ids, steps):
    ids = torch.tensor(ids, dtype=torch.long)
    with torch.no_grad():
        for _ in range(steps):
            nxt = hf(ids).logits[:, -1].argmax(-1, keepdim=True)
            ids = torch.cat([ids, nxt], dim=1)
    return ids.numpy()


def _compare_until_end(ours_row, hf_row, end_id):
    for a, b in zip(ours_row, hf_row):
        assert a == b, f"{ours_row} != {hf_row}"
        if a == end_id:
            break


@pytest.mark.parametrize("parallel_residual", [True, False])
def test_greedy_decode_parity(parallel_residual):
    hf = make_hf(parallel_residual)
    cfg, params = _port(hf)
    eng = GptNeoXEngine(cfg, params, RuntimeConfig(dtype="fp32", seq_bucket=4))
    B, S, OUT = 2, 10, 8
    ids = np.random.RandomState(1).randint(0, cfg.vocab_size - 1, size=(B, S))
    hf_ids = hf_greedy(hf, ids, OUT)
    out = eng.generate([list(r) for r in ids], output_len=OUT, top_k=1)
    for b in range(B):
        _compare_until_end(out.output_ids[b, 0, S:S + OUT], hf_ids[b, S:], cfg.end_id)


def test_greedy_decode_parity_ragged():
    hf = make_hf(True)
    cfg, params = _port(hf)
    eng = GptNeoXEngine(cfg, params, RuntimeConfig(dtype="fp32", seq_bucket=4))
    OUT = 6
    rng = np.random.RandomState(2)
    prompts = [list(rng.randint(0, cfg.vocab_size - 1, size=(n,))) for n in (3, 9, 6)]
    out = eng.generate(prompts, output_len=OUT, top_k=1)
    for b, p in enumerate(prompts):
        hf_ids = hf_greedy(hf, np.asarray([p]), OUT)
        _compare_until_end(out.output_ids[b, 0, len(p):len(p) + OUT], hf_ids[0, len(p):],
                           cfg.end_id)
        assert out.sequence_lengths[b, 0] <= len(p) + OUT


@pytest.mark.parametrize("bits,G", [(8, 0), (4, 16)])
def test_hf_converted_checkpoint_decodes_through_k13_and_k3(bits, G, monkeypatch):
    """An HF-converted model (exact gelu), quantized: every decode layer runs
    K13 then K3 (prefill K13 and two GEMMs), and the tokens equal the unfused route's
    (``fused_decode=False``: four GEMMs a layer, no fused kernel)."""
    hf = make_hf(True)
    cfg, params = _port(hf)
    qp = quantize_params(params, weight_bits=bits, group_size=G)
    calls = {}
    for name in ("fused_qkv_up", "fused_proj_down"):
        fn = getattr(model, name)
        monkeypatch.setattr(model, name, lambda *a, _fn=fn, _n=name, **k: (
            calls.__setitem__(_n, calls.get(_n, 0) + 1), _fn(*a, **k))[1])
    outs = []
    for fused in (True, False):
        calls.clear()
        eng = GptNeoXEngine(cfg, qp, RuntimeConfig(dtype="fp32", int8_mode=1, seq_bucket=4,
                                                   fused_decode=fused))
        outs.append(eng.generate([[5, 9, 3, 17], [11, 4]], output_len=6, top_k=1))
        L, n = cfg.layer_num, cfg.layer_num * eng.decode_forwards
        # one prefill (K13's GEMM form) and the decode forwards (K13 + K3)
        assert calls == ({"fused_qkv_up": L + n, "fused_proj_down": n} if fused else {})
    np.testing.assert_array_equal(outs[0].output_ids, outs[1].output_ids)
