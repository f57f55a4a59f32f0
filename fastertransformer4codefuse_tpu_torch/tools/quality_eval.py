"""Quantization quality-delta harness (port of the JAX repo's
tools/quality_eval.py).

Mean next-token negative log likelihood of the model over a token stream,
for any weight precision (float, int8, int4) and KV-cache dtype, and greedy
agreement between two engine configurations. The same signatures as the JAX
functions; ``a8`` (keyword) runs the prefill's GEMMs as SmoothQuant W8A8,
the engine's ``act_int8`` (the JAX tool switches it process-wide). Inference
runs under ``torch.no_grad()`` on the params' device.

    from fastertransformer4codefuse_tpu_torch.tools.quality_eval import eval_nll
    nll_fp = eval_nll(cfg, params_fp, token_ids)
    nll_i8 = eval_nll(cfg, quantize_params(params_fp), token_ids)
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..core.config import GptNeoXConfig
from ..engine import kv_cache as kvc
from ..models import gptneox as model
from ..ops.rotary import make_rotary_tables


def _device(params):
    return params["final_ln_w"].device


def _chunk_nll(config: GptNeoXConfig, params, chunk_ids: torch.Tensor, a8=False):
    """Sum of next-token NLL over one teacher-forced chunk [S] (a device
    scalar)."""
    S = chunk_ids.shape[0]
    dev = chunk_ids.device
    cache = kvc.init_cache(config, 1, S, torch.bfloat16, dev)
    hidden, _ = model.prefill(config, params, chunk_ids[None],
                              torch.full((1,), S, dtype=torch.int32, device=dev), cache, a8=a8)
    logits = model.lm_logits(config, params, hidden)[0]  # [S, V]
    lp = torch.log_softmax(logits[:-1], dim=-1)
    return -lp.gather(1, chunk_ids[1:, None].long()).sum()


@torch.no_grad()
def eval_nll(
    config: GptNeoXConfig,
    params,
    token_ids: Sequence[int],
    chunk: int = 512,
    *,
    a8: bool = False,
) -> float:
    """Mean next-token negative log likelihood over a token stream
    (perplexity = exp(result)), in chunked prefills; one host read at the
    end."""
    ids = torch.from_numpy(np.asarray(token_ids, np.int32)).to(_device(params))
    total_nll = torch.zeros((), dtype=torch.float64, device=ids.device)
    total_tok = 0
    for start in range(0, len(ids) - 1, chunk):
        piece = ids[start: start + chunk + 1]
        if len(piece) < 2:
            break
        total_nll += _chunk_nll(config, params, piece, a8).double()
        total_tok += len(piece) - 1
    return float(total_nll) / max(total_tok, 1)


def _decode_chunk_nll(config, params, chunk_ids, kv_dtype, prefix):
    """Sum of next-token NLL over one chunk, the predictions made through
    the decode path (teacher-forced), so that the quantized KV cache is
    read: a prefill NLL cannot see the KV-cache dtype at all."""
    S = chunk_ids.shape[0]
    Sc = S + (S % 2)  # packed caches need an even capacity
    dev = chunk_ids.device
    cache = kvc.init_cache(config, 1, Sc, kv_dtype, dev)
    hidden, cache = model.prefill(config, params, chunk_ids[None, :prefix],
                                  torch.full((1,), prefix, dtype=torch.int32, device=dev), cache)
    rot = make_rotary_tables(Sc, config.rotary_embedding_dim, config.rotary_base, dev)

    def lp_of(hid, tgt):
        logits = model.lm_logits(config, params, hid[None])[0, -1]
        return torch.log_softmax(logits, dim=-1)[tgt]

    total = lp_of(hidden[0, -1:], chunk_ids[prefix].long())
    for t in range(prefix, S - 1):
        hid, cache = model.decode_step(config, params, chunk_ids[t][None],
                                       torch.tensor([t], dtype=torch.int32, device=dev), cache,
                                       rotary_tables=rot)  # hid [1, H]
        total = total + lp_of(hid, chunk_ids[t + 1].long())
    return -total


@torch.no_grad()
def eval_decode_nll(
    config: GptNeoXConfig,
    params,
    token_ids: Sequence[int],
    kv_dtype,
    chunk: int = 256,
    prefix: int = 32,
) -> float:
    """Mean next-token NLL with the predictions flowing through decode
    attention over a ``kv_dtype`` cache (a torch dtype, ``"int4"`` or
    ``"int8k_int4v"``): the KV-quantization quality measurement."""
    ids = torch.from_numpy(np.asarray(token_ids, np.int32)).to(_device(params))
    total_nll = torch.zeros((), dtype=torch.float64, device=ids.device)
    total_tok = 0
    for start in range(0, len(ids) - 1, chunk):
        piece = ids[start: start + chunk + 1]
        if len(piece) != chunk + 1:
            break
        total_nll += _decode_chunk_nll(config, params, piece, kv_dtype, prefix).double()
        total_tok += chunk + 1 - prefix
    return float(total_nll) / max(total_tok, 1)


def greedy_agreement(
    engine_a, engine_b, prompts: List[List[int]], output_len: int = 32
) -> float:
    """Fraction of greedy tokens on which two engine configs agree."""
    match, total = 0, 0
    for p in prompts:
        oa = engine_a.generate([p], output_len=output_len, top_k=1)
        ob = engine_b.generate([p], output_len=output_len, top_k=1)
        na = int(oa.sequence_lengths[0, 0])
        nb = int(ob.sequence_lengths[0, 0])
        n = min(na, nb)
        ra = oa.output_ids[0, 0, len(p): n]
        rb = ob.output_ids[0, 0, len(p): n]
        match += int((ra == rb).sum())
        total += max(na, nb) - len(p)
    return match / max(total, 1)
