"""Text-in/text-out generation (port of api/generate.py).

Tokenize, encode stop/bad words, resolve the partial last word through the
trie, run the engine, strip padding and trailing garbage, and return
``(outputs, output_lengths, cum_log_probs, latency)`` -- the reference
``generate()`` contract.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, List, Optional

import numpy as np

from ..core.config import RuntimeConfig
from ..engine.engine import GptNeoXEngine
from .detok import trim_garbage
from .trie import VocabTrie, optional_last_token_ids
from .wordlist import to_word_list_format

logger = logging.getLogger(__name__)


def load_tokenizer(tokenizer_path: str):
    """The HF tokenizer at ``tokenizer_path`` (``transformers`` is imported
    here, on first use; tests and `chip_smoke.py` replace this function)."""
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(tokenizer_path)


def init_engine_and_tokenizer(
    ckpt_path: str,
    tokenizer_path: str,
    tensor_parallel: int = 1,
    int8_mode: int = 0,
    dtype: str = "bf16",
    trie_needed: bool = False,
    end_id: Optional[int] = None,
    runtime: Optional[RuntimeConfig] = None,
    weight_bits: int = 8,
    group_size: int = 0,
    kv_cache_dtype: Optional[str] = None,
    q_layout: str = "plain",
    quantize_embeddings: Optional[bool] = None,
    device=None,
):
    """Load ``config.ini``, the weights and the tokenizer, and build the engine
    on ``device`` (the card when None); with ``trie_needed`` also the vocab
    trie (the native one where its library is built). ``weight_bits=4``
    serves a ``.q4.bin`` / ``.s4[gN].bin`` checkpoint (or quantizes a float
    one on load), ``group_size`` picks group-wise int4 scales,
    ``kv_cache_dtype`` the KV cache, and ``quantize_embeddings`` quantizes
    the embedding table and LM head too (``int8_mode=2`` is its alias).
    ``tensor_parallel`` > 1 joins the process group (``torchrun``'s env://
    rendezvous, ``parallel.distributed.init_distributed``; gloo on the CPU,
    NCCL on a card a rank) and keeps this
    rank's slice of the weights: every rank must then serve the same
    requests in the same order. Returns (engine, tokenizer) or (engine,
    tokenizer, trie)."""
    from ..ckpt.loader import load_bin_checkpoint

    mesh = None
    if tensor_parallel > 1:
        from ..parallel.distributed import init_distributed
        from ..parallel.sharding import build_mesh

        init_distributed(device=device)
        mesh = build_mesh(tp=tensor_parallel)
    config, params = load_bin_checkpoint(
        ckpt_path, dtype=dtype, int8_mode=int8_mode, weight_bits=weight_bits,
        group_size=group_size, q_layout=q_layout, quantize_embeddings=quantize_embeddings,
        device=device,
    )
    if end_id is not None:
        config = dataclasses.replace(config, end_id=end_id)
    tokenizer = load_tokenizer(tokenizer_path)
    runtime = runtime or RuntimeConfig(dtype=dtype, int8_mode=int8_mode,
                                       kv_cache_dtype=kv_cache_dtype,
                                       tensor_para_size=tensor_parallel)
    engine = GptNeoXEngine(config, params, runtime, mesh=mesh)
    if trie_needed:
        from .. import native

        vocab = tokenizer.get_vocab()
        if native.available():
            trie = native.NativeTrie(vocab)
        else:
            logger.info("native library unavailable: the Python vocab trie serves")
            trie = VocabTrie(vocab)
        return engine, tokenizer, trie
    return engine, tokenizer


def generate(
    engine: GptNeoXEngine,
    tokenizer,
    texts: Optional[List[str]],
    output_len: int,
    beam_width: int = 1,
    top_k=None,
    top_p=None,
    beam_search_diversity_rate=None,
    temperature=None,
    len_penalty=None,
    repetition_penalty=None,
    presence_penalty=None,
    min_length=None,
    random_seed=None,
    input_ids_list: Optional[List[List[int]]] = None,
    callback: Optional[Callable[[dict], None]] = None,
    stop_words_list: Optional[List[List[str]]] = None,
    bad_words_list: Optional[List[List[str]]] = None,
    last_token_list: Optional[List[str]] = None,
    trie: Optional[VocabTrie] = None,
    return_cum_log_probs: int = 1,
    output_log_probs: bool = False,
):
    """Returns (outputs [B][beam] str, output_lengths [B][beam],
    cum_log_probs [B][beam], latency_s), plus the per-step log-probs
    [B][beam][out_len] when ``output_log_probs``."""
    if texts is None and input_ids_list is None:
        raise ValueError("pass texts or input_ids_list")
    end_id = engine.config.end_id
    if texts is not None:
        input_ids_list = [list(tokenizer.encode(t)) for t in texts]
    else:
        input_ids_list = [list(ids) for ids in input_ids_list]

    sw = to_word_list_format(stop_words_list, tokenizer) if stop_words_list is not None else None
    bw_list = (
        to_word_list_format(bad_words_list, tokenizer) if bad_words_list is not None else None
    )

    olt = None
    if last_token_list is not None:
        if trie is None:
            raise ValueError("trie is None, can't select last token")
        id_lists = [
            optional_last_token_ids(trie, lt, end_id) if lt else [-1]
            for lt in last_token_list
        ]
        width = max(len(x) for x in id_lists)
        olt = np.full((len(id_lists), width), -1, np.int32)
        for i, ids in enumerate(id_lists):
            olt[i, : len(ids)] = ids

    start = time.time()
    out = engine.generate(
        input_ids_list,
        output_len=output_len,
        beam_width=beam_width,
        top_k=top_k,
        top_p=top_p,
        temperature=temperature,
        repetition_penalty=repetition_penalty,
        presence_penalty=presence_penalty,
        min_length=min_length,
        random_seed=random_seed,
        stop_words_list=sw,
        bad_words_list=bw_list,
        optional_last_tokens=olt,
        callback=callback,
        beam_search_diversity_rate=beam_search_diversity_rate,
        len_penalty=len_penalty,
        return_cum_log_probs=bool(return_cum_log_probs),
        output_log_probs=output_log_probs,
    )
    latency = time.time() - start

    outputs: List[List[str]] = []
    output_lengths: List[List[int]] = []
    for b, ids in enumerate(input_ids_list):
        in_len = len(ids)
        beam_outputs, beam_lengths = [], []
        for beam in range(out.output_ids.shape[1]):
            gen = []
            for tok in out.output_ids[b, beam][in_len:]:
                if tok == end_id:
                    break
                gen.append(int(tok))
            beam_outputs.append(trim_garbage(tokenizer.decode(gen)))
            beam_lengths.append(len(gen))
        outputs.append(beam_outputs)
        output_lengths.append(beam_lengths)

    if output_log_probs:
        return (
            outputs, output_lengths, out.cum_log_probs.tolist(), latency,
            out.output_log_probs.tolist(),
        )
    return outputs, output_lengths, out.cum_log_probs.tolist(), latency
