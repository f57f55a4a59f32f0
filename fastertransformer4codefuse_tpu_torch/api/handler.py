"""Serving handler: request dict -> batched generation -> JSON response (port
of the static path of api/handler.py).

Same request schema, per-prompt defaults (top_k=50, top_p=0, temperature=1,
repetition_penalty=1), streaming through per-(batch, beam) incremental
detokenizers, and response schema {latency, random_seed, generated_code,
length, cum_log_prob}.

With ``pool=dict(...)`` (or a list of them: length classes) the handler
routes requests through a continuous-batching slot pool
(``engine/server.py``): concurrent ``predict`` calls from different threads
interleave mid-flight. Sampling semantics, streaming, stop/bad words, trie
constraints and the response schema are the static path's; requests the pool
cannot route (too long, top_k outside the pool's cap, word lists wider than
its buffers) take the static path. A beam request (``beam_width > 1``)
rides a beam pool class of its width when the handler has one, except
streamed beams and beams with ``output_log_probs``: the static path streams
every beam's newest token and tracks per-step log-probs along each
hypothesis. A request with ``"speculative": true`` that is greedy and
processor-free rides prompt-lookup speculative decoding
(``engine/speculative.py``): a speculative pool class when the handler has
one that fits it (``pool=dict(speculative=True, spec_k=8, ...)``, streaming
included), else the static speculative loop (not streamed, no per-step
log-probs; several prompts share the batched loop), whose response also
carries ``"speculative"`` statistics; any other speculative request takes
the ordinary routes. A speculative pool class serves speculative requests
only.

Static-route requests (not pool-routable, the static speculative loop, or a
handler without ``pool=``) run one at a time as jobs on a driver thread
(``engine.server.LockstepPools``, as ``lockstep``): at one rank a driver
of their own, beside the pools'. On an engine whose mesh has several ranks
on any axis (``torchrun``; the JAX handler's ``pool=`` on a mesh) the
handler serves in lockstep over the process group: every rank builds it
alike, rank 0 takes the requests, and every other rank calls ``follow()``.
Rank 0 resolves each request, its drawn default seed included, and what it
resolved is what every rank serves: pooled requests ride the pools'
published admissions, and static-route jobs run on the pools' one driver
between rounds on every rank. A dp-only mesh leads from rank 0 too, since
the static route splits a batch's rows over dp: every dp group then serves
rank 0's requests.
"""
from __future__ import annotations

import json
import logging
import random
import time
import traceback
from typing import Callable, List, Optional

from ..parallel.lockstep import serves_in_lockstep
from .detok import TokenStreamDecoder, trim_garbage
from .generate import generate, init_engine_and_tokenizer
from .trie import optional_last_token_ids

logger = logging.getLogger(__name__)


def get_data_package(request_dict: dict, default_random_seed: int) -> dict:
    """Per-prompt parameter gathering with the reference defaults."""
    prompt_dicts = request_dict["prompts"]

    def gather(key, default=None):
        if default is None and all(key not in p for p in prompt_dicts):
            return None
        if default is None and any(key not in p for p in prompt_dicts):
            raise RuntimeError(
                f"request field '{key}' has no default and some prompts omit it"
            )
        return [p.get(key, default) for p in prompt_dicts]

    texts = []
    for p in prompt_dicts:
        if not isinstance(p["prompt"], str):
            raise TypeError("prompt must be a string")
        texts.append(p["prompt"])

    return {
        "texts": texts,
        "output_len": request_dict["out_seq_length"],
        "beam_width": request_dict.get("beam_width", 1),
        "stop_words_list": gather("stop_words"),
        "bad_words_list": gather("bad_words"),
        "last_token_list": gather("last_token"),
        "top_k": gather("top_k", 50),
        "top_p": gather("top_p", 0.0),
        "beam_search_diversity_rate": gather("beam_search_diversity_rate", 0.0),
        "temperature": gather("temperature", 1.0),
        "len_penalty": gather("len_penalty", 0.0),
        "repetition_penalty": gather("repetition_penalty", 1.0),
        "presence_penalty": gather("presence_penalty", 0.0),
        "min_length": gather("min_length", 0),
        "random_seed": gather("random_seed", default_random_seed),
        "output_log_probs": bool(request_dict.get("output_log_probs", False)),
        # request-level admission priority for the pooled path (lower admits
        # first; the static path has no queue)
        "priority": int(request_dict.get("priority", 0)),
    }


class CodeFuseHandler:
    """predict(request_dict, trace_id) -> (resultCode, errorMessage, resultMap)."""

    def __init__(
        self,
        ckpt_path: str = None,
        tokenizer_path: str = None,
        int8_mode: int = 0,
        tensor_parallel: int = 1,
        dtype: str = "bf16",
        end_id: Optional[int] = None,
        on_stream_text: Optional[Callable[[int, int, str], None]] = None,
        engine=None,
        tokenizer=None,
        trie=None,
        warmup: bool = True,
        weight_bits: int = 8,
        group_size: int = 0,
        kv_cache_dtype: Optional[str] = None,
        quantize_embeddings: Optional[bool] = None,
        pool: Optional[dict] = None,
        device=None,
    ):
        """Pass ckpt/tokenizer paths (with the loading knobs of
        ``api.generate.init_engine_and_tokenizer``; the model is built on
        ``device``, the card when None) or a prebuilt engine/tokenizer/trie.
        ``on_stream_text(batch_idx, beam_idx, text)`` taps streamed chunks;
        by default batch 0 prints to stdout.

        ``pool``: kwargs of ``engine.server.BatchingServer`` (e.g.
        ``dict(max_slots=8, max_seq_len=2048, paged=dict(num_pages=65,
        page_size=256))``, or ``dict(speculative=True, spec_k=8, ...)`` for a
        speculative pool), or a list of them for length-classed pools
        (``MultiPoolServer``)."""
        if engine is None:
            engine, tokenizer, trie = init_engine_and_tokenizer(
                ckpt_path, tokenizer_path, tensor_parallel=tensor_parallel,
                int8_mode=int8_mode, dtype=dtype, trie_needed=True, end_id=end_id,
                weight_bits=weight_bits, group_size=group_size,
                kv_cache_dtype=kv_cache_dtype, quantize_embeddings=quantize_embeddings,
                device=device,
            )
        self.engine = engine
        self.tokenizer = tokenizer
        self.trie = trie
        self.on_stream_text = on_stream_text
        self.server = None
        from ..engine.server import BatchingServer, LockstepPools, MultiPoolServer

        over = serves_in_lockstep(getattr(engine, "mesh", None), dp=True)
        if pool is not None:
            def with_defaults(kw):
                kw = dict(kw)
                # the response always carries cum_log_prob: the pool tracks
                # per-token log-probs
                kw.setdefault("return_log_probs", True)
                # serving default: read a tick's results after the next
                # tick is dispatched (streaming lags one tick)
                kw.setdefault("pipeline_ticks", True)
                # trie extension lists can span hundreds of vocab entries
                kw.setdefault("optional_last_width", 512)
                kw.setdefault("stop_words_width", 64)
                kw.setdefault("bad_words_width", 64)
                return kw

            if isinstance(pool, (list, tuple)):
                self.server = MultiPoolServer(engine, [with_defaults(kw) for kw in pool],
                                              lockstep_dp=True)
            else:
                self.server = BatchingServer(engine, lockstep_dp=True, **with_defaults(pool))
        # the static route's driver: under a mesh the pools' one driver, so
        # that one thread a rank issues every collective; at one rank its
        # own, beside the pools'
        self.lockstep = (self.server.lockstep if over and self.server is not None else
                         LockstepPools([], over, "ftcf-static-driver"))
        self.lockstep.jobs.update(generate=self._job_generate, speculative=self._job_speculative)
        if warmup and self.lockstep.leader:
            # a follower runs rank 0's warmup once it follows
            self._static("generate", dict(texts=["demo"], output_len=2, beam_width=1))
            if self.server is not None:
                # warm every pool class: routing by length would only reach
                # the smallest with a short request
                for srv in getattr(self.server, "servers", [self.server]):
                    srv.generate(self.tokenizer.encode("demo"), 2)

    def close(self):
        """Stop the driver threads (under a mesh, on rank 0: every rank's
        ``follow`` then returns)."""
        if self.server is not None:
            self.server.close()
        self.lockstep.close()

    def follow(self):
        """Under a mesh, every rank but 0: serve rank 0's requests with it
        until rank 0 closes."""
        self.lockstep.follow()

    def _static(self, key: str, payload, local=None):
        """A static-route job on its driver (under a mesh on every rank
        between the rounds); rank 0's result."""
        return self.lockstep.run(key, payload, local)

    def _job_generate(self, dp: dict, callback=None) -> dict:
        """``generate`` of one resolved request, and its response. A
        follower streams nowhere, but runs a streamed request as rank 0
        does."""
        dp = dict(dp)
        if dp.pop("stream", False) and callback is None:
            def callback(_message):
                pass
        res = generate(self.engine, self.tokenizer, trie=self.trie, callback=callback, **dp)
        response = {
            "latency": res[3],
            "random_seed": dp.get("random_seed"),
            "generated_code": res[0],
            "length": res[1],
            "cum_log_prob": res[2],
        }
        if dp.get("output_log_probs"):
            response["output_log_probs"] = res[4]
        return response

    def _default_stream_sink(self, batch_idx: int, beam_idx: int, text: str):
        if batch_idx == 0 and beam_idx == 0:
            print(text, end="", flush=True)

    # ------------------------------------------------------------- pooled ----
    @staticmethod
    def _plain_greedy(dp: dict, prompts: List[List[int]]) -> bool:
        """Non-empty prompts decoded greedily with nothing that changes a
        token or its log-prob: top_k 1, no beams, default temperature,
        penalties, min length and top_p, no word lists or trie constraint."""
        n = len(prompts)
        if not prompts or any(len(ids) == 0 for ids in prompts):
            return False
        if dp["beam_width"] != 1 or any(v != 1 for v in (dp["top_k"] or [50] * n)):
            return False
        for key, default in (("temperature", 1.0), ("repetition_penalty", 1.0),
                             ("presence_penalty", 0.0), ("min_length", 0), ("top_p", 0.0)):
            v = dp.get(key)
            if v is not None and any(x != default for x in v):
                return False
        for key in ("stop_words_list", "bad_words_list", "last_token_list"):
            v = dp.get(key)
            if v is not None and any(v):
                return False
        return True

    def _spec_pool_routable(self, dp: dict, prompts: List[List[int]]) -> bool:
        """Whether a speculative-flagged request can ride a speculative pool
        class: plain greedy, each prompt fitting a speculative class within
        its draft margin."""
        return self._plain_greedy(dp, prompts) and all(
            self.server.routable_pool(len(ids) + dp["output_len"], 1, speculative=True)
            is not None
            for ids in prompts
        )

    def _spec_eligible(self, dp: dict, prompts: List[List[int]], use_callback: bool) -> bool:
        """The static speculative loop serves plain greedy requests that are
        not streamed and want no per-step log-probs (any number of prompts:
        several share the batched loop). Unlike the JAX handler's check, the
        penalties, min length, temperature and top_p must be the defaults:
        the loop applies none of them, so a request that sets one takes the
        ordinary routes, which do."""
        if use_callback or dp["output_log_probs"]:
            return False
        return self._plain_greedy(dp, prompts)

    def _job_speculative(self, job: dict, _local=None) -> dict:
        """The static speculative loop (``speculative_generate``, or its
        batched form for several prompts) over ``job``'s prompts; the
        response adds the loop's iterations, its mean tokens a step and the
        drafts accepted."""
        from ..engine.speculative import speculative_generate, speculative_generate_batched

        start = time.time()
        prompts, out_len = job["prompts"], job["output_len"]
        if len(prompts) == 1:
            toks, stats = speculative_generate(self.engine, prompts[0], out_len)
            all_toks, all_stats = [toks], [stats]
        else:
            all_toks, all_stats = speculative_generate_batched(self.engine, prompts, out_len)
        end_id = self.engine.config.end_id
        codes, lengths = [], []
        for prompt, toks in zip(prompts, all_toks):
            gen = []
            for t in toks[len(prompt):]:
                if t == end_id:
                    break
                gen.append(int(t))
            codes.append([trim_garbage(self.tokenizer.decode(gen))])
            lengths.append([len(gen)])
        return {
            "latency": time.time() - start,
            "random_seed": job["random_seed"],
            "generated_code": codes,
            "length": lengths,
            "cum_log_prob": [[s.cum_log_prob] for s in all_stats],
            "speculative": {
                "iterations": all_stats[0].iterations,
                "tokens_per_step": sum(s.tokens_per_step for s in all_stats) / len(all_stats),
                "accepted": sum(s.accepted for s in all_stats),
            },
        }

    def _pool_routable(self, dp: dict, prompts: List[List[int]], stream: bool = False) -> bool:
        """Whether every prompt of this request can ride the slot pool: a
        request of non-empty prompts, each fitting the pool class of its beam
        width it routes to, with (sampling) top_k within that class's cap and
        word lists and trie expansions within its buffers. Streamed beams and
        beams with per-step log-probs take the static path."""
        bw = dp["beam_width"]
        if bw != 1 and (stream or dp["output_log_probs"]):
            return False

        def wl_len(lists, i):
            if lists is None or not lists[i]:
                return 0
            return sum(len(self.tokenizer.encode(w)) for w in lists[i])

        for b, ids in enumerate(prompts):
            if len(ids) == 0:
                return False
            pool = self.server.routable_pool(len(ids) + dp["output_len"], bw)
            if pool is None:
                return False
            if bw == 1 and not 1 <= (dp["top_k"] or [50])[b] <= pool.sampling_cap:
                return False  # top_k 0 (pure top-p) needs the full sort
            if wl_len(dp.get("stop_words_list"), b) > pool.stop_words_width:
                return False
            if wl_len(dp.get("bad_words_list"), b) > pool.bad_words_width:
                return False
            lt = dp.get("last_token_list")
            if lt is not None and lt[b] and self.trie is not None:
                olt = optional_last_token_ids(self.trie, lt[b], self.engine.config.end_id)
                if len(olt) > pool.optional_last_width:
                    return False
        return True

    def _predict_pooled(self, dp: dict, use_callback: bool, prompts: List[List[int]],
                        speculative: bool = False):
        """Route one request's prompts through the pool (``speculative``: its
        speculative classes); same sampling semantics and processor order as
        the static path, same response schema."""
        tok = self.tokenizer
        end_id = self.engine.config.end_id
        sink = self.on_stream_text or self._default_stream_sink

        def pick(key, default, b):
            v = dp.get(key)
            return default if v is None else v[b]

        def word_ids(lists, b):
            if lists is None or not lists[b]:
                return None
            return [list(tok.encode(w)) for w in lists[b]]

        bw = dp["beam_width"]
        start = time.time()
        uids = []
        for b, ids in enumerate(prompts):
            olt = None
            lt = dp.get("last_token_list")
            if lt is not None and lt[b]:
                if self.trie is None:
                    raise ValueError("trie is None, can't select last token")
                olt = optional_last_token_ids(self.trie, lt[b], end_id)
            kw = dict(
                temperature=float(pick("temperature", 1.0, b)),
                repetition_penalty=float(pick("repetition_penalty", 1.0, b)),
                min_length=int(pick("min_length", 0, b)),
                priority=dp.get("priority", 0),
                stop_words=word_ids(dp.get("stop_words_list"), b),
                bad_words=word_ids(dp.get("bad_words_list"), b),
                optional_last_tokens=olt,
            )
            if bw == 1:
                kw.update(
                    top_k=int(pick("top_k", 50, b)),
                    top_p=float(pick("top_p", 0.0, b)),
                    presence_penalty=float(pick("presence_penalty", 0.0, b)),
                    random_seed=int(pick("random_seed", 0, b)),
                    on_text=(lambda s, b=b: sink(b, 0, s)) if use_callback else None,
                    tokenizer=tok if use_callback else None,
                )
            else:
                # a beam pool class of this width; beams ignore top_k, top_p,
                # the presence penalty and the seed
                kw.update(
                    beam_width=bw,
                    beam_search_diversity_rate=float(pick("beam_search_diversity_rate", 0.0, b)),
                    len_penalty=float(pick("len_penalty", 0.0, b)),
                )
            uids.append(self.server.submit(ids, dp["output_len"], speculative=speculative, **kw))
        results = [self.server.wait(u) for u in uids]
        latency = time.time() - start

        def decode_gen(ids, in_len):
            gen = []
            for t in ids[in_len:]:
                if t == end_id:
                    break
                gen.append(int(t))
            return gen

        generated_code, lengths, cum_lps, step_lps = [], [], [], []
        for b, r in enumerate(results):
            if bw != 1:
                gens = [decode_gen(ids, len(prompts[b])) for ids in r.beam_output_ids]
                generated_code.append([trim_garbage(tok.decode(g)) for g in gens])
                lengths.append([len(g) for g in gens])
                cum_lps.append(list(r.beam_cum_log_probs))
                continue
            gen = decode_gen(r.output_ids, len(prompts[b]))
            generated_code.append([trim_garbage(tok.decode(gen))])
            lengths.append([len(gen)])
            cum_lps.append([r.cum_log_prob])
            lp = list(r.step_log_probs or [])
            step_lps.append([lp + [0.0] * (dp["output_len"] - len(lp))])
        response = {
            "latency": latency,
            "random_seed": dp["random_seed"],
            "generated_code": generated_code,
            "length": lengths,
            "cum_log_prob": cum_lps,
        }
        if dp["output_log_probs"]:
            response["output_log_probs"] = step_lps
        return response

    def predict(self, request_dict: dict, trace_id: str):
        logger.info("%s request: %s", trace_id, json.dumps(request_dict, ensure_ascii=False))
        try:
            default_random_seed = random.randint(0, 1048576)
            use_callback = bool(request_dict.get("stream"))
            data_package = get_data_package(request_dict, default_random_seed)
            batch_size = len(data_package["texts"])
            beam_width = data_package["beam_width"]

            speculative = bool(request_dict.get("speculative"))
            if speculative or self.server is not None:
                prompts = [list(self.tokenizer.encode(t)) for t in data_package["texts"]]
            if speculative and self.server is not None \
                    and self._spec_pool_routable(data_package, prompts):
                response = self._predict_pooled(data_package, use_callback, prompts,
                                                speculative=True)
                response_str = json.dumps(response, ensure_ascii=False)
                logger.info("%s response (pooled speculative): %s", trace_id, response_str)
                return (0, "ok", {"res": response_str})
            if speculative and self._spec_eligible(data_package, prompts, use_callback):
                response = self._static("speculative", dict(
                    prompts=prompts, output_len=data_package["output_len"],
                    random_seed=data_package["random_seed"]))
                response_str = json.dumps(response, ensure_ascii=False)
                logger.info("%s response (speculative): %s", trace_id, response_str)
                return (0, "ok", {"res": response_str})

            if self.server is not None:
                if self._pool_routable(data_package, prompts, stream=use_callback):
                    response = self._predict_pooled(data_package, use_callback, prompts)
                    response_str = json.dumps(response, ensure_ascii=False)
                    logger.info("%s response (pooled): %s", trace_id, response_str)
                    return (0, "ok", {"res": response_str})
                logger.info("%s not pool-routable; using the static path", trace_id)
            data_package.pop("priority")  # pooled-path-only knob

            callback = None
            decoders: List[List[TokenStreamDecoder]] = []
            if use_callback:
                sink = self.on_stream_text or self._default_stream_sink
                decoders = [
                    [
                        TokenStreamDecoder(
                            self.engine.config.end_id,
                            self.tokenizer,
                            on_text=(lambda s, b=b, j=j: sink(b, j, s)),
                        )
                        for j in range(beam_width)
                    ]
                    for b in range(batch_size)
                ]

                def callback(message_dict: dict):
                    try:
                        last_tokens = message_dict["last_tokens"]
                        for b in range(batch_size):
                            for j in range(beam_width):
                                decoders[b][j].append_token(last_tokens[b][j])
                    except Exception as err:  # noqa: BLE001 -- streaming must not kill the request
                        logger.error("callback error: %s", err)

            response = self._static("generate", dict(data_package, stream=use_callback),
                                    callback)

            if use_callback:
                for b in range(batch_size):
                    for j in range(beam_width):
                        decoders[b][j].append_token(self.engine.config.end_id)

            response_str = json.dumps(response, ensure_ascii=False)
            logger.info("%s response: %s", trace_id, response_str)
            return (0, "ok", {"res": response_str})
        except Exception:  # noqa: BLE001 -- the handler contract reports every failure
            return (1, traceback.format_exc(), {"res": ""})
