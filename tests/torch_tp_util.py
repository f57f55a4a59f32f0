"""Runs tensor-, pipeline- and data-parallel cases of the port in a group of
gloo ranks.

A test module builds its inputs (configs, weights as numpy, prompts) in its
own process, where the JAX package gives the references, and calls
``run_group(world, cases, data)`` once: it starts ``world`` processes of this
file (each imports torch and the port, never jax, and loads no conftest),
which join one gloo group over localhost, run every case in order and write
their results; the call returns ``{case name: [result of rank 0, rank 1,
...]}``. A case that raises on a rank gives ``{"error": traceback}`` there.
Cases are functions of this module named in ``CASES``.
"""
from __future__ import annotations

import dataclasses
import gc
import os
import pickle
import socket
import subprocess
import sys
import tempfile
import traceback

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPTS = [[3, 4, 5, 17], [9, 8, 7, 6, 5, 4]]
POOL_PROMPTS = [[3, 4, 5], [9, 8, 7, 6, 5], [11, 12], [20, 21, 22, 23], [30, 31, 32]]
POOL_OUT_LENS = [5, 4, 6, 3, 5]


class NpQuant:
    """A quantized weight as numpy (the attributes ``from_jax_params`` reads)."""

    def __init__(self, q, scale, k_axis, bits, group_size):
        self.q, self.scale = q, scale
        self.k_axis, self.bits, self.group_size = k_axis, bits, group_size


def np_tree(tree):
    """A parameter tree (JAX or port) as numpy arrays and ``NpQuant``s."""
    if isinstance(tree, dict):
        return {k: np_tree(v) for k, v in tree.items()}
    if all(hasattr(tree, a) for a in ("q", "scale", "k_axis", "bits", "group_size")):
        return NpQuant(np_tree(tree.q), np_tree(tree.scale), int(tree.k_axis), int(tree.bits),
                       int(tree.group_size))
    if hasattr(tree, "detach"):  # a torch tensor
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_group(world: int, cases, data, timeout: float = 600.0) -> dict:
    """Run ``cases`` ([(name, case function name, kwargs)]) on ``world``
    gloo ranks; returns {name: [each rank's result]}."""
    with tempfile.TemporaryDirectory() as d:
        with open(os.path.join(d, "in.pkl"), "wb") as f:
            pickle.dump((cases, data), f)
        port = str(_free_port())
        env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
        env.pop("PYTHONPATH", None)
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), d, str(r),
                                   str(world), port], env=env, cwd=REPO,
                                  stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
                 for r in range(world)]
        errs = []
        for p in procs:
            try:
                _, err = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                raise
            errs.append(err.decode(errors="replace")[-4000:])
        if any(p.returncode for p in procs):
            raise RuntimeError("a rank failed:\n" + "\n".join(
                f"rank {r} (rc {p.returncode}): {e}" for r, (p, e) in enumerate(zip(procs, errs))))
        outs = []
        for r in range(world):
            with open(os.path.join(d, f"rank{r}.pkl"), "rb") as f:
                outs.append(pickle.load(f))
    return {name: [o[name] for o in outs] for name, _, _ in cases}


# ------------------------------------------------------------- the ranks --

_MESHES = {}


def _mesh(tp, dp=1, pp=1):
    from fastertransformer4codefuse_tpu_torch.parallel.sharding import build_mesh

    if (tp, dp, pp) not in _MESHES:
        _MESHES[tp, dp, pp] = build_mesh(tp=tp, dp=dp, pp=pp)
    return _MESHES[tp, dp, pp]


def _counters():
    from fastertransformer4codefuse_tpu_torch.parallel import distributed

    return distributed.all_reduce, distributed.all_gather


def _hop_counters():
    """The pipeline's counted calls: sends, receives, broadcasts."""
    from fastertransformer4codefuse_tpu_torch.parallel import distributed

    return distributed.send_next, distributed.recv_prev, distributed.broadcast_last


def _zero_all():
    for f in (*_counters(), *_hop_counters()):
        f.calls = 0


def _read_all():
    """(sends, receives, broadcasts, all-reduces, all-gathers) so far."""
    return tuple(f.calls for f in (*_hop_counters(), *_counters()))


def _params(tree):
    from fastertransformer4codefuse_tpu_torch.models.params import from_jax_params

    return from_jax_params(tree, device="cpu")


def _runtime(**kw):
    from fastertransformer4codefuse_tpu_torch import RuntimeConfig

    return RuntimeConfig(dtype="fp32", **kw)


def _gen(out):
    return {"ids": out.output_ids, "lens": out.sequence_lengths, "cum": out.cum_log_probs}


def engine_case(data, model, tp, dp=1, runtime=None, gen=None, prompts=PROMPTS, out_len=6,
                first_logits=False, pp=1):
    """``generate`` on an engine of this mesh and on a tp = 1 engine over
    the same weights; the collectives (and, under pp, the hops and
    broadcasts) counted over the mesh's call."""
    from fastertransformer4codefuse_tpu_torch import GptNeoXEngine

    cfg, tree = data[model]
    params = _params(tree)
    rt = _runtime(seq_bucket=4, **(runtime or {}))
    gen = gen or {}
    ref = GptNeoXEngine(cfg, params, dataclasses.replace(rt, pp_microbatches=1)).generate(
        prompts, out_len, **gen)
    eng = GptNeoXEngine(cfg, params, rt, mesh=_mesh(tp, dp, pp))
    _zero_all()
    out = eng.generate(prompts, out_len, **gen)
    ar, ag = _counters()
    res = {"tp": _gen(out), "tp1": _gen(ref), "all_reduce": ar.calls, "all_gather": ag.calls,
           "forwards": eng.decode_forwards, "head_rows": eng.params["lm_head"].shape[0],
           "hops": _read_all()[:3], "layers": int(eng.params["layers"]["ln1_w"].shape[0])}
    if first_logits:  # the prefill's logits of the whole batch, under the mesh
        st, inputs = eng._prepare(prompts, out_len, **gen)
        res["logits"] = eng._prefill_state(st, inputs).logits.numpy()
    return res


def step_counts_case(data, model, tp):
    """The counted collectives of one prefill and of one decode step through
    the model functions."""
    import torch

    from fastertransformer4codefuse_tpu_torch.engine import kv_cache
    from fastertransformer4codefuse_tpu_torch.models import gptneox as model_fns
    from fastertransformer4codefuse_tpu_torch.parallel.sharding import cache_heads, shard_params

    cfg, tree = data[model]
    mesh = _mesh(tp)
    params = shard_params(cfg, _params(tree), mesh)
    B, T = 2, 16
    cache = kv_cache.init_cache(cfg, B, T, torch.float32, "cpu",
                                kv_heads=cache_heads(cfg, mesh)[1])
    ar, ag = _counters()
    ids = torch.tensor([[3, 4, 5], [6, 7, 8]], dtype=torch.int32)
    ar.calls = ag.calls = 0
    hidden, cache = model_fns.prefill(cfg, params, ids, torch.tensor([3, 3], dtype=torch.int32),
                                      cache, mesh=mesh)
    model_fns.lm_logits(cfg, params, hidden[:, -1], mesh)
    prefill = (ar.calls, ag.calls)
    ar.calls = ag.calls = 0
    hidden, cache = model_fns.decode_step(cfg, params, torch.zeros(B, dtype=torch.int32),
                                          torch.full((B,), 3, dtype=torch.int32), cache,
                                          mesh=mesh)
    logits = model_fns.lm_logits(cfg, params, hidden, mesh)
    return {"prefill": prefill, "decode": (ar.calls, ag.calls), "logits": logits.numpy()}


def pool_case(data, model, tp, kind="dense", pool=None, sampling=None, runtime=None,
              compare_tp1=False, pp=1):
    """The pool of ``kind`` ("dense", "paged", "spec", "beam") on an engine
    of this mesh, every request submitted and run to the end; with
    ``compare_tp1`` also the same pool on a tp = 1 engine. Returns the
    outputs, the slabs' kv-head count and the collectives of each tick."""
    from fastertransformer4codefuse_tpu_torch import GptNeoXEngine
    from fastertransformer4codefuse_tpu_torch.engine.batcher import ContinuousBatcher
    from fastertransformer4codefuse_tpu_torch.engine.beam_pool import BeamPool
    from fastertransformer4codefuse_tpu_torch.engine.spec_pool import SpecPool

    cfg, tree = data[model]
    params = _params(tree)
    rt = _runtime(seq_bucket=8, **(runtime or {}))
    kw = {**dict(max_slots=2, max_seq_len=32, prompt_bucket=8), **(pool or {})}

    def build(eng):
        if kind == "spec":
            return SpecPool(eng, k=4, ngram=2, **kw)
        if kind == "beam":
            return BeamPool(eng, beam_width=2, **kw)
        return ContinuousBatcher(eng, **kw)

    def run(eng, counted=False):
        cb = build(eng)
        ar, ag = _counters()
        uids = []
        for i, (p, ol) in enumerate(zip(POOL_PROMPTS, POOL_OUT_LENS)):
            kw_i = {} if kind == "beam" else dict(top_k=1)
            uids.append(cb.submit(p, ol, **(kw_i if sampling is None else sampling[i])))
        ticks = []  # (chunk steps, decode steps, all-reduces, all-gathers) of each tick
        hops = []  # (sends, receives, broadcasts) of each tick
        while cb.pending or cb.running:
            _zero_all()
            c0, d0 = cb.chunk_ticks, cb.decode_ticks
            cb.step()
            ticks.append((cb.chunk_ticks - c0, cb.decode_ticks - d0, ar.calls, ag.calls))
            hops.append(_read_all()[:3])
            assert len(ticks) < 300, "the pool did not drain"
        done = cb.requests
        slab = cb._state["cache"]["pk" if "pk" in cb._state["cache"] else "k"]
        return {"outs": [done[u].output_ids for u in uids],
                "beams": [done[u].beam_output_ids for u in uids],
                "kv_heads": int(slab.shape[2]), "layers": int(slab.shape[0]),
                "ticks": ticks if counted else None, "hops": hops if counted else None}

    res = {"tp": run(GptNeoXEngine(cfg, params, rt, mesh=_mesh(tp, pp=pp)), counted=True)}
    eng1 = GptNeoXEngine(cfg, params, rt)
    if compare_tp1:
        res["tp1"] = run(eng1)
    if kind == "beam":  # each request's static beams, best first, on the tp = 1 engine
        res["static"] = []
        for p, ol in zip(POOL_PROMPTS, POOL_OUT_LENS):
            o = eng1.generate([p], output_len=ol, beam_width=2)
            res["static"].append([[int(x) for x in o.output_ids[0, j, : o.sequence_lengths[0, j]]]
                                  for j in range(2)])
    return res


def pp_counts_case(data, model, tp, pp, microbatches):
    """The counted calls of one prefill and of one decode step of the model
    on a pp mesh at ``microbatches`` (each followed by the head),
    and the logits of both: (sends, receives, broadcasts, all-reduces,
    all-gathers) a forward."""
    import torch

    from fastertransformer4codefuse_tpu_torch.engine import kv_cache
    from fastertransformer4codefuse_tpu_torch.models import gptneox as model_fns
    from fastertransformer4codefuse_tpu_torch.parallel.sharding import (
        cache_heads, shard_params, stage_layers,
    )

    cfg, tree = data[model]
    mesh = _mesh(tp, pp=pp)
    params = shard_params(cfg, _params(tree), mesh)
    B, T, M = 2, 16, microbatches
    cache = kv_cache.init_cache(cfg, B, T, torch.float32, "cpu",
                                kv_heads=cache_heads(cfg, mesh)[1],
                                layers=stage_layers(cfg, mesh)[1])
    ids = torch.tensor([[3, 4, 5, 9], [6, 7, 8, 2]], dtype=torch.int32)
    _zero_all()
    hidden, cache = model_fns.prefill(cfg, params, ids, torch.tensor([4, 3], dtype=torch.int32),
                                      cache, mesh=mesh, microbatches=M)
    lp = model_fns.lm_logits(cfg, params, hidden[:, 2], mesh)
    prefill = _read_all()
    _zero_all()
    hidden, cache = model_fns.decode_step(cfg, params, torch.tensor([1, 2], dtype=torch.int32),
                                          torch.tensor([4, 3], dtype=torch.int32), cache,
                                          mesh=mesh, microbatches=M)
    ld = model_fns.lm_logits(cfg, params, hidden, mesh)
    return {"prefill": prefill, "decode": _read_all(), "logits": (lp.numpy(), ld.numpy())}


def prompt_case(data, model, pp, kind, prompt, tail, out_len=5):
    """Prefix (``kind`` "prefix": the table in ``data``) or soft prompts on
    an engine of a pp mesh and on a pp = 1 engine, greedy."""
    from fastertransformer4codefuse_tpu_torch import GptNeoXEngine

    cfg, tree = data[model]
    params = _params(tree)
    table, emb = data[model + "_prompts"]
    rt = _runtime(seq_bucket=8)
    if kind == "prefix":
        kw = dict(prompt_learning_task_name_ids=[1])
    else:
        kw = dict(request_prompt_embedding=emb, request_prompt_lengths=[len(prompt)])
    outs = {}
    for name, eng in (("pp", GptNeoXEngine(cfg, params, rt, mesh=_mesh(1, pp=pp))),
                      ("pp1", GptNeoXEngine(cfg, params, rt))):
        if kind == "prefix":
            eng.set_prompt_learning_table({1: (table, len(prompt))})
        _zero_all()
        outs[name] = _gen(eng.generate([tail], out_len, top_k=1, return_cum_log_probs=True, **kw))
        outs[name + "_hops"] = _read_all()[:3]
        outs[name + "_forwards"] = eng.decode_forwards
    return outs


def bert_case(data, model, tp):
    """BERT's encode on an engine of this mesh, its all-reduces counted."""
    from fastertransformer4codefuse_tpu_torch.models import registry
    from fastertransformer4codefuse_tpu_torch.models.bert import (
        params_from_hf_bert_state_dict, quantize_bert_params,
    )

    cfg, sd, ids, lens, int8 = data[model]
    params = params_from_hf_bert_state_dict(cfg, sd, device="cpu")
    if int8:
        params = quantize_bert_params(params)
    eng = registry.get("bert").make_engine(cfg, params, mesh=_mesh(tp))
    ar, _ = _counters()
    ar.calls = 0
    h, p = eng.encode(ids, lens)
    return {"hidden": h.numpy(), "pooled": None if p is None else p.numpy(),
            "all_reduce": ar.calls, "qkv_cols": int(eng.params["layers"]["qkv_w"].shape[-1])}


def t5_case(data, model, tp, beam_width=1, out_len=8):
    """T5's generate on an engine of this mesh and on a tp = 1 engine."""
    from fastertransformer4codefuse_tpu_torch.engine.t5_engine import T5Engine
    from fastertransformer4codefuse_tpu_torch.models.t5 import (
        params_from_hf_t5_state_dict, quantize_t5_params,
    )

    cfg, sd, ids, int8 = data[model]
    params = params_from_hf_t5_state_dict(cfg, sd, device="cpu")
    if int8:
        params = quantize_t5_params(params)
    rows = [list(r) for r in ids]
    eng = T5Engine(cfg, params, mesh=_mesh(tp))
    ar, _ = _counters()
    ar.calls = 0
    out = eng.generate(rows, out_len, beam_width=beam_width)
    ref = T5Engine(cfg, params).generate(rows, out_len, beam_width=beam_width)
    q = eng.params["enc"]["q_w"]
    return {"ids": out.output_ids, "ref": ref.output_ids, "all_reduce": ar.calls,
            "forwards": eng.decode_forwards,
            "q_cols": int((q.q if hasattr(q, "q") else q).shape[-1])}


def pod_mesh_case(data):
    """This rank's coordinates in ``build_pod_mesh``'s meshes: tp over the
    whole group by default, and tp = 2 with dp the rest."""
    from fastertransformer4codefuse_tpu_torch.parallel.distributed import build_pod_mesh

    out = {}
    for name, kw in (("default", {}), ("tp2", dict(tp=2))):
        m = build_pod_mesh(**kw)
        out[name] = (m.tp, m.dp, m.tp_rank, m.dp_rank)
    return out


class VocabTokenizer:
    """A tokenizer over a fixed vocab of single characters and a few longer
    entries (the tests' char-level tokenizer, rebuilt from its vocab)."""

    def __init__(self, vocab):
        self.vocab = dict(vocab)
        self.inv = {v: k for k, v in self.vocab.items()}

    def encode(self, text):
        return [self.vocab[c] for c in text if c in self.vocab]

    def decode(self, ids):
        return "".join(self.inv.get(int(i), "") for i in ids if int(i) > 1)

    def get_vocab(self):
        return dict(self.vocab)


def cli_case(data, model, tp, argv, stdin=None):
    """``api.cli.main(argv + ["--tensor_parallel", tp])`` as a torchrun rank
    runs it (RANK set), the tokenizer patched in and ``stdin`` (text) the
    standard input; returns what the rank printed."""
    import contextlib
    import io

    import torch.distributed as dist

    from fastertransformer4codefuse_tpu_torch.api import cli, generate

    ckpt, vocab = data[model]
    os.environ["RANK"] = str(dist.get_rank())
    tok = VocabTokenizer(vocab)
    real, real_stdin = generate.load_tokenizer, sys.stdin
    generate.load_tokenizer = lambda path: tok
    if stdin is not None:
        sys.stdin = io.StringIO(stdin)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            cli.main(["--ckpt_path", ckpt, *argv, "--tensor_parallel", str(tp)])
    finally:
        generate.load_tokenizer, sys.stdin = real, real_stdin
    return {"stdout": buf.getvalue()}


def _leads(front) -> bool:
    """Whether this rank takes the clients of a serving front end: rank 0
    of a front end that serves over the process group (the others follow
    it), every rank of one that does not."""
    ls = getattr(front, "lockstep", None)
    return ls is None or ls.leader


def _served(front):
    """Turn on the lockstep front end's record of what this rank served."""
    ls = getattr(front, "lockstep", None)
    if ls is not None:
        ls.served = []
    return ls


def _no_latency(record):
    """A served record or response without its latency (each rank times
    its own)."""
    if isinstance(record, dict):
        record = {k: v for k, v in record.items() if k != "latency"}
    return record


def _clients(calls, stagger=0.02):
    """Run each of ``calls`` on its own thread, the i-th starting i *
    ``stagger`` s after the first; their results (or their errors, as
    ``{"error": traceback}``) in order."""
    import threading
    import time

    out = [None] * len(calls)

    def run(i):
        time.sleep(i * stagger)
        try:
            out[i] = calls[i]()
        except Exception:  # noqa: BLE001 - reported to the test
            out[i] = {"error": traceback.format_exc()}

    ts = [threading.Thread(target=run, args=(i,)) for i in range(len(calls))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=300)
    return out


def _front_counts(ls, since):
    """What a lockstep front end counted on this rank: rounds, publishes
    since ``since``, and the served records sorted by uid."""
    from fastertransformer4codefuse_tpu_torch.parallel import lockstep

    return {"rounds": ls.rounds.rounds, "publishes": lockstep.publish.calls - since,
            "served": sorted(((u, _no_latency(r)) for u, r in ls.served), key=lambda x: x[0])}


def serve_case(data, model, tp, kind="dense", pool=None, sampling=None, runtime=None,
               compare_tp1=False, pp=1, dp=1, classes=None):
    """A ``BatchingServer`` (a ``MultiPoolServer`` over ``classes``) with a
    pool of ``kind`` on an engine of this mesh: rank 0's client threads
    submit POOL_PROMPTS with staggered arrivals, the other ranks follow (on
    a dp-only mesh every rank's clients submit them to its own pool).
    Returns rank 0's outputs, what each rank served and counted (rounds,
    publishes, collectives and hops, each class's chunk and decode ticks),
    and with ``compare_tp1`` the same requests through a tp = 1 pool."""
    import torch.distributed as dist

    from fastertransformer4codefuse_tpu_torch import GptNeoXEngine
    from fastertransformer4codefuse_tpu_torch.engine.batcher import ContinuousBatcher
    from fastertransformer4codefuse_tpu_torch.engine.server import BatchingServer, MultiPoolServer
    from fastertransformer4codefuse_tpu_torch.parallel import lockstep

    cfg, tree = data[model][:2]
    params = _params(tree)
    rt = _runtime(seq_bucket=8, **(runtime or {}))
    kw = {**dict(max_slots=2, max_seq_len=32, prompt_bucket=8), **(pool or {})}
    if kind == "beam":
        kw["beam_width"] = 2
    elif kind == "spec":
        kw.update(speculative=True, spec_k=4, spec_ngram=2)
    eng = GptNeoXEngine(cfg, params, rt, mesh=_mesh(tp, dp, pp))
    srv = MultiPoolServer(eng, classes) if classes else BatchingServer(eng, **kw)
    ls = _served(srv)
    _zero_all()
    since = lockstep.publish.calls

    def request(i):
        kw_i = ({} if kind == "beam" else dict(top_k=1)) if sampling is None else sampling[i]
        r = srv.generate(POOL_PROMPTS[i], POOL_OUT_LENS[i], **kw_i)
        return {"ids": r.output_ids, "beams": r.beam_output_ids, "seed": r.random_seed}

    outs = None
    if _leads(srv):
        outs = _clients([lambda i=i: request(i) for i in range(len(POOL_PROMPTS))])
        srv.close()
    else:
        srv.follow()
    res = {"outs": outs, "coll": _read_all(), "layers": eng.stage[1],
           "ticks": [(b.chunk_ticks, b.decode_ticks) for b in ls.batchers],
           **_front_counts(ls, since)}
    if compare_tp1 and dist.get_rank() == 0:
        cb = ContinuousBatcher(GptNeoXEngine(cfg, params, rt), **kw)
        uids = [cb.submit(p, n, **s) for p, n, s in zip(POOL_PROMPTS, POOL_OUT_LENS, sampling)]
        done = cb.run()
        res["tp1"] = [done[u].output_ids for u in uids]
    return res


def handler_case(data, model, tp, requests, pool=None, warmup=False, dp=1):
    """A ``CodeFuseHandler`` on an engine of a tp x dp mesh (``pool``: its
    pool classes): rank 0's client threads predict ``requests`` with staggered
    arrivals, the other ranks follow where the handler serves in lockstep
    (without it, every rank predicts them itself, as every torchrun rank
    once did). Returns each rank's responses without their latency (on a
    follower the jobs' it served), what it served and counted, and the text
    rank 0 streamed."""
    import json

    from fastertransformer4codefuse_tpu_torch import GptNeoXEngine
    from fastertransformer4codefuse_tpu_torch.api.handler import CodeFuseHandler
    from fastertransformer4codefuse_tpu_torch.api.trie import VocabTrie

    try:
        from fastertransformer4codefuse_tpu_torch.parallel import lockstep
        since = lockstep.publish.calls  # rank 0 publishes its warmup while it builds
    except ImportError:  # a tree that does not serve in lockstep
        since = None
    cfg, tree, vocab = data[model]
    eng = GptNeoXEngine(cfg, _params(tree), _runtime(seq_bucket=8), mesh=_mesh(tp, dp))
    streamed = []
    h = CodeFuseHandler(engine=eng, tokenizer=VocabTokenizer(vocab), trie=VocabTrie(vocab),
                        warmup=warmup, pool=pool,
                        on_stream_text=lambda b, j, text: streamed.append(text))
    ls = _served(h)

    def predict(i):
        code, err, res = h.predict(requests[i], f"r{i}")
        if code:
            raise RuntimeError(err)
        return _no_latency(json.loads(res["res"]))

    out = {"streamed": streamed}
    if _leads(h):
        out["responses"] = _clients([lambda i=i: predict(i) for i in range(len(requests))])
        h.close()
    else:
        h.follow()
        out["responses"] = [_no_latency(r) for _, r in ls.served if isinstance(r, dict)
                            and "generated_code" in r][-len(requests):]
    if ls is not None:
        out.update(_front_counts(ls, since))
    return out


def http_case(data, model, tp, pool):
    """JAX tests/test_api.py::test_http_server_end_to_end on a pooled
    handler of a tp mesh, rank 0 bound to a free localhost port and the
    other ranks following: two concurrent POSTs, a bad request, /healthz.
    Returns (status, body) of each on rank 0."""
    import threading
    import urllib.error
    import urllib.request

    import json

    from fastertransformer4codefuse_tpu_torch import GptNeoXEngine
    from fastertransformer4codefuse_tpu_torch.api.handler import CodeFuseHandler
    from fastertransformer4codefuse_tpu_torch.api.http_server import make_server
    from fastertransformer4codefuse_tpu_torch.api.trie import VocabTrie

    cfg, tree, vocab = data[model]
    eng = GptNeoXEngine(cfg, _params(tree), _runtime(seq_bucket=8), mesh=_mesh(tp))
    h = CodeFuseHandler(engine=eng, tokenizer=VocabTokenizer(vocab), trie=VocabTrie(vocab),
                        warmup=False, pool=pool)
    ls = _served(h)
    if not ls.leader:
        h.follow()
        return {"served": len(ls.served)}
    srv = make_server(h, "127.0.0.1", 0)
    port = srv.server_address[1]
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()

    def post(body):
        req = urllib.request.Request(f"http://127.0.0.1:{port}/predict",
                                     data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
            health = r.status
        posts = _clients([
            lambda: post({"prompts": [{"prompt": "abcdef", "top_k": 1, "min_length": 30}],
                          "out_seq_length": 30}),
            lambda: post({"prompts": [{"prompt": "xy", "top_k": 1, "min_length": 2}],
                          "out_seq_length": 2}),
        ])
        bad = post({"prompts": [{}]})
    finally:
        srv.shutdown()
        srv.server_close()
        h.close()
    return {"health": health, "posts": posts, "bad": bad, "served": len(ls.served)}


def encoder_serve_case(data, model, tp, requests, max_batch=1, out_len=None, hold=False):
    """An ``EncoderBatchingServer`` over BERT (with ``out_len``, a
    ``T5BatchingServer`` over T5) on a tp mesh. Each rank's clients submit
    ``requests`` rotated by its rank, each from its own thread with
    staggered arrivals; where the server serves in lockstep only rank 0's,
    the others following. With ``hold`` rank 0's first batch waits until
    the other requests are queued, so that they coalesce for certain.
    Returns every batch the rank ran and rank 0's results by request."""
    import time

    import torch.distributed as dist

    from fastertransformer4codefuse_tpu_torch.engine.encoder_server import (
        EncoderBatchingServer, T5BatchingServer,
    )

    if out_len is None:
        from fastertransformer4codefuse_tpu_torch.models import registry
        from fastertransformer4codefuse_tpu_torch.models.bert import (
            params_from_hf_bert_state_dict, quantize_bert_params,
        )

        cfg, sd, int8 = data[model]
        params = params_from_hf_bert_state_dict(cfg, sd, device="cpu")
        eng = registry.get("bert").make_engine(
            cfg, quantize_bert_params(params) if int8 else params, mesh=_mesh(tp))
        method = "encode"
    else:
        from fastertransformer4codefuse_tpu_torch.engine.t5_engine import T5Engine
        from fastertransformer4codefuse_tpu_torch.models.t5 import (
            params_from_hf_t5_state_dict, quantize_t5_params,
        )

        cfg, sd, int8 = data[model]
        params = params_from_hf_t5_state_dict(cfg, sd, device="cpu")
        eng = T5Engine(cfg, quantize_t5_params(params) if int8 else params, mesh=_mesh(tp))
        method = "generate"
    batches, real = [], getattr(eng, method)

    def logged(ids, *args, **kw):
        if hold and not batches and dist.get_rank() == 0:
            deadline = time.monotonic() + 60
            while len(srv._mailbox) + len(ids) < len(requests) and time.monotonic() < deadline:
                time.sleep(0.005)
        batches.append([np.asarray(r).tolist() for r in ids])
        return real(ids, *args, **kw)

    setattr(eng, method, logged)
    if out_len is None:
        srv = EncoderBatchingServer(eng, max_batch=max_batch, seq_bucket=8)
        call = lambda ids: srv.encode(ids, timeout=120)[0]  # noqa: E731
    else:
        srv = T5BatchingServer(eng, max_batch=max_batch, seq_bucket=8)
        call = lambda ids: srv.generate(ids, out_len, timeout=120).output_ids  # noqa: E731
    out = None
    if _leads(srv):
        r = dist.get_rank()
        order = [*range(r, len(requests)), *range(r)]
        got = _clients([lambda i=i: call(requests[i]) for i in order])
        out = dict(zip(order, got))
        srv.close()
    else:
        srv.follow()
    return {"batches": batches, "results": out, "batches_run": srv.batches_run,
            "served": srv.requests_served}


def lockstep_faults_case(data, model, tp):
    """The two hazards of lockstep serving on a tp mesh: a server idle for
    1.5 times a 2 s control timeout, then serving a request; and a
    follower that fails to apply a round, whose error reaches rank 0's
    waiter. Returns what each rank saw."""
    import time

    import torch.distributed as dist

    from fastertransformer4codefuse_tpu_torch import GptNeoXEngine
    from fastertransformer4codefuse_tpu_torch.engine.server import BatchingServer
    from fastertransformer4codefuse_tpu_torch.parallel import lockstep

    cfg, tree = data[model][:2]
    eng = GptNeoXEngine(cfg, _params(tree), _runtime(seq_bucket=8), mesh=_mesh(tp))
    pool = dict(max_slots=2, max_seq_len=32, prompt_bucket=8)
    leader = dist.get_rank() == 0
    out = {}
    real_timeout = lockstep.CONTROL_TIMEOUT_S
    lockstep.CONTROL_TIMEOUT_S = 2.0
    try:
        srv = BatchingServer(eng, **pool)
    finally:
        lockstep.CONTROL_TIMEOUT_S = real_timeout
    if leader:
        time.sleep(3.0)
        out["idle_ids"] = srv.generate(POOL_PROMPTS[0], POOL_OUT_LENS[0], top_k=1).output_ids
        srv.close()
    else:
        srv.follow()
    out["idle_rounds"] = srv.lockstep.rounds.rounds

    srv = BatchingServer(eng, **pool)
    if not leader:
        real = srv.batcher.make_request

        def broken(prompt, output_len, uid=None, **kw):
            if uid is not None:  # a request rank 0 published
                raise RuntimeError("injected fault: this follower cannot build the request")
            return real(prompt, output_len, **kw)

        srv.batcher.make_request = broken
    t = time.time()
    try:
        if leader:
            srv.generate(POOL_PROMPTS[1], POOL_OUT_LENS[1], top_k=1)
        else:
            srv.follow()
        out["fault"] = None
    except RuntimeError as e:
        out["fault"] = (str(e), repr(e.__cause__))
    out["fault_s"] = time.time() - t
    srv.close()
    return out


CASES = {f.__name__: f for f in (engine_case, step_counts_case, pool_case, bert_case, t5_case,
                                 cli_case, pod_mesh_case, pp_counts_case, prompt_case,
                                 serve_case, handler_case, http_case, encoder_serve_case,
                                 lockstep_faults_case)}


def main(argv) -> int:
    d, rank, world, port = argv[0], int(argv[1]), int(argv[2]), argv[3]
    sys.path.insert(0, REPO)
    import torch

    from fastertransformer4codefuse_tpu_torch.parallel.distributed import init_distributed

    torch.set_num_threads(1)
    init_distributed(f"127.0.0.1:{port}", world, rank, backend="gloo", timeout_s=120)
    with open(os.path.join(d, "in.pkl"), "rb") as f:
        cases, data = pickle.load(f)
    out = {}
    with torch.inference_mode():
        for name, fn, kw in cases:
            try:
                out[name] = CASES[fn](data, **kw)
            except Exception:  # noqa: BLE001 - reported to the test as the case's result
                out[name] = {"error": traceback.format_exc()}
    with open(os.path.join(d, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    # Tear the groups down together and while the interpreter is whole: no
    # rank shuts its gloo pairs while a peer still talks on them, and every
    # group (the meshes' subgroups, the front ends' control groups, the
    # default group) is shut down and freed here, not in the interpreter's
    # teardown, where a gloo thread still joinable aborted the process
    # ("terminate called without an active exception").
    try:
        torch.distributed.barrier()
    except RuntimeError:  # a group a case broke: shut down all the same
        pass
    torch.distributed.destroy_process_group()
    _MESHES.clear()
    gc.collect()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
