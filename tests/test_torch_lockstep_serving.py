"""Serving the port's sharded engine in lockstep (parallel/lockstep.py and
the front ends that ride it: engine/server.py, engine/encoder_server.py,
api/handler.py, api/cli.py, api/http_server.py) against the JAX package's
served meshes: tests/test_pool_parallel.py's pools (and
tests/test_beam_pool.py's beam pool under tp), tests/test_api.py's pooled
handler and HTTP flow, tests/test_bert.py's and tests/test_t5_engine.py's
tp meshes.

One group of four gloo ranks (``torch_tp_util.run_group``) runs every case.
Rank 0 takes the clients (threads with staggered arrivals); the other ranks
follow its published rounds. A tp = 2 mesh on four ranks is two copies, and
the copies serve the same requests.

Tolerances: greedy tokens equal the JAX references token for token (the
int8-KV paged pool the JAX tp = 2 pool's); sampled tokens equal the port's
own tp = 1 pool's or handler's given the same seed (the JAX package draws
from another generator); every rank's served tokens, seeds, responses
(without their latency) and batches are the same bytes, and its published
rounds and collectives are counted exactly; BERT's hidden states are within
the JAX test's rtol 2e-5 / atol 2e-6.
"""
import io
import json
import sys

import numpy as np
import pytest

import jax.numpy as jnp

from fastertransformer4codefuse_tpu import GptNeoXEngine as JaxEngine
from fastertransformer4codefuse_tpu import RuntimeConfig as JaxRuntime
from fastertransformer4codefuse_tpu import init_params as jax_init_params
from fastertransformer4codefuse_tpu.api.handler import CodeFuseHandler as JaxHandler
from fastertransformer4codefuse_tpu.api.trie import VocabTrie as JaxTrie
from fastertransformer4codefuse_tpu.engine.t5_engine import T5Engine as JaxT5Engine
from fastertransformer4codefuse_tpu.models import bert as jbert
from fastertransformer4codefuse_tpu.models import t5 as jt5
from fastertransformer4codefuse_tpu.parallel.sharding import build_mesh
from fastertransformer4codefuse_tpu_torch import GptNeoXEngine, RuntimeConfig
from fastertransformer4codefuse_tpu_torch.api import cli, generate
from fastertransformer4codefuse_tpu_torch.api.handler import CodeFuseHandler
from fastertransformer4codefuse_tpu_torch.engine.batcher import ContinuousBatcher
from fastertransformer4codefuse_tpu_torch.engine.encoder_server import EncoderBatchingServer
from fastertransformer4codefuse_tpu_torch.engine.server import BatchingServer, MultiPoolServer
from fastertransformer4codefuse_tpu_torch.models import t5
from fastertransformer4codefuse_tpu_torch.models.params import from_jax_params
from fastertransformer4codefuse_tpu_torch.parallel import lockstep
from test_api import CharTokenizer
from test_bert import make_hf_bert
from test_t5_engine import ids_for, make_hf_t5
from test_torch_cli import REQUESTS as CLI_REQUESTS
from test_torch_cli import _blocks
from test_torch_parallel import port_cfg
from test_torch_parallel_families import CLI_ARGS, cli_ckpt  # noqa: F401 -- the fixture
from test_torch_pool_parallel import (
    PAGED, SAMPLING, _cfg, _jax_int8_kv_pool_tp2, _jax_static_beams, _refs,
)
from torch_tp_util import POOL_OUT_LENS, POOL_PROMPTS, VocabTokenizer, np_tree, run_group

WORLD = 4
SEEDLESS = {"prompts": [{"prompt": "def main"}], "out_seq_length": 8}
BERT_REQUESTS = [[5, 9, 11, 3, 7, 2], [40, 41, 42, 43, 44, 45], [7, 7, 8, 9, 60, 61],
                 [90, 2, 33, 4, 5, 6]]
BERT_MIXED = [[5, 9, 11], [40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50], [7, 7, 8, 9, 60],
              [90, 2, 33, 4, 5, 6, 70, 71, 72, 73, 74, 75, 76, 77, 78, 79, 80, 81, 82],
              [12, 13]]
T5_OUT = 6
HANDLER_POOL = [dict(max_slots=2, max_seq_len=16, prompt_bucket=8),
                dict(max_slots=2, max_seq_len=64, prompt_bucket=8),
                dict(max_slots=2, max_seq_len=64, prompt_bucket=8, beam_width=2)]
HANDLER_REQUESTS = [
    {"prompts": [{"prompt": "hi", "top_k": 1}], "out_seq_length": 4},
    # too long for every class: the static route, concurrent with the pools
    {"prompts": [{"prompt": "hello there", "top_k": 1}], "out_seq_length": 60},
    {"prompts": [{"prompt": "def f", "top_k": 1}], "out_seq_length": 10, "stream": True},
    {"prompts": [{"prompt": "class", "top_k": 1}], "out_seq_length": 6, "beam_width": 2},
    {"prompts": [{"prompt": "import"}], "out_seq_length": 6},  # sampled, rank 0's seed
]
SERVE_ARGS = ["--serve", "--pool_slots", "2", "--pool_seq_len", "64", "--prompt_bucket", "8"]
HTTP_POOL = dict(max_slots=2, max_seq_len=64, prompt_bucket=8)
# (case, model, tp, pool kind, pool kwargs, sampling, runtime knobs, pp, dp, tp = 1 pool too)
SERVE_CASES = [
    ("dense_tp4_sampling", "fp", 4, "dense", dict(max_slots=3), SAMPLING, {}, 1, 1, True),
    ("paged_tp4", "fp", 4, "paged", PAGED, None, {}, 1, 1, False),
    ("paged_tp2_int8_kv", "fp", 2, "paged", PAGED, None, dict(kv_cache_dtype="int8"), 1, 1,
     False),
    ("beam_tp4", "fp", 4, "beam", {}, None, {}, 1, 1, False),
    ("spec_tp4", "fp", 4, "spec", {}, None, {}, 1, 1, False),
    ("dense_tp2_pp2", "fp", 2, "dense", {}, None, {}, 2, 1, False),
    ("dense_tp2_dp2", "fp", 2, "dense", {}, None, {}, 1, 2, False),
]
# a dp-only handler: a pooled request, and a static one of four rows (one a
# dp group)
DP_REQUESTS = [
    {"prompts": [{"prompt": "hi", "top_k": 1}], "out_seq_length": 4},
    {"prompts": [{"prompt": p, "top_k": 1} for p in ("hello there", "abc", "def g", "xy")],
     "out_seq_length": 60},
]
MULTI = [dict(max_slots=2, max_seq_len=8, prompt_bucket=8),
         dict(max_slots=2, max_seq_len=16, prompt_bucket=8)]


def _sd(hf):
    return {k: v.detach().numpy() for k, v in hf.state_dict().items()}


def _t5_requests(cfg):
    ids = ids_for(cfg, 4, 9, seed=5)
    return [list(map(int, r[:n])) for r, n in zip(ids, (9, 4, 7, 5))]


@pytest.fixture(scope="module")
def group(cli_ckpt):  # noqa: F811 -- the imported fixture
    cfg = _cfg()
    p = jax_init_params(cfg, dtype="fp32")
    vocab = CharTokenizer().get_vocab()
    hb, ht = make_hf_bert(seed=4), make_hf_t5(3)
    bcfg, tcfg = jbert.config_from_hf_bert(hb.config), t5.config_from_hf_t5(ht.config)
    data = {
        "fp": (port_cfg(cfg), np_tree(p), vocab),
        "bert": (bcfg, _sd(hb), False),
        "bert_int8": (bcfg, _sd(hb), True),
        "t5": (tcfg, _sd(ht), False),
        "cli": (cli_ckpt[0], CharTokenizer(("vo", "void")).get_vocab()),
    }
    stdin = "".join(json.dumps(r) + "\n" for r in CLI_REQUESTS)
    cases = [
        ("handler_seed_tp2", "handler_case", dict(model="fp", tp=2, requests=[SEEDLESS])),
        ("encoder_order_tp2", "encoder_serve_case",
         dict(model="bert", tp=2, requests=BERT_REQUESTS)),
        *[(name, "serve_case", dict(model=m, tp=tp, kind=kind, pool=pool, sampling=smp,
                                    runtime=rt, pp=pp, dp=dp, compare_tp1=tp1))
          for name, m, tp, kind, pool, smp, rt, pp, dp, tp1 in SERVE_CASES],
        ("multi_pool_tp2", "serve_case", dict(model="fp", tp=2, classes=MULTI)),
        ("handler_pooled_tp2", "handler_case",
         dict(model="fp", tp=2, requests=HANDLER_REQUESTS, pool=HANDLER_POOL, warmup=True)),
        ("cli_serve_tp2", "cli_case", dict(model="cli", tp=2, argv=CLI_ARGS + SERVE_ARGS,
                                           stdin=stdin)),
        ("http_tp2", "http_case", dict(model="fp", tp=2, pool=HTTP_POOL)),
        ("bert_server_int8_tp2", "encoder_serve_case",
         dict(model="bert_int8", tp=2, requests=BERT_MIXED, max_batch=4, hold=True)),
        ("t5_server_tp2", "encoder_serve_case",
         dict(model="t5", tp=2, requests=_t5_requests(tcfg), max_batch=4, out_len=T5_OUT,
              hold=True)),
        ("faults_tp2", "lockstep_faults_case", dict(model="fp", tp=2)),
        ("dense_dp4", "serve_case", dict(model="fp", tp=1, dp=4)),
        ("handler_dp4", "handler_case",
         dict(model="fp", tp=1, dp=4, requests=DP_REQUESTS, pool=HTTP_POOL)),
    ]
    refs = {"fp": (cfg, p, vocab), "hb": hb, "ht": ht, "cli": cli_ckpt, "stdin": stdin,
            "greedy": _refs(cfg, p)}
    return refs, run_group(WORLD, cases, data)


def _ok(res):
    for r in res:
        assert "error" not in r, r["error"]
    return res


def _same_on_every_rank(res, *keys):
    for r in res[1:]:
        for k in keys:
            assert r[k] == res[0][k], k


def _bert_ref(hb, ids, int8=False):
    jcfg = jbert.config_from_hf_bert(hb.config)
    jp = jbert.params_from_hf_bert_state_dict(jcfg, hb.state_dict())
    if int8:
        jp = jbert.quantize_bert_params(jp)
    h, _ = jbert.encode(jcfg, jp, jnp.asarray([ids], np.int32), jnp.asarray([len(ids)], np.int32))
    return np.asarray(h)[0]


# ------------------------------------------------- the faults, repaired --

def test_a_seedless_sampled_request_is_served_with_rank_0s_seed(group):
    """The default seed is drawn once, on rank 0: every rank serves the
    request with it, and the tokens are the tp = 1 handler's with that
    seed."""
    refs, results = group
    res = _ok(results["handler_seed_tp2"])
    want = res[0]["responses"][0]
    for r in res[1:]:
        assert r["responses"][-1] == want
    cfg, p, vocab = refs["fp"]
    eng = GptNeoXEngine(port_cfg(cfg), from_jax_params(np_tree(p), device="cpu"),
                        RuntimeConfig(dtype="fp32", seq_bucket=8))
    h = CodeFuseHandler(engine=eng, tokenizer=VocabTokenizer(vocab), warmup=False)
    seeded = {**SEEDLESS, "prompts": [{**SEEDLESS["prompts"][0],
                                       "random_seed": want["random_seed"][0]}]}
    code, err, res1 = h.predict(seeded, "tp1")
    assert code == 0, err
    got = json.loads(res1["res"])
    assert got["generated_code"] == want["generated_code"] and got["length"] == want["length"]


def test_encoder_server_ranks_run_the_leaders_batches(group):
    """Every rank encodes rank 0's batches, in rank 0's order, and rank 0's
    clients get the tp = 1 encoder's hidden states."""
    refs, results = group
    res = _ok(results["encoder_order_tp2"])
    for r in res[1:]:
        assert r["batches"] == res[0]["batches"]
    for i, ids in enumerate(BERT_REQUESTS):
        np.testing.assert_allclose(res[0]["results"][i], _bert_ref(refs["hb"], ids),
                                   rtol=2e-5, atol=2e-6)


# ---------------------------------------------------------- the pools --

@pytest.mark.parametrize("name,model,tp,kind,pool,sampling,rt,pp,dp,tp1", SERVE_CASES,
                         ids=[c[0] for c in SERVE_CASES])
def test_served_pool_under_the_mesh(group, name, model, tp, kind, pool, sampling, rt, pp, dp,
                                    tp1):
    """Threaded, staggered clients on rank 0: greedy tokens equal the JAX
    references, sampled ones the port's tp = 1 pool's, and every rank
    served the same tokens and seeds."""
    refs, results = group
    res = _ok(results[name])
    outs = res[0]["outs"]
    for o in outs:
        assert "error" not in o, o["error"]
    _same_on_every_rank(res, "served")
    assert len(res[0]["served"]) == len(POOL_PROMPTS)
    served = {tuple(r["ids"]): r for _, r in res[0]["served"]}
    for o in outs:  # rank 0's answers are what every rank served
        assert served[tuple(o["ids"])] == o
    cfg, p, _ = refs["fp"]
    if kind == "beam":
        assert [o["beams"] for o in outs] == _jax_static_beams(cfg, p)
        return
    want = (_jax_int8_kv_pool_tp2(cfg, p) if rt.get("kv_cache_dtype") == "int8"
            else refs["greedy"])
    for i, o in enumerate(outs):
        if sampling is None or sampling[i].get("top_k", 1) == 1:
            assert o["ids"] == want[i], f"request {i}"
    if tp1:
        assert [o["ids"] for o in outs] == res[0]["tp1"]
        assert [o["seed"] for o in outs] == [s.get("random_seed", 0) for s in sampling]


@pytest.mark.parametrize("name", [c[0] for c in SERVE_CASES] + ["multi_pool_tp2"])
def test_served_rounds_and_collectives_are_counted_exactly(group, name):
    """Every rank published as many rounds as it ran, the same number as
    rank 0; every tick ran one all-reduce a layer of the stage for each
    chunk and decode step and one all-gather for each decode step (under
    tp), and under pp the stage's hops and one broadcast a step."""
    refs, results = group
    res = _ok(results[name])
    _same_on_every_rank(res, "rounds", "ticks")
    params = dict(zip(("name", "model", "tp", "kind", "pool", "sampling", "rt", "pp", "dp",
                       "tp1"), next((c for c in SERVE_CASES if c[0] == name),
                                    (name, "fp", 2, "dense", {}, None, {}, 1, 1, False))))
    tp, pp = params["tp"], params["pp"]
    for rank, r in enumerate(res):
        assert r["publishes"] == r["rounds"] > 0
        chunks = sum(c for c, _ in r["ticks"])
        decodes = sum(d for _, d in r["ticks"])
        n, L = chunks + decodes, r["layers"]
        assert decodes > 0
        stage = rank // tp % pp
        want = (n if stage < pp - 1 else 0, n if stage > 0 else 0, n if pp > 1 else 0,
                L * n if tp > 1 else 0, decodes if tp > 1 else 0)
        assert tuple(r["coll"]) == want, (rank, r["coll"], want)


def test_multi_pool_server_routes_by_length_on_one_driver(group):
    """At tp = 2 the two length classes tick on one driver: the request
    needing 9 positions rides the 16 class, the rest the 8 class; greedy
    tokens equal the JAX references."""
    refs, results = group
    res = _ok(results["multi_pool_tp2"])
    _same_on_every_rank(res, "served", "ticks")
    (c8, d8), (c16, d16) = res[0]["ticks"]
    assert d8 > 0 and d16 > 0
    assert [o["ids"] for o in res[0]["outs"]] == refs["greedy"]


def test_a_dp_only_server_serves_each_ranks_own_clients(group):
    """On a dp-only mesh a pool runs no collective: every rank's clients
    submit to its own pool, nothing is published, and each rank's greedy
    tokens equal the JAX references."""
    refs, results = group
    res = _ok(results["dense_dp4"])
    for r in res:
        assert [o["ids"] for o in r["outs"]] == refs["greedy"]
        assert r["publishes"] == 0 and r["rounds"] > 0
        assert not any(r["coll"])


# ------------------------------------------------- handler, CLI, HTTP --

def test_pooled_handler_with_a_concurrent_static_request_answers_as_the_jax_handler(group):
    """The pooled handler at tp = 2 (two sampling classes and a beam class,
    warmed up): a pooled, a too-long (static-route) request running beside
    it, a streamed, a beam and a seedless sampled request. The greedy and
    beam answers are the JAX handler's; every rank served the same tokens,
    seeds and static responses; the stream is the streamed answer."""
    refs, results = group
    res = _ok(results["handler_pooled_tp2"])
    _same_on_every_rank(res, "rounds")
    for r in res:
        assert r["publishes"] == r["rounds"]
    # rank 0 warmed up (a static request, one a class) before it recorded;
    # the followers recorded that too, and then what rank 0 did
    mine = dict(res[0]["served"])
    for r in res[1:]:
        theirs = dict(r["served"])
        assert {u: theirs[u] for u in mine} == mine
        assert len(theirs) - len(mine) == 1 + len(HANDLER_POOL)
    got = res[0]["responses"]
    for g in got:
        assert "error" not in g, g["error"]
    cfg, p, vocab = refs["fp"]
    tok = CharTokenizer()
    jh = JaxHandler(engine=JaxEngine(cfg, p, JaxRuntime(dtype="fp32", seq_bucket=8)),
                    tokenizer=tok, trie=JaxTrie(tok.get_vocab()), warmup=False,
                    pool=HANDLER_POOL, on_stream_text=lambda b, j, text: None)
    try:
        for i, req in enumerate(HANDLER_REQUESTS[:4]):
            code, err, jres = jh.predict(req, f"j{i}")
            assert code == 0, err
            want = json.loads(jres["res"])
            assert (got[i]["generated_code"], got[i]["length"]) == \
                (want["generated_code"], want["length"]), i
    finally:
        jh.server.close()
    assert "".join(res[0]["streamed"]) == got[2]["generated_code"][0][0]
    # the static route ran as a job on every rank, and rank 0's seeds rode
    # every admission
    assert any(r == {k: v for k, v in got[1].items()} for _, r in res[1]["served"])
    seeds = [r["seed"] for _, r in res[1]["served"] if isinstance(r, dict) and "seed" in r]
    assert got[4]["random_seed"][0] in seeds


def test_cli_serve_under_tp_prints_what_the_tp1_serve_prints(group, capsys, monkeypatch):
    """``--serve`` from stdin under ``--tensor_parallel 2`` (torchrun's
    RANK set): rank 0 alone reads and prints, the responses of the port's
    tp = 1 ``--serve`` but for the latency and the drawn seed."""
    refs, results = group
    res = _ok(results["cli_serve_tp2"])
    monkeypatch.setattr(generate, "load_tokenizer", lambda path: CharTokenizer(("vo", "void")))
    monkeypatch.setattr(sys, "stdin", io.StringIO(refs["stdin"]))
    cli.main(["--ckpt_path", refs["cli"][0], *CLI_ARGS, *SERVE_ARGS])
    want = _blocks(capsys.readouterr().out)
    assert _blocks(res[0]["stdout"]) == want and len(want) == len(CLI_REQUESTS)
    assert res[1]["stdout"] == res[2]["stdout"] == res[3]["stdout"] == ""


def test_a_dp_only_handler_leads_from_rank_0(group):
    """The handler's static route splits a batch's rows over dp, so on a
    dp-only mesh rank 0 leads: every rank serves rank 0's pooled request and
    its four-row static request, and the answers are the JAX handler's."""
    refs, results = group
    res = _ok(results["handler_dp4"])
    _same_on_every_rank(res, "rounds", "served")
    for r in res:
        assert r["publishes"] == r["rounds"] > 0
    got = res[0]["responses"]
    cfg, p, _ = refs["fp"]
    tok = CharTokenizer()
    jh = JaxHandler(engine=JaxEngine(cfg, p, JaxRuntime(dtype="fp32", seq_bucket=8)),
                    tokenizer=tok, trie=JaxTrie(tok.get_vocab()), warmup=False,
                    pool=HTTP_POOL)
    try:
        for i, req in enumerate(DP_REQUESTS):
            assert "error" not in got[i], got[i]["error"]
            code, err, jres = jh.predict(req, f"j{i}")
            assert code == 0, err
            want = json.loads(jres["res"])
            assert (got[i]["generated_code"], got[i]["length"]) == \
                (want["generated_code"], want["length"]), i
    finally:
        jh.server.close()


def test_http_flow_with_rank_0_bound(group):
    """JAX tests/test_api.py::test_http_server_end_to_end on the pooled
    handler at tp = 2: /healthz, two concurrent POSTs of 30 and 2 tokens,
    a bad request answered 500; every rank served both."""
    _, results = group
    res = _ok(results["http_tp2"])
    r0 = res[0]
    assert r0["health"] == 200
    for (status, body), want in zip(r0["posts"], (30, 2)):
        assert status == 200, body
        assert body["res"]["length"][0][0] == want
    assert r0["bad"][0] == 500 and "error" in r0["bad"][1]
    assert [r["served"] for r in res] == [2] * WORLD


# ------------------------------------------------- the encoder servers --

def test_bert_server_under_tp_matches_the_jax_encoder(group):
    """int8 BERT at tp = 2 behind the micro-batching server: requests of
    several lengths coalesce into rank 0's batches, which every rank runs;
    each answer is the JAX int8 encoder's."""
    refs, results = group
    res = _ok(results["bert_server_int8_tp2"])
    _same_on_every_rank(res, "batches", "batches_run", "served")
    assert res[0]["batches_run"] < len(BERT_MIXED)
    for i, ids in enumerate(BERT_MIXED):
        np.testing.assert_allclose(res[0]["results"][i], _bert_ref(refs["hb"], ids, int8=True),
                                   rtol=2e-5, atol=2e-6)


def test_t5_server_under_tp_matches_the_jax_engine(group):
    """T5 at tp = 2 behind its server: every rank runs rank 0's batches, and
    each greedy answer is the JAX engine's on the tp = 2 mesh."""
    refs, results = group
    res = _ok(results["t5_server_tp2"])
    _same_on_every_rank(res, "batches", "batches_run", "served")
    assert res[0]["batches_run"] < len(res[0]["results"])
    ht = refs["ht"]
    jcfg = jt5.config_from_hf_t5(ht.config)
    jeng = JaxT5Engine(jcfg, jt5.params_from_hf_t5_state_dict(jcfg, ht.state_dict()),
                       mesh=build_mesh(tp=2))
    for i, ids in enumerate(_t5_requests(t5.config_from_hf_t5(ht.config))):
        want = np.asarray(jeng.generate([ids], T5_OUT).output_ids)[0]
        np.testing.assert_array_equal(res[0]["results"][i], want)


# ------------------------------------------------------------ hazards --

def test_an_idle_follower_outlasts_a_short_control_timeout(group):
    """With a 2 s control timeout the leader idles 3 s, heartbeating every
    0.5 s, then serves a request: no rank fails, and the answer is the JAX
    reference."""
    refs, results = group
    res = _ok(results["faults_tp2"])
    assert res[0]["idle_ids"] == refs["greedy"][0]
    _same_on_every_rank(res, "idle_rounds")
    assert res[0]["idle_rounds"] >= 5  # 3 s of heartbeats, then the work


def test_a_followers_error_reaches_rank_0s_waiter(group):
    """A follower that cannot apply a round stops every rank at that round:
    rank 0's waiter gets "pool driver died" at once, the follower's
    ``follow`` raises with its own error."""
    _, results = group
    res = _ok(results["faults_tp2"])
    msg, cause = res[0]["fault"]
    assert msg == "pool driver died" and "another rank of the group failed" in cause
    assert res[0]["fault_s"] < 30
    for r in res[1:]:
        msg, cause = r["fault"]
        assert msg == "pool driver died" and "injected fault" in cause


# ------------------------------------------------------------ one rank --

def _tiny_engine():
    cfg = _cfg()
    return GptNeoXEngine(port_cfg(cfg), from_jax_params(np_tree(jax_init_params(cfg, dtype="fp32")),
                                                        device="cpu"),
                         RuntimeConfig(dtype="fp32", seq_bucket=8))


def test_one_rank_serves_through_the_same_rounds_without_a_group():
    """At one rank the servers and the handler run the rounds of a mesh on
    their driver threads with nothing published: a server's tokens equal
    its pool's driven by hand; a multi-pool server keeps a driver a class,
    and the pooled handler's static route a driver of its own."""
    eng = _tiny_engine()
    pool = dict(max_slots=2, max_seq_len=32, prompt_bucket=8)
    since = lockstep.publish.calls
    srv = BatchingServer(eng, **pool)
    try:
        assert srv.lockstep.rounds.group is None and srv.lockstep.leader
        got = [srv.generate(p, n, top_k=1).output_ids for p, n in zip(POOL_PROMPTS, POOL_OUT_LENS)]
        with pytest.raises(RuntimeError, match="several ranks"):
            srv.follow()
    finally:
        srv.close()
    cb = ContinuousBatcher(eng, **pool)
    uids = [cb.submit(p, n, top_k=1) for p, n in zip(POOL_PROMPTS, POOL_OUT_LENS)]
    done = cb.run()
    assert got == [done[u].output_ids for u in uids]
    multi = MultiPoolServer(eng, [dict(pool, max_seq_len=8), pool])
    try:
        assert multi.lockstep is None
        drivers = {id(s.lockstep.rounds._thread) for s in multi.servers}
        assert len(drivers) == 2
        assert multi.generate(POOL_PROMPTS[0], 4, top_k=1).output_ids == got[0][:len(
            POOL_PROMPTS[0]) + 4]
    finally:
        multi.close()
    h = CodeFuseHandler(engine=eng, tokenizer=VocabTokenizer(CharTokenizer().get_vocab()),
                        warmup=False, pool=pool)
    try:
        assert h.lockstep is not h.server.lockstep and not h.lockstep.batchers
        code, err, _ = h.predict({"prompts": [{"prompt": "ab", "top_k": 1}],
                                  "out_seq_length": 40}, "static")  # too long for the pool
        assert code == 0, err
        assert h.lockstep.rounds.rounds > 0
    finally:
        h.close()
    assert lockstep.publish.calls == since


class _Stop(BaseException):
    """Not an Exception: what a driver must still tell its waiters of."""


def test_a_base_exception_in_a_driver_tells_every_waiter(monkeypatch):
    """A driver hit by a BaseException fails its waiters (the pool's with
    "pool driver died", the encoder batch's with its own error) instead of
    leaving them to wait for good, and takes no more requests."""
    import threading

    monkeypatch.setattr(threading, "excepthook", lambda args: None)  # the driver re-raises
    srv = BatchingServer(_tiny_engine(), max_slots=2, max_seq_len=32, prompt_bucket=8)
    try:
        def stop():
            raise _Stop()

        srv.batcher._dispatch_tick = stop
        uid = srv.submit([3, 4, 5], 4, top_k=1)
        with pytest.raises(RuntimeError, match="driver died"):
            srv.wait(uid, timeout=60)
        assert isinstance(srv.lockstep.rounds.error, _Stop)
    finally:
        srv.close()

    class Engine:
        mesh = None

        def encode(self, ids, lens):
            raise _Stop()

    enc = EncoderBatchingServer(Engine(), max_batch=2, seq_bucket=8)
    try:
        with pytest.raises(RuntimeError, match="encoder batch failed"):
            enc.encode([1, 2, 3], timeout=60)
        enc.lockstep._thread.join(timeout=60)
        with pytest.raises(RuntimeError, match="driver died"):
            enc.encode([1, 2], timeout=60)
    finally:
        enc.close()
