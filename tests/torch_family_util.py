"""Shared checks of the decoder families in the port
(fastertransformer4codefuse_tpu_torch: ``models.registry``, ``ckpt/convert_*``,
``models/gptneox.py``) against HF and the JAX package, on tiny random HF
models. Each ``tests/test_torch_<family>.py`` runs its JAX file's cases
(tests/test_<family>.py) through these helpers.

Tolerances: HF parity at the JAX file's own tolerance; the port's fp32
logits within atol=2e-4, rtol=1e-4 of the JAX package's ``prefill`` +
``lm_logits`` on the same HF weights; greedy tokens equal token for token,
on the static engine and on a pool."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from fastertransformer4codefuse_tpu import GptNeoXConfig as JaxConfig
from fastertransformer4codefuse_tpu import GptNeoXEngine as JaxEngine
from fastertransformer4codefuse_tpu import RuntimeConfig as JaxRuntime
from fastertransformer4codefuse_tpu.engine.batcher import ContinuousBatcher as JaxBatcher
from fastertransformer4codefuse_tpu.models import gptneox as jm
from fastertransformer4codefuse_tpu.models import registry as jreg
from fastertransformer4codefuse_tpu_torch import GptNeoXConfig, GptNeoXEngine, RuntimeConfig
from fastertransformer4codefuse_tpu_torch import from_jax_params
from fastertransformer4codefuse_tpu_torch.engine import kv_cache as kvc
from fastertransformer4codefuse_tpu_torch.engine.batcher import ContinuousBatcher
from fastertransformer4codefuse_tpu_torch.models import gptneox as tm
from fastertransformer4codefuse_tpu_torch.models import registry

PROMPTS = [[3, 4, 5, 6, 7, 8, 9, 10, 11], [20, 21, 22]]
OUT = 6
PAGED = dict(num_pages=10, page_size=8)


@dataclasses.dataclass
class Family:
    """One HF model converted by both packages: the port's config and
    params on the CPU, the JAX package's."""
    name: str
    hf: object
    cfg: GptNeoXConfig
    params: dict
    jcfg: JaxConfig
    jparams: dict


def convert(name, hf) -> Family:
    fam, jfam = registry.get(name), jreg.get(name)
    cfg, jcfg = fam.config_from_hf(hf.config), jfam.config_from_hf(hf.config)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    sd = hf.state_dict()
    return Family(name, hf, cfg, fam.params_from_hf(cfg, sd, device="cpu"), jcfg,
                  jfam.params_from_hf(jcfg, sd))


def ids(cfg, B=2, S=10, seed=0):
    return np.random.RandomState(seed).randint(0, cfg.vocab_size, size=(B, S)).astype(np.int32)


def hf_logits(hf, x):
    with torch.no_grad():
        return hf(torch.tensor(x, dtype=torch.long)).logits.numpy()


def port_logits(cfg, params, x):
    B, S = x.shape
    cache = kvc.init_cache(cfg, B, S, torch.float32, "cpu")
    h, cache = tm.prefill(cfg, params, torch.from_numpy(x), torch.full((B,), S, dtype=torch.int32),
                          cache)
    return tm.lm_logits(cfg, params, h).numpy(), cache


def jax_logits(jcfg, jparams, x):
    B, S = x.shape
    h, _ = jm.prefill(jcfg, jparams, jnp.asarray(x), jnp.full((B,), S, jnp.int32),
                      jm.init_kv_cache(jcfg, B, S, jnp.float32))
    return np.asarray(jm.lm_logits(jcfg, jparams, h))


def check_logits(f: Family, hf_atol, hf_rtol=3e-3):
    """The port's prefill logits against HF (the JAX file's tolerance) and
    against the JAX package (atol 2e-4, rtol 1e-4); returns the cache."""
    x = ids(f.cfg)
    ours, cache = port_logits(f.cfg, f.params, x)
    np.testing.assert_allclose(ours, hf_logits(f.hf, x), atol=hf_atol, rtol=hf_rtol)
    np.testing.assert_allclose(ours, jax_logits(f.jcfg, f.jparams, x), atol=2e-4, rtol=1e-4)
    return cache


def hf_greedy(hf, prompt, n):
    out = torch.tensor([prompt], dtype=torch.long)
    with torch.no_grad():
        for _ in range(n):
            nxt = hf(out).logits[:, -1].argmax(-1, keepdim=True)
            out = torch.cat([out, nxt], dim=1)
    return out.numpy()[0, len(prompt):].tolist()


def check_greedy_vs_hf(f: Family, S=8, n=OUT, seed=2, lo=0, **rt):
    """Greedy decode (prefill, then steps over the cache) token for token
    HF's own forward, up to the end id; prompt ids drawn from [lo, V - 1)."""
    eng = GptNeoXEngine(f.cfg, f.params, RuntimeConfig(dtype="fp32", seq_bucket=4, **rt))
    prompt = list(np.random.RandomState(seed).randint(lo, f.cfg.vocab_size - 1, size=S))
    got = eng.generate([prompt], output_len=n, top_k=1).output_ids[0, 0, S:S + n]
    for a, b in zip(got, hf_greedy(f.hf, prompt, n)):
        assert a == b
        if a == f.cfg.end_id:
            break


def static_tokens(eng, prompts=PROMPTS, n=OUT):
    out = eng.generate(prompts, output_len=n, top_k=1)
    return [list(map(int, out.output_ids[b, 0, :out.sequence_lengths[b, 0]]))
            for b in range(len(prompts))]


def pool_tokens(batcher, prompts=PROMPTS, n=OUT):
    uids = [batcher.submit(p, n, top_k=1) for p in prompts]
    done = batcher.run(max_ticks=400)
    return [list(map(int, done[u].output_ids)) for u in uids]


def engines(f: Family, **rt):
    """(port engine, JAX engine) over the same HF weights, fp32."""
    rt = dict(dict(dtype="fp32", seq_bucket=4), **rt)
    return (GptNeoXEngine(f.cfg, f.params, RuntimeConfig(**rt)),
            JaxEngine(f.jcfg, f.jparams, JaxRuntime(**rt)))


def check_tokens_vs_jax(f: Family, paged=True, **rt):
    """Greedy tokens of the port equal the JAX engine's token for token: the
    static engine, then a pool (paged, or dense slabs) on the same prompts."""
    te, je = engines(f, **rt)
    want = static_tokens(je)
    assert static_tokens(te) == want
    kw = dict(max_slots=2, max_seq_len=32, prompt_bucket=4, paged=PAGED if paged else None)
    jpool = pool_tokens(JaxBatcher(je, **kw))
    assert pool_tokens(ContinuousBatcher(te, **kw)) == jpool
    return want, jpool


def check_from_jax_params(f: Family, skip=()):
    """``from_jax_params`` of the JAX converter's tree is the port
    converter's output, key for key (``skip``: keys only the JAX tree has)."""
    got = from_jax_params(f.jparams, device="cpu")

    def walk(a, b, path):
        if isinstance(b, dict):
            assert sorted(k for k in a if k not in skip) == sorted(b), path
            for k in b:
                walk(a[k], b[k], f"{path}.{k}")
        else:
            np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=path)

    walk(got, f.params, "params")


def check_ini_roundtrip(cfg, tmp_path):
    cfg.to_ini(str(tmp_path))
    back = GptNeoXConfig.from_ini(str(tmp_path))
    assert back == cfg
    assert dataclasses.asdict(back) == dataclasses.asdict(JaxConfig.from_ini(str(tmp_path)))
    return back


def check_registry(name, hf):
    """``registry.get(name)`` serves the family through a GptNeoXEngine."""
    fam = registry.get(name)
    assert name in registry.families()
    cfg = fam.config_from_hf(hf.config)
    eng = fam.make_engine(cfg, fam.params_from_hf(cfg, hf.state_dict(), device="cpu"),
                          runtime=RuntimeConfig(dtype="fp32", seq_bucket=4))
    assert isinstance(eng, GptNeoXEngine)
    assert fam.prefill is tm.prefill and fam.decode_step is tm.decode_step
    return cfg
