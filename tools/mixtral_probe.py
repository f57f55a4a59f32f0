"""Mixtral-8x7B's expert capacity on the card and on the CPU.

Builds phase 8b's Mixtral-8x7B of ``chip_smoke.py`` (published widths, 1
layer, int8 weights and embeddings from seed 11) on the card, copies it to
the CPU, and runs the batched static greedy of ``FAMILY_PROMPTS`` on both.
For the first MoE call of each side (the batched prefill) it prints the
rows T, the capacity C = ceil(T k / E * factor), each expert's load, the
slots dropped and the smallest top-k margin of the router; then the
step-0 logits of the batch and of the first prompt alone on both sides
(relative distances, argmaxes, the CPU's best five), the greedy tokens, and
the MoE calls where the two sides route a token to other experts.

Run on a machine with an NVIDIA GPU, from the repository's root:

    python3 tools/mixtral_probe.py
"""
import json
import math
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
import fastertransformer4codefuse_tpu_torch as pkg  # noqa: E402
from fastertransformer4codefuse_tpu_torch.models import gptneox as model  # noqa: E402
from fastertransformer4codefuse_tpu_torch.models.params import params_to  # noqa: E402
from fastertransformer4codefuse_tpu_torch.ops import _cuda  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        return cs.fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    _cuda.build()
    _cuda.lib()
    _, family, hf, quant, _ = next(f for f in cs.FAMILIES if f[0] == "Mixtral-8x7B")
    cfg = cs.family_config(pkg, family, hf, layers=1)
    p_card = cs.family_params(torch, pkg, cfg, hf, 11, "cuda", quant)
    p_cpu = params_to(p_card, "cpu")
    real, side = model.moe_ffn, ["card"]
    calls = {"card": [], "cpu": []}

    def recording(x2d, router_w, egate, eup, edown, top_k, factor, act="silu", valid=None,
                  **kw):
        T, E = x2d.shape[0], router_w.shape[-1]
        probs = torch.softmax(x2d.float() @ router_w.float(), dim=-1)
        idx = torch.topk(probs, top_k, dim=-1).indices
        if valid is not None:
            idx = torch.where(valid[:, None], idx, torch.full_like(idx, E))
        C = min(max(int(math.ceil(T * top_k / E * factor)), 1), T * top_k)
        counts = torch.bincount(idx.reshape(-1), minlength=E + 1)[:E]
        srt = probs.sort(-1, descending=True).values
        calls[side[0]].append(dict(
            T=T, C=C, counts=counts.tolist(), dropped=int((counts - C).clamp(min=0).sum()),
            experts=[sorted(r) for r in idx.cpu().tolist()],
            margin=(srt[:, top_k - 1] - srt[:, top_k]).min().item()))
        return real(x2d, router_w, egate, eup, edown, top_k, factor, act=act, valid=valid, **kw)

    model.moe_ffn = recording
    tokens = {}
    try:
        for name, p in (("card", p_card), ("cpu", p_cpu)):
            side[0] = name
            tokens[name] = cs.family_tokens(pkg, cfg, p, cs.FAMILY_PROMPTS, cs.FAMILY_TOKENS)
    finally:
        model.moe_ffn = real
    rt = pkg.RuntimeConfig(dtype="bf16", int8_mode=1, kv_cache_dtype="int8", seq_bucket=8)
    lg = {}
    for name, p in (("card", p_card), ("cpu", p_cpu)):
        eng = pkg.GptNeoXEngine(cfg, p, rt)
        for tag, prompts in (("", cs.FAMILY_PROMPTS), ("_alone", cs.FAMILY_PROMPTS[:1])):
            st, inputs = eng._prepare(prompts, cs.FAMILY_TOKENS, top_k=1)
            lg[name + tag] = eng._prefill_state(st, inputs).logits[0].float().cpu()
    m = lg["cpu"].abs().max().item()

    def rel(a, b):
        return (lg[a] - lg[b]).abs().max().item() / m

    for name in ("card", "cpu"):
        c = calls[name][0]
        print(f"{name} prefill: T {c['T']} C {c['C']} loads {c['counts']} dropped "
              f"{c['dropped']} smallest top-k margin {c['margin']:.3e}")
    differ = [i for i, (a, b) in enumerate(zip(calls["card"], calls["cpu"]))
              if a["experts"] != b["experts"]]
    print(json.dumps({
        "tokens": tokens,
        "step0_card_vs_cpu": rel("card", "cpu"),
        "alone_card_vs_cpu": rel("card_alone", "cpu_alone"),
        "card_batch_vs_alone": rel("card", "card_alone"),
        "cpu_batch_vs_alone": rel("cpu", "cpu_alone"),
        "argmax": {k: int(v.argmax()) for k, v in lg.items()},
        "cpu_top5": [(int(i), float(lg["cpu"][i])) for i in lg["cpu"].topk(5).indices],
        "max_abs_logit": m, "moe_calls_routing_differently": differ,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
