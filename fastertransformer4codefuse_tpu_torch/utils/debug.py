"""Debug mode: the NaN/Inf sweep of ``FT_DEBUG_LEVEL=DEBUG`` (port of
utils/debug.py).

The reference turns ``sync_check_cuda_error()`` into a device sync and an
error check after every kernel when ``FT_DEBUG_LEVEL=DEBUG``. The JAX package
re-runs prefill and one decode step under ``checkify`` with a finiteness
assertion after every layer. Here the same forward runs through the model's
own routes (the kernels on the card), each stage's finiteness lands in a
device flag, and the host reads the flags once at the end of each forward:
one sync after the prefill, one after the decode step. The first non-finite
stage is named: the embeddings, layer ``l``, the final layernorm, the logits.

- ``scan_params``: every float leaf (a QuantizedTensor's scales) with
  non-finite entries, as ``(path, count)``;
- ``checked_forward``: the layer-attributed prefill + decode check;
- ``debug_verify``: both, as ``GptNeoXEngine.generate`` runs them when
  ``RuntimeConfig.debug_enabled()``. Nothing here runs otherwise, and no pool
  tick calls it.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..core.config import GptNeoXConfig
from ..engine import kv_cache
from ..models import gptneox as model
from ..models.params import Params, QuantizedTensor, layer_slice
from ..ops.rotary import make_rotary_tables
from ..parallel.sharding import cache_heads


class DebugCheckError(RuntimeError):
    """A debug-mode finiteness check failed (the message names the stage)."""


def _iter_leaves(tree, prefix=""):
    """(path, leaf) pairs; a QuantizedTensor contributes its scales (its
    integer payload is finite by construction)."""
    if isinstance(tree, QuantizedTensor):
        yield prefix + ".scale", tree.scale
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _iter_leaves(tree[k], f"{prefix}.{k}" if prefix else k)
        return
    if isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _iter_leaves(v, f"{prefix}[{i}]")
        return
    yield prefix, tree


def scan_params(params: Params) -> List[Tuple[str, int]]:
    """Every float leaf with non-finite entries, as (path, count); a stacked
    [L, ...] tensor counts over all its layers (``checked_forward`` names the
    layer). One host read for the whole sweep."""
    paths, counts = [], []
    for path, leaf in _iter_leaves(params):
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
            paths.append(path)
            counts.append((~torch.isfinite(leaf)).sum())
    if not counts:
        return []
    n = torch.stack(counts).tolist()
    return [(p, int(c)) for p, c in zip(paths, n) if c]


class _Flags:
    """Stage names and their device-side all-finite flags, read at once."""

    def __init__(self):
        self.names, self.flags = [], []

    def check(self, name: str, t: torch.Tensor) -> None:
        self.names.append(name)
        self.flags.append(torch.isfinite(t).all())

    def raise_first(self) -> None:
        ok = torch.stack(self.flags).tolist()  # the one sync of this forward
        for name, good in zip(self.names, ok):
            if not good:
                raise DebugCheckError(name)
        self.names, self.flags = [], []


def checked_forward(
    config: GptNeoXConfig,
    params: Params,
    input_ids,  # [B, S] int (right-padded)
    input_lengths,  # [B]
    cache_dtype=torch.bfloat16,
    fused: bool = True,
    act_int8: bool = False,
    mesh=None,
) -> None:
    """Prefill and one greedy decode step with a finiteness check after the
    embeddings, every layer, the final layernorm and the logits; raises
    ``DebugCheckError`` naming the first non-finite stage (the JAX
    function's messages: "non-finite activation after layer 1 (prefill)").
    ``cache_dtype`` is what the engine's cache takes; ``fused`` and
    ``act_int8`` choose the routes as the engine's runtime does; ``mesh``
    the engine's under tensor parallelism (``params`` the rank's slice)."""
    dev = params["final_ln_w"].device
    ids = torch.as_tensor(np.asarray(input_ids, np.int32), device=dev)
    lens = torch.as_tensor(np.asarray(input_lengths, np.int32), device=dev)
    B, S = ids.shape
    W = S + 1
    if isinstance(cache_dtype, str):  # packed int4: an even width
        W += W % 2
    cache = kv_cache.init_cache(config, B, W, cache_dtype, dev,
                                kv_heads=cache_heads(config, mesh)[1])
    cos_t, sin_t = make_rotary_tables(W, config.rotary_embedding_dim, config.rotary_base, dev)
    layers = params["layers"]
    f = _Flags()

    x = model._embed_lookup(params, ids)
    f.check("non-finite embeddings", x)
    for l in range(config.layer_num):
        x, cache = model.block_prefill(config, layer_slice(layers, l), x, cache, l, cos_t[:S],
                                       sin_t[:S], lens, fused, act_int8, mesh)
        f.check(f"non-finite activation after layer {l} (prefill)", x)
    last = model.last_token_hidden(x, lens)
    f.check("non-finite final layernorm (prefill)", model.final_norm(config, params, last))
    logits = model.lm_logits(config, params, last, mesh)
    f.check("non-finite logits (prefill)", logits)
    f.raise_first()

    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    positions = lens
    cos, sin = cos_t[positions.long()][:, None, :], sin_t[positions.long()][:, None, :]
    xd = model._embed_lookup(params, tok)[:, None, :]
    for l in range(config.layer_num):
        xd, cache = model.block_decode(config, layer_slice(layers, l), xd, cache, l, cos, sin,
                                       positions, fused=fused, mesh=mesh)
        f.check(f"non-finite activation after layer {l} (decode)", xd)
    f.check("non-finite logits (decode)", model.lm_logits(config, params, xd[:, 0], mesh))
    f.raise_first()


def debug_verify(engine, input_ids, input_lengths) -> None:
    """The engine's hook: the weight sweep, then the checked forward, on the
    engine's cache kind and routes."""
    bad = scan_params(engine.params)
    if bad:
        listing = ", ".join(f"{p} ({n} bad)" for p, n in bad[:8])
        raise DebugCheckError(f"non-finite weights: {listing}")
    rt = engine.runtime
    checked_forward(engine.config, engine.params, np.asarray(input_ids, np.int32),
                    np.asarray(input_lengths, np.int32), cache_dtype=engine._cache_dtype(),
                    fused=rt.fused_decode, act_int8=rt.act_int8, mesh=engine.mesh)
