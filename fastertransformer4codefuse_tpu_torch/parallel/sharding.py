"""Tensor-parallel split rules and this rank's parameter slices (port of
parallel/sharding.py).

The reference column-splits QKV and FFN-up and row-splits proj and
FFN-down per rank (huggingface_convert.py:44-74), all-reduces once a layer
under the parallel residual (GptNeoXDecoder.cc:342-360) and splits the LM
head by vocab (GptNeoX.cc:888-925). The JAX package writes that as
PartitionSpecs and XLA inserts the psum; here the same rules pick each
rank's slice of every weight, and ``models/gptneox.py`` runs the explicit
collectives (``parallel.distributed``).

A rule is the axis of a stacked ``[L, ...]`` weight that is split over the
tp ranks (negative: from the end), or None for a replicated weight. A
quantized weight's scales follow it: per-output-channel scales drop the K
axis (replicated under a row split), group-wise scales ``[L, K/G, N]``
split their K-group axis with K. A ``"concat"`` QKV ([q | k | v] with
unequal head counts, GQA and MQA) is replicated, as in the JAX package: every
rank computes all heads and keeps its own (``local_heads``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.config import GptNeoXConfig
from ..models.params import Params, QuantizedTensor
from .distributed import Mesh


def build_mesh(tp: int = 1, dp: int = 1, pp: int = 1) -> Mesh:
    """This rank's mesh over the process group: ranks in (dp, pp, tp) order
    with tp innermost, as the JAX ``build_mesh`` lays its devices out, so a
    tp group is consecutive ranks (one host's cards) and a stage's tp group
    sits beside the next stage's. A group of more than ``tp * pp * dp``
    ranks holds several copies of the mesh, each serving the same requests.
    Every rank of the group must call this, with the same arguments: it
    creates the tp, pp and dp subgroups. Without a process group only
    ``tp = pp = dp = 1`` is possible."""
    import torch.distributed as dist

    n = tp * pp * dp
    if not dist.is_initialized():
        if n != 1:
            raise ValueError(f"a mesh of {n} ranks needs a process group (init_distributed)")
        return Mesh()
    world, rank = dist.get_world_size(), dist.get_rank()
    if world % n:
        raise ValueError(f"tp {tp} x pp {pp} x dp {dp} does not divide the {world} ranks")
    base, local = rank - rank % n, rank % n

    def coords(loc):
        return {"dp": loc // (pp * tp), "pp": loc // tp % pp, "tp": loc % tp}

    groups = {}
    for b in range(0, world, n):  # every rank creates every group, in one order
        for axis, size in (("tp", tp), ("pp", pp), ("dp", dp)):
            if size == 1:
                continue
            members = {}  # the other two coordinates -> the group's ranks, in axis order
            for loc in range(n):
                key = tuple(v for k, v in coords(loc).items() if k != axis)
                members.setdefault(key, []).append(b + loc)
            for ranks in members.values():
                g = dist.group.WORLD if len(ranks) == world else dist.new_group(ranks)
                if rank in ranks:
                    groups[axis] = (g, tuple(ranks))
    c = coords(local)
    return Mesh(tp=tp, dp=dp, pp=pp, tp_rank=c["tp"], dp_rank=c["dp"], pp_rank=c["pp"],
                tp_group=groups.get("tp", (None,))[0], dp_group=groups.get("dp", (None,))[0],
                pp_group=groups.get("pp", (None,))[0], pp_ranks=groups.get("pp", (None, ()))[1])


def stage_layers(config: GptNeoXConfig, mesh: Optional[Mesh]) -> Tuple[int, int]:
    """(first, count) of the layers this rank's pipeline stage holds: the
    contiguous block ``[pp_rank * L/pp, (pp_rank + 1) * L/pp)`` (the
    reference's GptNeoXDecoder.cc:94-120 layout). Raises where pp does not
    divide the layers, as the JAX engine asserts."""
    pp = 1 if mesh is None else mesh.pp
    L = config.layer_num
    if L % pp:
        raise ValueError(f"layer_num {L} does not split over pp {pp}")
    return (0 if mesh is None else mesh.pp_rank) * (L // pp), L // pp


# Split axes of the stacked layer weights [L, ...] (the JAX LAYER_SPECS'
# "tp" slots; a bias follows its weight's columns).
LAYER_SPLITS = {
    "ln1_w": None, "ln1_b": None, "ln2_w": None, "ln2_b": None,
    "qkv_w": -1, "qkv_b": -1,  # [L, H, nH*3*dh] heads-major: a head split
    "proj_w": -2, "proj_b": None,  # [L, nH*dh, H]: a row split
    "up_w": -1, "up_b": -1,  # [L, H, I]
    "gate_w": -1, "gate_b": -1,  # SwiGLU gate, split like up
    "down_w": -2, "down_b": None,  # [L, I, H]
    # MoE (Mixtral): expert parallelism, each rank holds E/tp whole experts
    "router_w": None,  # [L, H, E]
    "eup_w": 1, "egate_w": 1, "edown_w": 1,  # [L, E, H, I] / [L, E, I, H]
}

TOP_SPLITS = {
    "embed": None,  # replicated (a gather; small beside the layers)
    "pos_embed": None,
    "final_ln_w": None,
    "final_ln_b": None,
    "lm_head": 0,  # [V, H]: a vocab split
    "lm_head_b": 0,
}


def split_axis(config: GptNeoXConfig, name: str, value, top: bool = False) -> Optional[int]:
    """The split axis of ``params[name]`` (a layer weight unless ``top``),
    normalized to >= 0, or None where it is replicated."""
    if top:
        if name == "lm_head" and isinstance(value, QuantizedTensor) and \
                value.k_axis % value.q.ndim == 0:
            return 1  # the transposed int4 head [H/2, V_pad]: vocab is axis 1
        ax = TOP_SPLITS[name]
    elif name in ("qkv_w", "qkv_b") and config.qkv_layout == "concat":
        ax = None  # [q | k | v] of unequal widths: replicated (JAX sharding.py:125-128)
    else:
        ax = LAYER_SPLITS[name]
    if ax is None:
        return None
    ndim = value.q.ndim if isinstance(value, QuantizedTensor) else value.ndim
    return ax % ndim


def _scale_axis(qt: QuantizedTensor, ax: Optional[int]) -> Optional[int]:
    """The split axis of a quantized weight's scales (JAX ``_spec_for_quant``)."""
    if ax is None or qt.group_size:
        return ax
    k = qt.k_axis % qt.q.ndim
    if ax == k:
        return None  # per-channel scales of a row split: replicated
    return ax - 1 if ax > k else ax


def _take(x: torch.Tensor, ax: Optional[int], mesh: Mesh, what: str) -> torch.Tensor:
    if ax is None or mesh.tp == 1:
        return x
    n = x.shape[ax]
    if n % mesh.tp:
        raise ValueError(f"{what}: axis {ax} of length {n} does not split over tp {mesh.tp}")
    w = n // mesh.tp
    return x.narrow(ax, mesh.tp_rank * w, w).clone(memory_format=torch.contiguous_format)


def shard_tensor(value, ax: Optional[int], mesh: Mesh, what: str = "tensor"):
    """This rank's slice of ``value`` (a tensor or QuantizedTensor, its
    scales following it) along ``ax``; the whole of it where ``ax`` is None."""
    if isinstance(value, QuantizedTensor):
        return dataclasses.replace(
            value, q=_take(value.q, ax, mesh, what),
            scale=_take(value.scale, _scale_axis(value, ax), mesh, what + " scales"))
    return _take(value, ax, mesh, what)


def pad_vocab_for_tp(config: GptNeoXConfig, params: Params, mesh: Mesh) -> Params:
    """Zero rows appended to the [V, H] LM head (its per-row scales and
    ``lm_head_b`` too) up to a multiple of tp, the reference's padded vocab
    (GptNeoX.cc:260-264): CodeFuse's 100831 pads by one at tp = 2.
    ``models.gptneox.lm_logits`` cuts the logits back to ``vocab_size``, so
    a pad id is never drawn. The transposed int4 head is already padded to
    a multiple of 2560 and is left alone."""
    w = params.get("lm_head")
    if mesh.tp <= 1 or w is None:
        return params
    if isinstance(w, QuantizedTensor) and w.k_axis % w.q.ndim == 0:
        b, Vp = params.get("lm_head_b"), w.q.shape[1]
        if b is None or b.shape[0] == Vp:
            return params
        return {**params, "lm_head_b": F.pad(b, (0, Vp - b.shape[0]))}  # follows the head
    V = w.shape[0]
    pad = (-V) % mesh.tp
    if pad == 0:
        return params
    out = dict(params)
    if isinstance(w, QuantizedTensor):  # per-row scales [V], or group scales [V, H/G]
        out["lm_head"] = dataclasses.replace(
            w, q=F.pad(w.q, (0, 0, 0, pad)),
            scale=F.pad(w.scale, (0, 0) * (w.scale.ndim - 1) + (0, pad)))
    else:
        out["lm_head"] = F.pad(w, (0, 0, 0, pad))
    if "lm_head_b" in out:
        out["lm_head_b"] = F.pad(params["lm_head_b"], (0, pad))
    return out


def _stage_block(value, first: int, count: int):
    """Layers [first, first + count) of a stacked [L, ...] weight (a
    quantized weight's scales too), copied out of the full stack."""
    if isinstance(value, QuantizedTensor):
        return dataclasses.replace(value, q=value.q[first:first + count].clone(),
                                   scale=value.scale[first:first + count].clone())
    return value[first:first + count].clone()


def shard_params(config: GptNeoXConfig, params: Params, mesh: Mesh) -> Params:
    """This rank's slice of every weight of the full ``params`` (the JAX
    ``shard_params``: what ``jax.device_put`` places on the device at this
    rank's pp and tp coordinates): its stage's block of the stacked layers
    (``stage_layers``), then its tp slice; the embeddings, the final norm
    and the head are replicated over pp. Checks the splits the kernels
    need: whole layers a stage, whole heads a rank, an int4 K slice of
    whole bytes, group scales on whole groups."""
    if mesh.tp == 1 and mesh.pp == 1:
        return params
    first, count = stage_layers(config, mesh)
    tp = mesh.tp
    if config.head_num % tp:
        raise ValueError(f"{config.head_num} heads do not split over tp {tp}")
    if config.moe_experts % tp:
        raise ValueError(f"{config.moe_experts} experts do not split over tp {tp}")
    params = pad_vocab_for_tp(config, params, mesh)
    out = {}
    for k, v in params.items():
        if k == "layers":
            layers = {}
            for n, val in v.items():
                if mesh.pp > 1:
                    val = _stage_block(val, first, count)
                ax = split_axis(config, n, val)
                if isinstance(val, QuantizedTensor) and ax is not None:
                    k_ax = val.k_axis % val.q.ndim
                    K = val.shape[k_ax]
                    if ax == k_ax and val.bits == 4 and (K // tp) % 2:
                        raise ValueError(f"{n}: int4 rows pack along K; K/tp = {K // tp} is odd")
                    if ax == k_ax and val.group_size and (K // tp) % val.group_size:
                        raise ValueError(f"{n}: K/tp = {K // tp} is not a multiple of the "
                                         f"group size {val.group_size}")
                layers[n] = shard_tensor(val, ax, mesh, n)
            out[k] = layers
        else:
            out[k] = shard_tensor(v, split_axis(config, k, v, top=True), mesh, k)
    return out


def local_heads(config: GptNeoXConfig, mesh: Optional[Mesh]) -> Tuple[int, int]:
    """(first, count) of this rank's query heads: the attention output rows
    its proj slice contracts."""
    tp = 1 if mesh is None else mesh.tp
    n = config.head_num // tp
    return (0 if mesh is None else mesh.tp_rank) * n, n


def cache_heads(config: GptNeoXConfig, mesh: Optional[Mesh]) -> Tuple[int, int]:
    """(first, count) of the KV heads this rank's cache slabs hold (the JAX
    ``cache_sharding`` / ``pool_state_shardings``): the kv-head axis split
    over tp, or every head where ``kv_heads % tp != 0`` (GQA and MQA
    families with few KV heads: correct, not memory-scaled)."""
    tp = 1 if mesh is None else mesh.tp
    nkv = config.kv_heads
    if nkv % tp:
        return 0, nkv
    return (0 if mesh is None else mesh.tp_rank) * (nkv // tp), nkv // tp
