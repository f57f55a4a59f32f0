"""GPT-NeoX transformer (PyTorch port of models/gptneox.py).

Both residual schemes of the JAX package:
  parallel (GPT-J) residual:  out = x + attn(ln1(x)) + ffn(ln2(x)) + bias_sum
  serial residual:            h = x + attn(ln1(x)) + b_proj; out = h + ffn(ln2(h)) + b_down

``lax.scan`` over the stacked layers becomes a Python loop over per-layer
views (``params.layer_slice``), which hands the kernels each layer's slice of
the stacked weights and cache without a copy.

``prefill_chunk`` runs one prompt chunk per row over an already-filled
cache (the continuous batcher's chunk tick); ``decode_step``'s ``kv_skip``
rows write where no row reads (the pool's idle slots).

The decoder families ride the same block through the config's knobs, as in
the JAX package: RMSNorm, bias-free layers and a QKV-only bias (LLaMA,
Qwen2, Mixtral), GQA and MQA (``qkv_layout="concat"``), interleaved rotary
pairs (GPT-J), a gated FFN (SwiGLU: the gate's activation in its GEMM's
epilogue), an MoE FFN (``ops.moe.moe_ffn``: padding, idle pool rows and
inactive chunk rows hold no expert capacity) and learned absolute positions
added after the embedding at each token's absolute position (a chunk's
start and a prompt-learning offset included).

Tensor parallelism (``mesh``, ``parallel/``): every function takes this
rank's slice of the weights (``parallel.sharding.shard_params``) and runs
the kernels at the rank's widths: its heads, its FFN columns, its experts and
its vocab rows. The row-split products are partial sums, reduced by one
counted ``all_reduce`` a layer under the parallel residual (attention and
FFN partials together, as GptNeoXDecoder.cc:342-360) and by two in a serial
layer, after proj and after down (TensorParallelDecoderSelfAttentionLayer
.cc:214-222); the bias and the residual are added once, after the reduce, or
by rank 0 alone inside K3. ``lm_logits`` all-gathers the vocab slices
(GptNeoX.cc:888-925). A ``"concat"`` QKV is replicated: the rank computes
every head, keeps its own KV heads and their query heads where the KV heads
split over tp, and otherwise attends over all heads and keeps its own
query heads' outputs for its proj rows.

Pipeline parallelism (a mesh with ``pp > 1``): the params and the cache hold
this stage's L/pp layers; ``prefill``, ``decode_step`` and ``prefill_chunk``
run the embedding on the first stage, their stage's layers, and hand the
last stage's hidden to every stage through ``parallel.pipeline.pipe_loop``
(``microbatches`` of the sequence in prefill, of the rows in decode).

Routing (``fused=True``, ``RuntimeConfig.fused_decode``): a
parallel-residual layer whose four big kernels are quantized alike (one bit
width, one group size: int8, int4, or int4 with group scales) and which has
the summed bias runs ln1 and ln2 on x, then K13 (QKV and the activated up
projection in one launch: the GEMV at decode widths, the GEMM in prefill and
chunk ticks), rotary, the cache write and attention; then, in decode, K3
(proj + down + bias + residual), and in prefill the proj and down GEMMs.
Every activation of the port is admitted (exact gelu too: the CUDA epilogue
has erf). A gated or MoE FFN is not K13's act(x @ up) and never takes
the route. Any other layer, and every layer with ``fused=False``, runs
unfused GEMMs: K1 (int8), K6 (int4) or K7 (int4 group-wise). The JAX package
gates group-wise layers and the QKV + up merge out of its fused kernels by
measurements on a TPU; the port does not copy those gates.

With ``a8`` (``RuntimeConfig.act_int8``, SmoothQuant W8A8) every GEMM that
``ops.linear.a8_takes`` admits runs ``w8a8_matmul``: in prefill, chunk ticks
and verifies of at least 16 rows the layer gives up K13 and runs QKV, up,
proj and down unmerged, as the JAX package's prefill does; decode keeps
K13 + K3. ``prefill_chunk(embeds=)`` runs pre-embedded rows (soft prompts)
instead of the token lookup.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..core.config import GptNeoXConfig
from ..engine import kv_cache as kvc
from ..ops.attention import prefill_attention
from ..ops.layernorm import layernorm, rmsnorm
from ..ops.linear import a8_takes, linear, quantized_matmul_transposed_head
from ..ops.quant_matmul_fused import fused_proj_down, fused_qkv_up
from ..ops.rotary import apply_rotary, make_rotary_tables
from ..ops.moe import moe_ffn
from ..parallel.distributed import all_gather, all_reduce
from ..parallel.pipeline import pipe_loop
from ..parallel.sharding import cache_heads, local_heads, stage_layers
from .params import Params, QuantizedTensor, layer_slice

KVCache = dict

def _tp(mesh) -> bool:
    return mesh is not None and mesh.tp > 1


def _norm(config: GptNeoXConfig, x, w, b):
    if config.norm == "rmsnorm":
        return rmsnorm(x, w, config.layernorm_eps)
    return layernorm(x, w, b, config.layernorm_eps)


def _addb(x, b):
    return x if b is None else x + b.to(x.dtype)


def _quantized_alike(ws) -> bool:
    """Quantized kernels of one bit width and one group size."""
    return (all(isinstance(w, QuantizedTensor) for w in ws)
            and len({(w.bits, w.group_size) for w in ws}) == 1)


def _fused_ok(config: GptNeoXConfig, lp: Dict[str, Any]) -> bool:
    """The layer can run as K13 (qkv + up) then K3 (proj + down + bias +
    residual): K13's second segment is act(x @ up), so a gated or routed FFN
    cannot take it."""
    return (
        config.use_gptj_residual
        and not config.gated_ffn
        and not config.moe_experts
        and _quantized_alike([lp[k] for k in ("qkv_w", "up_w", "proj_w", "down_w")])
        and "down_b" in lp
    )


def _heads(config: GptNeoXConfig, qkv, cos, sin, mesh=None):
    """Fused QKV output [B, S, cols] -> q, k, v heads with rotary applied:
    the rank's heads (its column slice; of a replicated ``"concat"`` QKV, the
    KV heads its cache holds and their query heads)."""
    B, S, _ = qkv.shape
    dh = config.size_per_head
    if config.qkv_layout == "concat":
        nH, nKV = config.head_num, config.kv_heads
        q = qkv[..., : nH * dh].reshape(B, S, nH, dh)
        k = qkv[..., nH * dh : (nH + nKV) * dh].reshape(B, S, nKV, dh)
        v = qkv[..., (nH + nKV) * dh :].reshape(B, S, nKV, dh)
        lo, n = cache_heads(config, mesh)
        if n < nKV:
            g = nH // nKV
            q, k, v = q[:, :, lo * g:(lo + n) * g], k[:, :, lo:lo + n], v[:, :, lo:lo + n]
    else:
        nH = qkv.shape[-1] // (3 * dh)
        qkv = qkv.reshape(B, S, nH, 3, dh)
        q, k, v = qkv[:, :, :, 0], qkv[:, :, :, 1], qkv[:, :, :, 2]
    rot = config.rotary_embedding_dim
    q = apply_rotary(q, cos, sin, rot, config.rotary_style)
    k = apply_rotary(k, cos, sin, rot, config.rotary_style)
    return q, k, v


def _own_heads(config: GptNeoXConfig, mesh, attn):
    """Attention output [..., heads * dh] -> the rows of this rank's proj
    slice: a no-op unless the rank attended over every head (a replicated
    ``"concat"`` QKV whose KV heads do not split over tp)."""
    if not _tp(mesh) or attn.shape[-1] != config.hidden_size:
        return attn
    lo, n = local_heads(config, mesh)
    dh = config.size_per_head
    return attn[..., lo * dh:(lo + n) * dh].contiguous()


def _qkv(config: GptNeoXConfig, lp, x, cos, sin, a8=False, mesh=None):
    """ln1 output -> fused QKV -> heads -> rotary. x: [B, S, H]."""
    return _heads(config, linear(x, lp["qkv_w"], lp.get("qkv_b"), act_int8=a8), cos, sin, mesh)


def _attention_inputs(config: GptNeoXConfig, lp, x, cos, sin, fused, a8=False, mesh=None):
    """x [B, S, H] -> (q, k, v with rotary, h). On the fused route (``fused``
    and ``_fused_ok``, and no W8A8 call under ``a8``) K13 computes QKV from
    ln1(x) and the activated up projection h [B*S, F] from ln2(x) in one
    launch; elsewhere h is None and the FFN runs after attention."""
    B, S, H = x.shape
    ln1 = _norm(config, x, lp["ln1_w"], lp.get("ln1_b"))
    if not (fused and _fused_ok(config, lp)) or a8_takes(x, lp["qkv_w"], a8):
        return (*_qkv(config, lp, ln1, cos, sin, a8, mesh), None)
    ln2 = _norm(config, x, lp["ln2_w"], lp.get("ln2_b"))
    qkv_w, up_w = lp["qkv_w"], lp["up_w"]
    qkv, h = fused_qkv_up(ln1.reshape(B * S, H), ln2.reshape(B * S, H), qkv_w.q, up_w.q,
                          qkv_w.scale, up_w.scale, lp.get("qkv_b"), lp.get("up_b"),
                          act2=config.activation, bits=qkv_w.bits,
                          group_size=qkv_w.group_size)
    return (*_heads(config, qkv.reshape(B, S, -1), cos, sin, mesh), h)


def _ffn(config: GptNeoXConfig, lp, x, a8=False, token_valid=None, mesh=None):
    """The FFN of ln2's output x [B, S, H]; the down bias is added by the
    caller's residual. Dense: up with bias and activation, then down; gated
    (SwiGLU): act(x @ gate + gate_b) * (x @ up + up_b), then down, the
    activation in the gate's epilogue; MoE: ``ops.moe.moe_ffn`` over the
    B * S rows, ``token_valid`` [B, S] keeping padding and idle rows out of
    the experts' capacity. Under tp the result is the rank's partial sum (its
    FFN columns, or its experts)."""
    if config.moe_experts:
        B, S, H = x.shape
        n_local = lp["eup_w"].shape[0]
        y = moe_ffn(x.reshape(-1, H), lp["router_w"], lp.get("egate_w"), lp["eup_w"],
                    lp["edown_w"], config.moe_top_k, config.moe_capacity_factor,
                    act=config.activation,
                    valid=None if token_valid is None else token_valid.reshape(-1),
                    expert_offset=0 if mesh is None else mesh.tp_rank * n_local)
        return y.reshape(B, S, H)
    if config.gated_ffn:
        g = linear(x, lp["gate_w"], lp.get("gate_b"), act=config.activation, act_int8=a8)
        h = g * linear(x, lp["up_w"], lp.get("up_b"), act_int8=a8)
    else:
        h = linear(x, lp["up_w"], lp.get("up_b"), act=config.activation, act_int8=a8)
    return linear(h, lp["down_w"], act_int8=a8)


def _residual(config, lp, x, attn_out, h=None, a8=False, token_valid=None, mesh=None):
    """The block output from its input x and the projected attention; ``h``:
    the activated up projection the fused route already computed;
    ``token_valid``: the rows an MoE FFN routes. Under tp, one all-reduce of
    the attention and FFN partials (parallel residual) or one after each
    (serial), the biases added after it."""
    if config.use_gptj_residual:
        if h is None:
            ffn = _ffn(config, lp, _norm(config, x, lp["ln2_w"], lp.get("ln2_b")), a8,
                       token_valid, mesh)
        else:
            ffn = linear(h.reshape(x.shape[:-1] + h.shape[-1:]), lp["down_w"], act_int8=a8)
        if _tp(mesh):
            return _addb(x + all_reduce(attn_out + ffn, mesh), lp.get("down_b"))
        return _addb(x + attn_out + ffn, lp.get("down_b"))
    h = _addb(x + all_reduce(attn_out, mesh), lp.get("proj_b"))
    ln2 = _norm(config, h, lp["ln2_w"], lp.get("ln2_b"))
    return _addb(h + all_reduce(_ffn(config, lp, ln2, a8, token_valid, mesh), mesh),
                 lp.get("down_b"))


def block_prefill(config, lp, x, cache, layer, cos, sin, input_lengths, fused=True, a8=False,
                  mesh=None):
    """x [B, S, H]; cos/sin [S, rot/2]; input_lengths [B] int32. Fills cache
    [0, S). Attention is K5 on CUDA (no [B, S, S] mask is built there), the
    plain causal, length-masked math on the CPU. ``fused``: QKV and up by
    K13's GEMM form where the layer allows; proj and down stay GEMMs.
    ``a8``: W8A8 GEMMs where ``a8_takes``."""
    B, S, H = x.shape
    sm_scale = 1.0 / (config.size_per_head ** 0.5)
    q, k, v, h = _attention_inputs(config, lp, x, cos, sin, fused, a8, mesh)
    kvc.write_prefill(cache, layer, k, v)
    attn = prefill_attention(q, k, v, None, sm_scale, input_lengths)
    attn = _own_heads(config, mesh, attn.reshape(B, S, -1))
    attn_out = linear(attn, lp["proj_w"], act_int8=a8)
    tv = None
    if config.moe_experts:  # padding stays out of the experts' capacity
        tv = torch.arange(S, device=x.device)[None, :] < input_lengths[:, None]
    return _residual(config, lp, x, attn_out, h, a8, tv, mesh), cache


def block_decode(config, lp, x, cache, layer, cos, sin, positions, kv_skip=None,
                 kv_skip_mode="preserve", beam=None, fused=True, mesh=None):
    """x [B, 1, H], the newest token per row; cos/sin [B, 1, rot/2];
    positions [B] int32, the slot of each row's new token; ``kv_skip`` [B]
    bool rows whose cache write must not disturb readable state
    (``kv_cache.write_decode``); ``beam`` (bw, indir) reads the cache
    through the beam indirection (K11); ``fused`` allows the K13 + K3
    route. Under tp, K3 takes the bias and the residual on rank 0 only and
    its output is all-reduced."""
    B = x.shape[0]
    sm_scale = 1.0 / (config.size_per_head ** 0.5)
    q, k, v, h = _attention_inputs(config, lp, x, cos, sin, fused, mesh=mesh)
    kvc.write_decode(cache, layer, k, v, positions, skip=kv_skip, skip_mode=kv_skip_mode)
    attn = kvc.attend_decode(cache, layer, q[:, 0].contiguous(), sm_scale, positions, beam=beam)
    attn = _own_heads(config, mesh, attn.reshape(B, -1))
    if h is not None:
        proj, down = lp["proj_w"], lp["down_w"]
        bias, res = lp["down_b"], x[:, 0]
        if _tp(mesh) and mesh.tp_rank:
            bias, res = torch.zeros_like(bias), torch.zeros_like(res)
        out = fused_proj_down(attn, h, proj.q, down.q, proj.scale, down.scale, bias, res,
                              bits=proj.bits, group_size=proj.group_size)
        return all_reduce(out, mesh)[:, None, :], cache
    attn_out = linear(attn[:, None, :], lp["proj_w"])
    tv = None
    if config.moe_experts and kv_skip is not None:  # idle pool rows route nowhere
        tv = (~kv_skip)[:, None]
    return _residual(config, lp, x, attn_out, token_valid=tv, mesh=mesh), cache


def block_prefill_chunk(config, lp, x, cache, layer, cos, sin, pos, valid, active, fused=True,
                        a8=False, mesh=None):
    """Chunked prefill block. x [B, C, H], C consecutive prompt tokens per
    row; cos/sin [B, C, rot/2]; pos [B] int32 chunk start slots; valid
    [B, C, S] keys visible to each query (the dense cache's mask); active [B]
    rows really prefilling (the others keep their cache bytes). The chunk
    attends over the already-filled cache: K10 on a paged cache. Its GEMMs
    run at M = B * C (QKV and up as one K13 launch where ``fused``; W8A8
    where ``a8`` and ``a8_takes``)."""
    B, C, H = x.shape
    sm_scale = 1.0 / (config.size_per_head ** 0.5)
    q, k, v, h = _attention_inputs(config, lp, x, cos, sin, fused, a8, mesh)
    kvc.write_chunk(cache, layer, k, v, pos, active)
    attn = kvc.attend_chunk(cache, layer, q, valid, sm_scale, positions=pos)
    attn = _own_heads(config, mesh, attn.reshape(B, C, -1))
    attn_out = linear(attn, lp["proj_w"], act_int8=a8)
    tv = active[:, None].expand(B, C) if config.moe_experts else None
    return _residual(config, lp, x, attn_out, h, a8, tv, mesh), cache


def _embed_lookup(params: Params, ids: torch.Tensor) -> torch.Tensor:
    """Token embedding gather; int8 embeddings carry per-row scales."""
    e = params["embed"]
    if isinstance(e, QuantizedTensor):
        x = e.q[ids].float() * e.scale[ids].float()[..., None]
        return x.to(params["final_ln_w"].dtype)
    return e[ids]


def _add_pos_embed(config: GptNeoXConfig, params: Params, x, positions, bound: int):
    """Add the learned absolute position rows (GPT-2, OPT, StarCoder) at
    ``positions`` ([S] shared by the batch, or [B, S]); ``bound``: the most
    positions this call's cache holds, which the table must cover (the JAX
    package asserts it: a gather past the table would clamp to its last
    row)."""
    if config.position_embedding != "learned":
        return x
    table = params["pos_embed"]
    if bound > table.shape[0]:
        raise ValueError(
            f"a cache of {bound} positions exceeds the learned position table "
            f"({table.shape[0]} rows): this model cannot serve contexts beyond its trained "
            "n_positions")
    pe = table[positions]
    if pe.ndim == x.ndim - 1:  # [S, H] shared across the batch
        pe = pe[None]
    return x + pe.to(x.dtype)


def _stage_layer_count(config: GptNeoXConfig, mesh) -> int:
    """The layers this rank runs: its pipeline stage's block (all of them
    without a pp axis); the params and the cache hold just these."""
    return stage_layers(config, mesh)[1]


def _act_dtype(params: Params):
    return params["final_ln_w"].dtype


def _chunk_positions(pos: torch.Tensor, C: int, S: int) -> torch.Tensor:
    """[B, C] slots of a chunk starting at ``pos`` [B], clamped to the cache."""
    return torch.clamp(pos.long()[:, None] + torch.arange(C, device=pos.device)[None, :], 0,
                       S - 1)


def _chunk_layers(config, params, x, cache, pos, posc, rotary_tables, active, fused, a8, mesh):
    """This stage's layers over one chunk (x [B, C, H]) at per-row offsets
    ``pos``, its slots ``posc``: the query at slot p sees keys at slots <= p."""
    cos_t, sin_t = rotary_tables
    cos, sin = cos_t[posc], sin_t[posc]  # [B, C, rot/2]
    S = kvc.seq_len_of(cache)
    valid = torch.arange(S, device=x.device)[None, None, :] <= posc[:, :, None]  # [B, C, S]
    layers = params["layers"]
    for l in range(_stage_layer_count(config, mesh)):
        x, cache = block_prefill_chunk(config, layer_slice(layers, l), x, cache, l, cos, sin,
                                       pos, valid, active, fused, a8, mesh)
    return x


def prefill(
    config: GptNeoXConfig,
    params: Params,
    input_ids: torch.Tensor,  # [B, S] right-padded
    input_lengths: torch.Tensor,  # [B]
    cache: KVCache,
    fused: bool = True,
    a8: bool = False,
    mesh=None,
    microbatches: int = 1,
) -> Tuple[torch.Tensor, KVCache]:
    """Full-prompt forward: (hidden [B, S, H], cache with [0, S) filled).
    ``fused``: QKV and up through K13 (``RuntimeConfig.fused_decode``);
    ``a8``: W8A8 GEMMs (``RuntimeConfig.act_int8``); ``mesh``: this rank's
    place under tensor and pipeline parallelism, ``params`` and ``cache``
    its slice (a pp stage holds its L/pp layers and every stage returns the
    last stage's hidden, ``parallel.pipeline``). ``microbatches`` M > 1
    pipelines the sequence as M chunks through ``block_prefill_chunk``:
    every query at a real position sees what the whole-prompt mask shows it
    (padding follows the real tokens) and the padded queries' outputs are
    never read. M = 1 runs the whole prompt through ``block_prefill`` (K5)."""
    B, S = input_ids.shape
    dev = input_ids.device
    M = int(microbatches)
    if S % M:
        raise ValueError(f"prefill width {S} does not split into {M} microbatches")
    C = S // M
    if M == 1:
        cos, sin = make_rotary_tables(S, config.rotary_embedding_dim, config.rotary_base, dev)
        layers = params["layers"]

        def embed(m):
            x = _embed_lookup(params, input_ids)
            return _add_pos_embed(config, params, x, torch.arange(S, device=dev), bound=S)

        def stack(x, m):
            for l in range(_stage_layer_count(config, mesh)):
                x, _ = block_prefill(config, layer_slice(layers, l), x, cache, l, cos, sin,
                                     input_lengths, fused, a8, mesh)
            return x
    else:
        S_cache = kvc.seq_len_of(cache)
        rotary = make_rotary_tables(S_cache, config.rotary_embedding_dim, config.rotary_base,
                                    dev)
        active = torch.ones(B, dtype=torch.bool, device=dev)

        def start(m):
            return torch.full((B,), m * C, dtype=torch.int32, device=dev)

        def embed(m):
            x = _embed_lookup(params, input_ids[:, m * C:(m + 1) * C])
            return _add_pos_embed(config, params, x, _chunk_positions(start(m), C, S_cache),
                                  bound=S_cache)

        def stack(x, m):
            pos = start(m)
            return _chunk_layers(config, params, x, cache, pos, _chunk_positions(pos, C, S_cache),
                                 rotary, active, fused, a8, mesh)
    out = pipe_loop(mesh, M, embed, stack, (B, C, config.hidden_size), _act_dtype(params), dev)
    return (out[0] if M == 1 else out.permute(1, 0, 2, 3).reshape(B, S, -1)), cache


def _rows(cache: KVCache, r0: int, n: int) -> KVCache:
    """Rows [r0, r0 + n) of every slab of a dense cache, as views (the
    blocks' in-place writes land in the whole cache)."""
    return {k: v.narrow(1, r0, n) for k, v in cache.items()}


def decode_step(
    config: GptNeoXConfig,
    params: Params,
    tokens: torch.Tensor,  # [B] newest token ids
    positions: torch.Tensor,  # [B] int32 slot / rotary position of each new token
    cache: KVCache,
    rotary_tables=None,
    kv_skip=None,
    kv_skip_mode: str = "preserve",
    beam=None,
    fused: bool = True,
    mesh=None,
    microbatches: int = 1,
) -> Tuple[torch.Tensor, KVCache]:
    """One incremental decode step: (hidden [B, H], cache). ``kv_skip`` rows
    write their (discarded) token where readable state stays intact
    (``kv_cache.write_decode``). ``beam`` = (bw, indir [B, S] int32): the
    rows are beam-minor hypotheses whose attention resolves the cache
    indirection (the beam search's fixed cache). ``fused`` allows the K13 +
    K3 route (``RuntimeConfig.fused_decode``). Under pp (``mesh``),
    ``microbatches`` M splits the rows of a dense cache into M groups
    pipelined across the stages; with ``beam`` a group holds whole beam
    groups."""
    B = tokens.shape[0]
    M = int(microbatches)
    if B % M:
        raise ValueError(f"batch {B} does not split into {M} microbatches")
    mb = B // M
    if beam is not None and mb % beam[0]:
        raise ValueError(f"a microbatch of {mb} rows splits beam groups of {beam[0]}")
    cache_len = kvc.seq_len_of(cache)
    if rotary_tables is None:
        rotary_tables = make_rotary_tables(
            cache_len, config.rotary_embedding_dim, config.rotary_base, tokens.device
        )
    cos_t, sin_t = rotary_tables
    layers = params["layers"]

    def embed(m):
        r = slice(m * mb, (m + 1) * mb)
        x = _embed_lookup(params, tokens[r])[:, None, :]
        return _add_pos_embed(config, params, x, positions[r].long()[:, None], bound=cache_len)

    def stack(x, m):
        r0 = m * mb
        pos = positions[r0:r0 + mb]
        cos, sin = cos_t[pos][:, None, :], sin_t[pos][:, None, :]
        beam_m = None if beam is None else (beam[0], beam[1][r0:r0 + mb])
        skip = None if kv_skip is None else kv_skip[r0:r0 + mb]
        c = cache if M == 1 else _rows(cache, r0, mb)
        for l in range(_stage_layer_count(config, mesh)):
            x, c = block_decode(config, layer_slice(layers, l), x, c, l, cos, sin, pos, skip,
                                kv_skip_mode, beam_m, fused, mesh)
        return x

    out = pipe_loop(mesh, M, embed, stack, (mb, 1, config.hidden_size), _act_dtype(params),
                    tokens.device)
    return out.reshape(B, -1), cache


def prefill_chunk(
    config: GptNeoXConfig,
    params: Params,
    tokens_chunk: torch.Tensor,  # [B, C] this tick's chunk per row
    pos: torch.Tensor,  # [B] int32 chunk start (pos + C <= the cache's slots)
    cache: KVCache,
    active: torch.Tensor,  # [B] bool rows mid-prefill
    rotary_tables=None,
    fused: bool = True,
    a8: bool = False,
    embeds: torch.Tensor = None,  # [B, C, H] pre-embedded rows (soft prompts)
    mesh=None,
) -> Tuple[torch.Tensor, KVCache]:
    """One chunked-prefill step over the layer stack: fills cache positions
    [pos, pos + C) of active rows and keeps the other rows' bytes. Returns
    (hidden [B, C, H], cache). ``fused``: QKV and up through K13; ``a8``:
    W8A8 GEMMs; ``embeds``: the chunk's embeddings, in place of the token
    lookup (``tokens_chunk`` then only gives C). Under pp the one chunk runs
    through the stages serially."""
    B, C = tokens_chunk.shape
    S = kvc.seq_len_of(cache)
    dev = tokens_chunk.device
    if rotary_tables is None:
        rotary_tables = make_rotary_tables(S, config.rotary_embedding_dim, config.rotary_base, dev)
    posc = _chunk_positions(pos, C, S)

    def embed(m):
        x = _embed_lookup(params, tokens_chunk) if embeds is None else embeds
        return _add_pos_embed(config, params, x, posc, bound=S)

    def stack(x, m):
        return _chunk_layers(config, params, x, cache, pos, posc, rotary_tables, active, fused,
                             a8, mesh)

    out = pipe_loop(mesh, 1, embed, stack, (B, C, config.hidden_size), _act_dtype(params), dev)
    return out[0], cache


def final_norm(config: GptNeoXConfig, params: Params, hidden):
    return _norm(config, hidden, params["final_ln_w"], params.get("final_ln_b"))


def lm_logits(config: GptNeoXConfig, params: Params, hidden: torch.Tensor,
              mesh=None) -> torch.Tensor:
    """fp32 logits, padded vocab ids sliced off, plus ``lm_head_b`` where the
    family has one (GPT-J). The transposed int4 head [H/2, V_pad] (k_axis 0)
    goes to K8; the int8 [V, H] head with per-row scales, or a dense head, is
    a plain fp32 matmul, as the JAX package leaves it to XLA; a group-wise
    [V, H] head (scales [V, H/G]) multiplies the dequantized weight, its
    group scales folded in. Under tp each
    rank computes its vocab slice (with its slice of ``lm_head_b``) and one
    ``all_gather`` joins them, so every rank holds the same logits."""
    h = final_norm(config, params, hidden)
    h2 = h.reshape(-1, h.shape[-1])
    w = params["lm_head"]
    if isinstance(w, QuantizedTensor) and w.k_axis % w.q.ndim == 0:
        logits = quantized_matmul_transposed_head(h2, w)
    elif isinstance(w, QuantizedTensor):
        if w.bits != 8:
            raise NotImplementedError("a [V, H] head is served in int8 only")
        if w.group_size:  # the group scales sit inside the contraction
            logits = h2.float() @ w.dequantize().t()
        else:
            logits = (h2.float() @ w.q.t().float()) * w.scale.float()[None, :]
    else:
        logits = h2.float() @ w.t().float()
    if "lm_head_b" in params:  # GPT-J's head carries a bias
        b = params["lm_head_b"].float()  # [V], or this rank's slice of the padded vocab
        logits = logits[:, : b.shape[0]] + b[None, :]
    if _tp(mesh):
        logits = all_gather(logits, mesh)
    logits = logits[:, : config.vocab_size]
    return logits.reshape(h.shape[:-1] + (config.vocab_size,))


def last_token_hidden(hidden: torch.Tensor, input_lengths: torch.Tensor) -> torch.Tensor:
    """Hidden state of each sequence's last real token."""
    idx = torch.clamp(input_lengths.long() - 1, 0, hidden.shape[1] - 1)
    return hidden[torch.arange(hidden.shape[0], device=hidden.device), idx]
