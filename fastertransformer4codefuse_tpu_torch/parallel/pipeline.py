"""Pipeline parallelism: the layer stack split into contiguous blocks over
the ranks of a pp group (port of parallel/pipeline.py).

The reference's scheme (GptNeoXDecoder.cc:94-120 contiguous layers a rank,
:252-265 / :372-383 activations handed over at the stage edges,
GptNeoX.cc:780-788 microbatches through getLocalBatchSize,
GptNeoX.cc:998-1021 the broadcast at the end of a step), as the JAX package
lays it out:

  - the stacked layer weights and the KV cache hold this stage's L/pp layers
    (``sharding.shard_params``, ``sharding.stage_layers``); the cache is
    indexed by local layer numbers. Under tp each stage's tp group runs the
    model's all-reduces inside the stage, as without pp;
  - ``pipe_loop`` (the JAX ``_pipe_loop``) drives the stages with
    microbatches: at tick t stage s runs microbatch m = t - s, over
    M + pp - 1 ticks, so stage s runs m while stage s - 1 runs m + 1. Stage
    0 embeds its input, every other stage receives it from the stage before
    (``recv_prev``) and sends its output on (``send_next``): one counted hop
    a microbatch an edge. Where the JAX loop wraps the finished microbatches
    around the ring to stage 0 and psums them, the last stage here holds
    them and one ``broadcast_last`` a forward gives them to every stage.

The forwards are the model's own (``models.gptneox.prefill``,
``decode_step``, ``prefill_chunk``): each splits itself into the embedding
and its stage's layers and hands both to ``pipe_loop``, which without a pp
axis is the plain loop. ``prefill`` with M > 1 splits the SEQUENCE into M
chunks through ``block_prefill_chunk`` (chunk m attends only to positions
its own stage wrote at earlier ticks, so the stages need no cache copies);
with M = 1 the whole prompt runs through ``block_prefill`` (K5).
``decode_step`` splits the BATCH ROWS into M groups, each a view of its
rows of the cache (the reference's getLocalBatchSize); at small batch
decode is bound by the weight bytes and M > 1 streams each stage's weights
once a microbatch. ``prefill_chunk`` (prompt learning, the pool's chunk
ticks) runs its one chunk serially.

The head and sampling run outside, on every rank, on the broadcast hidden:
each stage computes the same logits from the same bytes, so no token is
broadcast. The chain is linear (receive from s - 1, compute, send to
s + 1), so blocking hops cannot deadlock. Nothing here launches a kernel of
its own: a stage's layers run the model's kernels at its widths.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from .distributed import Mesh, broadcast_last, recv_prev, send_next


def pipe_loop(mesh: Optional[Mesh], M: int, embed: Callable[[int], torch.Tensor],
              layers: Callable[[torch.Tensor, int], torch.Tensor], shape, dtype,
              device) -> torch.Tensor:
    """The microbatched schedule (see the module docstring). ``embed(m)``:
    microbatch m's input to the first stage; ``layers(x, m)``: this stage's
    layers on it; ``shape``: one microbatch's activation. Returns the
    finished microbatches [M, *shape] on every stage of the pp group."""
    pp = 1 if mesh is None else mesh.pp
    if pp == 1:
        done = [layers(embed(m), m) for m in range(M)]
        return done[0][None] if M == 1 else torch.stack(done)
    stage = mesh.pp_rank
    done = []
    for t in range(M + pp - 1):
        m = t - stage
        if not 0 <= m < M:
            continue  # ramp-up or ramp-down: this stage idles at tick t
        x = embed(m) if stage == 0 else recv_prev(shape, dtype, mesh, device)
        y = layers(x, m)
        if stage < pp - 1:
            send_next(y, mesh)
        else:
            done.append(y)
    out = torch.stack(done) if done else None
    return broadcast_last(out, (M, *shape), dtype, mesh, device)


def microbatches(mesh: Optional[Mesh], requested: int, n: int, group: int = 1) -> int:
    """The microbatch count of a forward over ``n`` rows or positions:
    ``requested`` (``RuntimeConfig.pp_microbatches``) where the mesh has a pp
    axis and it splits ``n`` into whole groups of ``group`` (a beam's
    hypotheses stay in one microbatch), else 1, as the JAX engine falls
    back."""
    M = int(requested)
    if mesh is None or mesh.pp == 1 or n % M or (n // M) % group:
        return 1
    return M
