"""Process groups, the port's mesh and its counted collectives (port of
parallel/distributed.py).

The JAX package joins a multi-host runtime with ``jax.distributed.initialize``
and lets GSPMD place every collective. Here each rank is a process of
``torch.distributed``, as in the reference (MPI ranks with NCCL communicators,
or communicators taken from PyTorch's c10d process group:
``th_op/gptneox/utils/nccl_inherit_utils.cc:8-68``), and the model writes its
collectives out: ``all_reduce`` over the tp group after the row-split
projections, ``all_gather`` of the vocab-split logits, and under pipeline
parallelism ``send_next`` / ``recv_prev`` at the stage edges and one
``broadcast_last`` of the last stage's hidden a forward
(``parallel/pipeline.py``). Each call adds one to its wrapper's ``calls``,
so a test or ``chip_smoke.py`` can count them as the JAX tests count the
psums and collective-permutes of a compiled program.

Backends: NCCL where each rank has a card of its own, gloo on the CPU and
for several ranks on one card (NCCL refuses two ranks on one device; gloo
reduces CUDA tensors through host copies). gloo's point-to-point transport
reads host memory only, so under gloo a CUDA tensor's hop and broadcast go
through a host copy (``_wire``).
"""
from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist


@dataclasses.dataclass
class Mesh:
    """This rank's place in a (dp, pp, tp) layout: the tp group splits every
    layer's heads, FFN columns and vocab over ``tp`` ranks; the pp group
    splits the layer stack into ``pp`` contiguous blocks, one a stage; the dp
    groups split a batch's rows. ``tp_group`` / ``pp_group`` / ``dp_group``
    are the ``torch.distributed`` groups of the ranks that differ from this
    one in that coordinate only (None where the axis has one rank);
    ``pp_ranks`` the global ranks of the pp group, stage by stage. A Mesh
    without groups still shards parameters (``sharding.shard_params``). The
    device is the params': the engines serve where their weights lie."""

    tp: int = 1
    dp: int = 1
    tp_rank: int = 0
    dp_rank: int = 0
    tp_group: Any = None
    dp_group: Any = None
    pp: int = 1
    pp_rank: int = 0
    pp_group: Any = None
    pp_ranks: Tuple[int, ...] = ()


def default_backend(device, num_processes: int) -> str:
    """NCCL for ranks serving on a CUDA device with a card each, gloo
    otherwise: on the CPU, or for several ranks on one card (NCCL refuses
    two ranks on one device). ``device`` None is the card, as the port's
    entry points default."""
    dev = torch.device(device if device is not None else "cuda")
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return "nccl" if dev.type == "cuda" and cards >= num_processes else "gloo"


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device=None,
    timeout_s: float = 600.0,
) -> int:
    """Join the process group and return this rank. An existing default
    group (``torchrun`` with a script that built it, or a caller's own c10d
    group) is taken as it is. Otherwise ``coordinator_address``
    ("host:port"), ``num_processes`` and ``process_id`` give the rendezvous,
    as the JAX function's arguments do; without them it is the env://
    rendezvous ``torchrun`` sets (MASTER_ADDR, MASTER_PORT, WORLD_SIZE,
    RANK). ``backend`` defaults to ``default_backend(device, ...)``, with
    ``device`` the one this rank serves on."""
    if dist.is_initialized():
        return dist.get_rank()
    if coordinator_address is None and "MASTER_ADDR" not in os.environ:
        raise ValueError("no process group to join: run under torchrun --nproc_per_node N, or "
                         "give the coordinator's address, the number of processes and this "
                         "process's rank")
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(os.environ.get("RANK", "0"))
    if backend is None:
        backend = default_backend(device, num_processes)
    init = (f"tcp://{coordinator_address}" if coordinator_address else "env://")
    dist.init_process_group(backend, init_method=init, world_size=num_processes,
                            rank=process_id, timeout=datetime.timedelta(seconds=timeout_s))
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", process_id)))
    return process_id


def build_pod_mesh(tp: Optional[int] = None, dp: Optional[int] = None) -> Mesh:
    """The mesh over every rank of the process group: by default tp spans
    the ranks and dp is what is left, the JAX default of tp over one host's
    chips and dp over hosts when the group is one host's."""
    from .sharding import build_mesh

    n = dist.get_world_size() if dist.is_initialized() else 1
    if tp is None:
        tp = n // (dp or 1)
    if dp is None:
        dp = n // tp
    return build_mesh(tp=tp, dp=dp)


def all_reduce(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The sum of ``x`` over the tp group, in place; one counted call. A
    row-split product's partial sum: without a tp group (no mesh, or tp 1)
    ``x`` is already whole and is returned as it is, uncounted."""
    if mesh is None or mesh.tp == 1:
        return x
    dist.all_reduce(x, group=mesh.tp_group)
    all_reduce.calls += 1
    return x


def all_gather(x: torch.Tensor, mesh: Mesh, dim: int = -1) -> torch.Tensor:
    """The tp group's ``x`` joined along ``dim`` in rank order; one counted
    call."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.tp)]
    dist.all_gather(parts, x, group=mesh.tp_group)
    all_gather.calls += 1
    return torch.cat(parts, dim=dim)


def _gloo(group) -> bool:
    return dist.get_backend(group) == "gloo"


def _wire(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` as the group's backend moves it: a host copy of a CUDA tensor
    under gloo, whose point-to-point transport reads host memory only."""
    t = t.contiguous()
    return t.cpu() if t.is_cuda and _gloo(group) else t


def _landing(shape, dtype, device, group) -> torch.Tensor:
    """A receive buffer where the group's backend writes: on the host under
    gloo, on ``device`` otherwise."""
    return torch.empty(shape, dtype=dtype, device="cpu" if _gloo(group) else device)


def send_next(x: torch.Tensor, mesh: Mesh) -> None:
    """Send ``x`` to the next stage of the pp group (the same tp and dp
    coordinates); one counted hop. Blocks until the next stage takes it."""
    dist.send(_wire(x, mesh.pp_group), dst=mesh.pp_ranks[mesh.pp_rank + 1],
              group=mesh.pp_group)
    send_next.calls += 1


def recv_prev(shape, dtype, mesh: Mesh, device) -> torch.Tensor:
    """The tensor the previous stage sends (``send_next``), on ``device``;
    one counted hop."""
    buf = _landing(shape, dtype, device, mesh.pp_group)
    dist.recv(buf, src=mesh.pp_ranks[mesh.pp_rank - 1], group=mesh.pp_group)
    recv_prev.calls += 1
    return buf.to(device)


def broadcast_last(x: Optional[torch.Tensor], shape, dtype, mesh: Mesh, device) -> torch.Tensor:
    """The last stage's ``x`` on every stage of the pp group (the other
    stages pass None and get a tensor of ``shape`` and ``dtype`` on
    ``device``); one counted call."""
    last = mesh.pp_rank == mesh.pp - 1
    buf = _wire(x, mesh.pp_group) if last else _landing(shape, dtype, device, mesh.pp_group)
    dist.broadcast(buf, src=mesh.pp_ranks[-1], group=mesh.pp_group)
    broadcast_last.calls += 1
    return x if last else buf.to(device)


all_reduce.calls = 0
all_gather.calls = 0
send_next.calls = 0
recv_prev.calls = 0
broadcast_last.calls = 0


def gather_rows(obj, mesh: Mesh) -> list:
    """Every dp group's ``obj`` (any picklable host value), in dp order."""
    out = [None] * mesh.dp
    dist.all_gather_object(out, obj, group=mesh.dp_group)
    return out
