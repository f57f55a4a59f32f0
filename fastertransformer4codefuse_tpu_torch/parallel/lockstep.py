"""The driver of every threaded front end, and lockstep serving over the
ranks of a mesh (the port's own: it stands in for the JAX package's single
controller).

The JAX package serves a sharded engine from one process: its threaded front
ends admit requests in one order, and GSPMD places every collective of a
tick. The port's ranks are processes, and a rank whose driver thread admitted
in its own arrival order would run other collectives than its peers. So a
front end serves in rounds (``Rounds``). Global rank 0, the leader, alone
takes clients. Each round it publishes a list of commands (admit a request
under its uid, run a static request, run an encoder batch, close) over a gloo
group of all ranks made for control, which keeps the pickled commands on the
host and off an NCCL group; every rank, the leader included, applies them in
order and then runs the same ticks. So one thread a rank (the leader's
driver thread, a follower's ``follow``) issues every collective.
``publish.calls`` counts the rounds published, as ``parallel.distributed``
counts its collectives. Without a group (one rank, or a mesh whose ticks run
no collective) the same rounds run on the driver thread, and publishing and
agreeing are local.

Which meshes serve over the group (``serves_in_lockstep``): one with more
than one rank on tp or pp, whose ticks run collectives. A pool's state is its
own on each dp group, so on a dp-only mesh each rank serves its own clients;
but the handler's static route splits a batch's rows over dp, so a handler
leads from rank 0 there too, and every dp group serves rank 0's requests.

Two hazards, and what the rounds do about them:
- An idle follower waits in the round's broadcast. The leader publishes an
  empty round (a heartbeat) every quarter of the control group's timeout,
  so that wait never runs into it.
- An error on any rank ends serving on every rank. After applying a
  round's commands (all of them, even after one failed) the ranks take a
  min all-reduce on the control group of an ok flag and of the number of
  requests that failed (a request whose own error went to its caller),
  which must be the same on every rank; only then do they tick. A command
  that failed on one rank so stops every rank before the tick's
  collectives. A rank that fails inside a tick leaves its peers
  in the tick's collectives until the data group's timeout; they then fail
  too, and the next round's all-reduce stops them all. The leader's front
  end then tells its waiters.
"""
from __future__ import annotations

import datetime
import threading
import time
from typing import Callable, List, Optional, Tuple

import torch
import torch.distributed as dist

# seconds the control group waits for a rank; the leader's heartbeat comes
# every quarter of it
CONTROL_TIMEOUT_S = 300.0
CLOSE = "close"


def serves_in_lockstep(mesh, dp: bool = False) -> bool:
    """Whether a front end over an engine on ``mesh`` serves over the process
    group: a mesh with more than one rank on tp or pp (with ``dp``, on dp
    too). Such a mesh needs its process group."""
    if mesh is None or max(mesh.tp, mesh.pp, mesh.dp if dp else 1) == 1:
        return False
    if not dist.is_initialized():
        raise ValueError(
            f"a mesh of tp {mesh.tp} x pp {mesh.pp} x dp {mesh.dp} serves over its process group: "
            "run every rank under torchrun --nproc_per_node N (or init_distributed)")
    return True


def publish(commands: Optional[list], group) -> list:
    """The leader's ``commands`` on every rank of ``group`` (the others pass
    None); one counted call."""
    box = [commands]
    dist.broadcast_object_list(box, src=0, group=group)
    publish.calls += 1
    return box[0]


publish.calls = 0


def agree(ok: bool, failed: int, group) -> bool:
    """Whether every rank of ``group`` ended the round ``ok`` with the same
    number of ``failed`` requests."""
    t = torch.tensor([int(ok), failed, -failed], dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=group)
    return bool(t[0]) and int(t[1]) == -int(t[2])


class Rounds:
    """A front end's rounds: over every rank of the process group where
    ``over_group`` (every rank builds it at the same point, since it makes
    the control group), else on this process alone.

    The front end gives: ``collect()``, the leader's next commands from its
    mailbox as (command, local) pairs, where the command is published and
    ``local`` (a waiter, callbacks) stays on the leader; ``apply(command,
    local)``, which runs a command on every rank (``local`` None on a
    follower) and returns whether it failed a request, telling its caller;
    ``tick()``, the round's work after the commands; ``busy()``, whether a
    tick has work without new commands; and ``fail(error)``, which tells
    the leader's waiters that serving ended in ``error``.

    On the leader the rounds run on a driver thread from construction on; a
    follower runs them in ``follow``. ``rounds`` counts the rounds run,
    ``control_s`` is the last round's seconds in publishing and agreeing,
    ``error`` is what ended them."""

    def __init__(self, collect: Callable[[], List[Tuple[object, object]]],
                 apply: Callable[[object, object], bool], tick: Callable[[], None],
                 busy: Callable[[], bool], fail: Callable[[BaseException], None], name: str,
                 over_group: bool = False):
        timeout_s = CONTROL_TIMEOUT_S
        self.group = (dist.new_group(backend="gloo", timeout=datetime.timedelta(seconds=timeout_s))
                      if over_group else None)
        self.leader = self.group is None or dist.get_rank() == 0
        self.heartbeat_s = timeout_s / 4 if over_group else None
        self.rounds = 0
        self.control_s = 0.0
        self.error: Optional[BaseException] = None
        self._collect, self._apply, self._tick, self._busy, self._fail = (
            collect, apply, tick, busy, fail)
        self._wake = threading.Event()
        self._closing = False
        self._tick_error: Optional[Exception] = None
        self._thread = None
        if self.leader:
            self._thread = threading.Thread(target=self._serve, name=name, daemon=True)
            self._thread.start()

    def check_leader(self) -> None:
        """Raise on a follower: only the leader takes requests."""
        if not self.leader:
            raise RuntimeError(f"rank {dist.get_rank()} follows rank 0, which alone takes "
                               "requests: call follow() here")

    def wake(self) -> None:
        """Tell the leader's driver that its mailbox has work."""
        self._wake.set()

    def close(self, timeout: float = 60.0) -> None:
        """The leader: run a closing round (after which every rank stops)
        and wait for the driver. A follower: nothing (``follow`` returns at
        that round)."""
        if not self.leader:
            return
        self._closing = True
        self._wake.set()
        self._thread.join(timeout)

    def follow(self) -> None:
        """A follower: run the leader's rounds until it closes. Raises
        ``RuntimeError("pool driver died")`` where serving ended in an
        error."""
        if self.group is None:
            raise RuntimeError("only a front end over a mesh of several ranks follows rank 0")
        if self.leader:
            raise RuntimeError("rank 0 leads: it takes the requests, the other ranks follow")
        self._serve()
        if self.error is not None:
            raise RuntimeError("pool driver died") from self.error

    def _next(self) -> List[Tuple[object, object]]:
        """The leader's next round: what its mailbox holds once there is
        work, or over a group nothing (a heartbeat) after ``heartbeat_s``
        idle; the closing command last."""
        deadline = None if self.heartbeat_s is None else time.monotonic() + self.heartbeat_s
        while True:
            self._wake.clear()
            closing = self._closing
            todo = list(self._collect())
            if closing:
                return todo + [(CLOSE, None)]
            if todo or self._busy() or self._tick_error is not None:
                return todo
            left = None if deadline is None else deadline - time.monotonic()
            if left is not None and left <= 0:
                return todo
            self._wake.wait(left)

    def _serve(self) -> None:
        try:
            with torch.inference_mode():
                while self._round():
                    pass
            if self.group is not None:
                # every rank is past the closing round: release the group
                # here, not at exit, where its gloo threads could outlive the
                # process's teardown (seen as an abort under load)
                dist.destroy_process_group(self.group)
        except BaseException as e:  # noqa: BLE001 -- ends serving; surfaced to the waiters
            self.error = e
            self._fail(e)
            if not isinstance(e, Exception):
                raise

    def _round(self) -> bool:
        """One round on this rank: publish, apply, agree, tick; False at the
        closing round. Every rank applies every command, even after one
        failed there (a job's collectives then still pair up), and the ranks
        agree before the tick, so a command that failed on one rank stops
        every rank before any collective of the tick; an error in a tick is
        agreed on in the next round."""
        todo = self._next() if self.leader else None
        t0 = time.perf_counter()
        if self.group is None:
            commands = [c for c, _ in todo]
        else:
            commands = publish(None if todo is None else [c for c, _ in todo], self.group)
        control = time.perf_counter() - t0
        local = [x for _, x in todo] if self.leader else [None] * len(commands)
        self.rounds += 1
        err, failed = self._tick_error, 0
        for command, x in zip(commands, local):
            if command == CLOSE:
                continue
            try:
                failed += bool(self._apply(command, x))
            except Exception as e:  # noqa: BLE001 -- agreed on below, then re-raised
                err = err or e
        t1 = time.perf_counter()
        ok = err is None if self.group is None else agree(err is None, failed, self.group)
        self.control_s = control + time.perf_counter() - t1
        if not ok:
            raise err or RuntimeError("another rank of the group failed")
        if CLOSE in commands:
            return False
        try:
            self._tick()
        except Exception as e:  # noqa: BLE001 -- agreed on in the next round
            self._tick_error = e
        return True
