"""Long-lived serving front end over the continuous batcher (port of
engine/server.py).

A single driver thread ticks a ContinuousBatcher slot pool; requests
submitted from any thread join mid-flight by chunk-prefilling into a free
slot and retire the moment they finish, so short requests never wait behind
long ones.

Threading contract: all device work happens on the driver thread (the
batcher is not thread-safe); ``submit``/``generate`` only append to a
mutex-guarded mailbox and wait on per-request events. Streaming callbacks
fire on the driver thread, so keep them cheap. A driver that dies reports
its exception to every waiter.

``beam_width > 1`` builds a beam pool (``engine/beam_pool.py``) on dense
slabs; ``speculative=True`` (with ``spec_k``, ``spec_ngram``) a speculative
pool (``engine/spec_pool.py``) on dense slabs, whose tick is a (k+1)-wide
verify of greedy requests. ``MultiPoolServer`` routes a request only to a
class of its kind: beams to beam classes of their width, speculative
requests (``submit(..., speculative=True)``) to speculative classes, and
every other request to sampling classes; within its kind, to the smallest
class it fits.

The driver is ``LockstepPools``, whose rounds (``parallel/lockstep.py``)
take the mailbox, admit what it held and tick the pool. Under a mesh with
several ranks on tp or pp (the JAX package's "serving under a device mesh")
the rounds run in lockstep over the process group: on rank 0 the client API
and the driver thread, which publishes each round's admissions under their
uids; on every other rank ``follow()``, which runs the same rounds until
rank 0 closes. ``MultiPoolServer`` then has one driver for all its classes,
ticking them in one order each round (at one rank, one driver a class).
Streaming callbacks fire on rank 0 only; the other ranks keep the same
bookkeeping.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Sequence

from ..parallel.lockstep import Rounds, serves_in_lockstep
from .batcher import _UIDS, ContinuousBatcher, Request
from .beam_pool import BeamPool
from .spec_pool import SpecPool

_LOCAL_ONLY = ("on_token", "on_text", "tokenizer")  # stay on rank 0, unpublished


def make_pool(engine, **pool_kwargs):
    """The slot pool a ``BatchingServer`` drives: a beam pool for
    ``beam_width > 1``, a speculative pool for ``speculative=True``, else a
    ContinuousBatcher."""
    bw = int(pool_kwargs.pop("beam_width", 1) or 1)
    if pool_kwargs.pop("speculative", False):
        if bw > 1:
            raise ValueError("speculative pools are greedy (beam_width 1)")
        pool_kwargs.pop("sampling_cap", None)  # greedy only
        return SpecPool(engine, k=int(pool_kwargs.pop("spec_k", 8)),
                        ngram=int(pool_kwargs.pop("spec_ngram", 3)), **pool_kwargs)
    if bw > 1:
        if pool_kwargs.pop("paged", None):
            # a dense pool instead would multiply the requested page
            # budget by beam_width
            raise ValueError("beam pools are dense (beam indirection addresses row-contiguous "
                             "slabs); drop paged= or use beam_width=1")
        # beams ignore top-k / top-p, and their scores are returned anyway
        pool_kwargs.pop("sampling_cap", None)
        pool_kwargs.pop("return_log_probs", None)
        return BeamPool(engine, beam_width=bw, **pool_kwargs)
    return ContinuousBatcher(engine, **pool_kwargs)


class _Waiter:
    """A leader's request or job in flight: its event, and on completion its
    result or the error that failed it. ``local``: what stays on rank 0 (a
    pool's Request with its callbacks, a static job's callback)."""

    __slots__ = ("event", "done", "result", "error", "local")

    def __init__(self, local=None):
        self.event = threading.Event()
        self.done = False
        self.result = None
        self.error: Optional[BaseException] = None
        self.local = local

    def finish(self, result=None, error: Optional[BaseException] = None) -> None:
        self.done, self.result, self.error = True, result, error
        self.event.set()

    def outcome(self):
        """The result, or the error: the job's own, the driver's death, or
        the server's shutdown."""
        if self.error is not None:
            raise self.error
        if not self.done:
            raise RuntimeError("server is shut down")
        return self.result


class LockstepPools:
    """The driver of pool classes and static jobs of one front end: rounds
    (``parallel/lockstep.py``) on a thread of its own, over every rank of
    the process group where ``over_group`` (every rank then builds it at
    the same point, over the same classes in the same order).

    A round's commands: ``("admit", class, uid, prompt, output_len, kw)``,
    a request built on rank 0 (``submit``) and rebuilt under its uid on the
    others; ``("job", key, uid, payload)``, a static request (``run``):
    ``jobs[key](payload, local)`` on every rank, where the front end
    registered the same ``jobs`` on every rank and ``local`` is None but on
    rank 0. After them every class with work ticks once, in class order.
    ``served``, when a list, gets ``(uid, record)`` on every rank for each
    request finished (its tokens, beams and seed) and each job run (its
    result)."""

    def __init__(self, batchers: Sequence[ContinuousBatcher], over_group: bool = False,
                 name: str = "ftcf-pool-driver"):
        self.batchers = list(batchers)
        self.jobs: Dict[str, Callable] = {}
        self.served: Optional[list] = None
        self._lock = threading.Lock()
        self._mailbox: List[tuple] = []
        self._waiting: Dict[int, _Waiter] = {}
        self._closed = False
        self.rounds = Rounds(self._collect, self._apply, self._tick, self._busy, self._fail,
                             name, over_group)

    @property
    def leader(self) -> bool:
        return self.rounds.leader

    # ------------------------------------------------------------ client ----
    def _post(self, command, waiter: _Waiter) -> None:
        self.rounds.check_leader()
        if self._closed:
            raise RuntimeError("server is shut down")
        if self.rounds.error is not None:
            raise RuntimeError("pool driver died") from self.rounds.error
        uid = command[2]
        with self._lock:
            self._mailbox.append((command, waiter))
            self._waiting[uid] = waiter
        if self.rounds.error is not None:
            # the driver died between the entry check and the registration:
            # its error broadcast may have missed this waiter
            waiter.event.set()
        self.rounds.wake()

    def submit(self, cls: int, prompt: Sequence[int], output_len: int, **kw) -> int:
        """Rank 0: build a request for pool class ``cls`` (validated here, on
        the client's thread) and publish it at the next round; returns its
        uid."""
        self.rounds.check_leader()
        r = self.batchers[cls].make_request(prompt, output_len, **kw)
        spec = {k: v for k, v in kw.items() if k not in _LOCAL_ONLY}
        self._post(("admit", cls, r.uid, list(prompt), output_len, spec), _Waiter(r))
        return r.uid

    def wait(self, uid: int, timeout: Optional[float] = None) -> Request:
        """Rank 0: block until request ``uid`` completes; returns the finished
        Request and forgets it."""
        return self._outcome(uid, timeout)

    def run(self, key: str, payload, local=None, timeout: Optional[float] = None):
        """Rank 0: run job ``key`` on every rank between the pools' ticks;
        returns rank 0's result or raises its error."""
        uid = next(_UIDS)
        self._post(("job", key, uid, payload), _Waiter(local))
        return self._outcome(uid, timeout)

    def _outcome(self, uid: int, timeout: Optional[float]):
        w = self._waiting[uid]
        if not w.event.wait(timeout):
            raise TimeoutError(f"request {uid} still running after {timeout}s")
        with self._lock:
            self._waiting.pop(uid, None)
        if not w.done and self.rounds.error is not None:
            raise RuntimeError("pool driver died") from self.rounds.error
        return w.outcome()

    def follow(self) -> None:
        """Every rank but 0: serve rank 0's rounds until it closes."""
        self.rounds.follow()

    def close(self) -> None:
        """Rank 0: publish the closing round; what is still waiting then
        fails. Idempotent; nothing on a follower."""
        if self.leader and not self._closed:
            self._closed = True
            self.rounds.close()
            self._fail(None)

    # ------------------------------------------------------------ driver ----
    def _collect(self):
        with self._lock:
            todo = list(self._mailbox)
            self._mailbox.clear()
        return todo

    def _busy(self) -> bool:
        return any(b.pending or b.running or b._inflight for b in self.batchers)

    def _record(self, uid: int, record) -> None:
        if self.served is not None:
            self.served.append((uid, record))

    def _apply(self, command, waiter: Optional[_Waiter]) -> bool:
        if command[0] == "admit":
            _, cls, uid, prompt, output_len, spec = command
            b = self.batchers[cls]
            b.enqueue(waiter.local if waiter is not None
                      else b.make_request(prompt, output_len, uid=uid, **spec))
            return False
        _, key, uid, payload = command
        try:
            result = self.jobs[key](payload, None if waiter is None else waiter.local)
        except Exception as e:  # noqa: BLE001 -- the job's own failure, told to its caller
            if waiter is not None:
                waiter.finish(error=e)
            self._record(uid, repr(e))
            return True
        self._record(uid, result)
        if waiter is not None:
            waiter.finish(result)
        return False

    def _tick(self) -> None:
        for b in self.batchers:
            if not (b.pending or b.running or b._inflight):
                continue
            for uid, _tok, done in b.step():
                if not done:
                    continue
                r = b.requests.pop(uid)
                self._record(uid, {"ids": r.output_ids, "beams": r.beam_output_ids,
                                   "seed": r.random_seed})
                w = self._waiting.get(uid)
                if w is not None:
                    w.finish(r)

    def _fail(self, _error) -> None:
        with self._lock:
            waiters = list(self._waiting.values())
        for w in waiters:
            w.event.set()


class BatchingServer:
    """Thread-safe request mailbox + driver thread around ContinuousBatcher
    (its ``LockstepPools``, as ``lockstep``). ``lockstep_dp``: serve a
    dp-only mesh over the process group too, from rank 0's clients."""

    def __init__(self, engine, lockstep_dp: bool = False, **pool_kwargs):
        over = serves_in_lockstep(getattr(engine, "mesh", None), dp=lockstep_dp)
        batcher = make_pool(engine, **pool_kwargs)
        self._serve(batcher, LockstepPools([batcher], over), 0)

    @classmethod
    def _over(cls, batcher, lockstep: LockstepPools, index: int) -> "BatchingServer":
        """A server of ``batcher``, class ``index`` of ``lockstep``."""
        srv = cls.__new__(cls)
        srv._serve(batcher, lockstep, index)
        return srv

    def _serve(self, batcher, lockstep: LockstepPools, index: int) -> None:
        self.batcher = batcher
        self.lockstep = lockstep
        self._cls = index

    # ------------------------------------------------------------ client ----
    def submit(
        self,
        prompt: Sequence[int],
        output_len: int,
        on_token: Optional[Callable[[int], None]] = None,
        on_text: Optional[Callable[[str], None]] = None,
        tokenizer=None,
        speculative: Optional[bool] = None,
        **kw,
    ) -> int:
        """Enqueue one request; returns its uid immediately. The request joins
        the pool at the driver's next tick. ``speculative``, when given, must
        match the pool's kind."""
        if speculative is not None and bool(speculative) != self.batcher.speculative:
            raise ValueError(f"a {'' if speculative else 'non-'}speculative request for a "
                             f"{'' if self.batcher.speculative else 'non-'}speculative pool")
        return self.lockstep.submit(self._cls, prompt, output_len, on_token=on_token,
                                    on_text=on_text, tokenizer=tokenizer, **kw)

    def wait(self, uid: int, timeout: Optional[float] = None) -> Request:
        """Block until request ``uid`` completes; returns the finished Request
        and forgets it server-side."""
        return self.lockstep.wait(uid, timeout)

    def generate(self, prompt: Sequence[int], output_len: int, **kw) -> Request:
        """submit + wait, for synchronous callers."""
        return self.wait(self.submit(prompt, output_len, **kw))

    def routable_pool(self, need: int, beam_width: int = 1, speculative: bool = False):
        """The batcher a request of this length, beam width and kind would
        land in, or None: a speculative request only in a speculative pool,
        no other request there. A speculative pool keeps a draft margin of
        k + 2 positions."""
        b = self.batcher
        if getattr(b, "beam_width", 1) != beam_width or b.speculative != bool(speculative):
            return None
        room = b.max_seq_len - (b.k + 2 if b.speculative else 0)
        return b if need <= room else None

    def follow(self) -> None:
        """Under a mesh, every rank but 0: serve rank 0's rounds until it
        closes."""
        self.lockstep.follow()

    def close(self):
        self.lockstep.close()


class MultiPoolServer:
    """Length-classed slot pools over one engine (shared weights): each
    request routes to the smallest pool class of its beam width that it
    fits, each class with its own driver thread (over the process group one
    ``LockstepPools`` for all, as ``lockstep``; None at one rank).
    ``pools``: a list of BatchingServer kwargs, e.g. ``[dict(max_slots=16,
    max_seq_len=256), dict(max_slots=4, max_seq_len=2048)]``;
    ``lockstep_dp`` as BatchingServer's. API-compatible with
    BatchingServer."""

    def __init__(self, engine, pools, lockstep_dp: bool = False):
        if not pools:
            raise ValueError("need at least one pool class")
        over = serves_in_lockstep(getattr(engine, "mesh", None), dp=lockstep_dp)
        batchers = sorted((make_pool(engine, **kw) for kw in pools), key=lambda b: b.max_seq_len)
        self.lockstep = LockstepPools(batchers, over_group=True) if over else None
        self.servers = [BatchingServer._over(b, self.lockstep, i) if over else
                        BatchingServer._over(b, LockstepPools([b]), 0)
                        for i, b in enumerate(batchers)]
        self._route: Dict[int, BatchingServer] = {}

    @property
    def batcher(self):  # the largest class bounds capacity
        return self.servers[-1].batcher

    def submit(self, prompt, output_len: int, speculative: bool = False, **kw) -> int:
        """Route to the smallest class of the request's kind that it fits
        (``speculative``: a speculative class; otherwise a class of its beam
        width that is not speculative)."""
        need = len(prompt) + output_len
        bw = int(kw.pop("beam_width", 1) or 1)
        for srv in self.servers:
            if srv.routable_pool(need, bw, speculative) is not None:
                uid = srv.submit(prompt, output_len, **kw)
                self._route[uid] = srv  # uids are process-wide unique
                return uid
        raise ValueError(
            f"prompt({len(prompt)}) + output({output_len}) @ beam_width={bw}"
            f"{', speculative' if speculative else ''} fits no pool class (largest "
            f"{self.servers[-1].batcher.max_seq_len})"
        )

    def routable_pool(self, need: int, beam_width: int = 1, speculative: bool = False):
        for srv in self.servers:
            b = srv.routable_pool(need, beam_width, speculative)
            if b is not None:
                return b
        return None

    def wait(self, uid: int, timeout=None):
        # the route is dropped only after a successful wait, so a caller can
        # retry after a TimeoutError
        result = self._route[uid].wait(uid, timeout)
        self._route.pop(uid, None)
        return result

    def generate(self, prompt, output_len: int, **kw):
        return self.wait(self.submit(prompt, output_len, **kw))

    def follow(self) -> None:
        """Under a mesh, every rank but 0: serve rank 0's rounds until it
        closes."""
        self.servers[0].follow()

    def close(self):
        for srv in self.servers:
            srv.close()
