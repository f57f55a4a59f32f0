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
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Sequence

from .batcher import ContinuousBatcher, Request
from .beam_pool import BeamPool
from .spec_pool import SpecPool


class BatchingServer:
    """Thread-safe request mailbox + driver thread around ContinuousBatcher."""

    def __init__(self, engine, **pool_kwargs):
        mesh = getattr(engine, "mesh", None)
        if mesh is not None and (mesh.tp > 1 or mesh.pp > 1):
            raise ValueError(
                "the server's thread admits requests in arrival order, which differs between "
                "the ranks of a tensor- or pipeline-parallel group: drive a ContinuousBatcher "
                "(or BeamPool, SpecPool) in lockstep on every rank instead")
        bw = int(pool_kwargs.pop("beam_width", 1) or 1)
        if pool_kwargs.pop("speculative", False):
            if bw > 1:
                raise ValueError("speculative pools are greedy (beam_width 1)")
            pool_kwargs.pop("sampling_cap", None)  # greedy only
            self.batcher = SpecPool(engine, k=int(pool_kwargs.pop("spec_k", 8)),
                                    ngram=int(pool_kwargs.pop("spec_ngram", 3)), **pool_kwargs)
        elif bw > 1:
            if pool_kwargs.pop("paged", None):
                # a dense pool instead would multiply the requested page
                # budget by beam_width
                raise ValueError("beam pools are dense (beam indirection addresses row-contiguous "
                                 "slabs); drop paged= or use beam_width=1")
            # beams ignore top-k / top-p, and their scores are returned anyway
            pool_kwargs.pop("sampling_cap", None)
            pool_kwargs.pop("return_log_probs", None)
            self.batcher = BeamPool(engine, beam_width=bw, **pool_kwargs)
        else:
            self.batcher = ContinuousBatcher(engine, **pool_kwargs)
        self._lock = threading.Lock()
        self._mailbox: List[Request] = []
        self._events: Dict[int, threading.Event] = {}
        self._wake = threading.Event()
        self._shutdown = False
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._drive, name="ftcf-pool-driver", daemon=True)
        self._thread.start()

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
        if self._shutdown:
            raise RuntimeError("server is shut down")
        if self._error is not None:
            raise RuntimeError("pool driver died") from self._error
        r = self.batcher.make_request(
            prompt, output_len, on_token=on_token, on_text=on_text, tokenizer=tokenizer, **kw
        )
        with self._lock:
            self._mailbox.append(r)
            self._events[r.uid] = threading.Event()
        if self._error is not None:
            # the driver died between the entry check and the registration:
            # its error broadcast may have missed this event
            self._events[r.uid].set()
        self._wake.set()
        return r.uid

    def wait(self, uid: int, timeout: Optional[float] = None) -> Request:
        """Block until request ``uid`` completes; returns the finished Request
        and forgets it server-side."""
        ev = self._events[uid]
        if not ev.wait(timeout):
            raise TimeoutError(f"request {uid} still running after {timeout}s")
        with self._lock:
            req = self.batcher.requests.get(uid)
            if req is not None and req.done:
                # finished before any later driver death: return the result
                self._events.pop(uid, None)
                return self.batcher.requests.pop(uid)
        if self._error is not None:
            raise RuntimeError("pool driver died") from self._error
        with self._lock:
            self._events.pop(uid, None)
            return self.batcher.requests.pop(uid)

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

    def close(self):
        self._shutdown = True
        self._wake.set()
        self._thread.join(timeout=30)

    # ------------------------------------------------------------ driver ----
    def _drain_mailbox(self):
        with self._lock:
            todo = list(self._mailbox)
            self._mailbox.clear()
        for r in todo:
            self.batcher.enqueue(r)

    def _drive(self):
        b = self.batcher
        try:
            while not self._shutdown:
                self._drain_mailbox()
                if not (b.pending or b.running or b._inflight):
                    self._wake.wait()
                    self._wake.clear()
                    continue
                for uid, _tok, done in b.step():
                    if done:
                        ev = self._events.get(uid)
                        if ev is not None:
                            ev.set()
        except BaseException as e:  # noqa: BLE001 -- surfaced to every waiter
            self._error = e
            for ev in list(self._events.values()):
                ev.set()


class MultiPoolServer:
    """Length-classed slot pools over one engine (shared weights): each
    request routes to the smallest pool class of its beam width that it
    fits, each class with its own driver thread. ``pools``: a list of
    BatchingServer kwargs, e.g. ``[dict(max_slots=16, max_seq_len=256),
    dict(max_slots=4, max_seq_len=2048)]``. API-compatible with
    BatchingServer."""

    def __init__(self, engine, pools):
        if not pools:
            raise ValueError("need at least one pool class")
        self.servers = sorted(
            (BatchingServer(engine, **kw) for kw in pools), key=lambda s: s.batcher.max_seq_len
        )
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

    def close(self):
        for srv in self.servers:
            srv.close()
