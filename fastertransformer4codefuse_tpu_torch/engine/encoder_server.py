"""Micro-batching server for encoder families (port of
engine/encoder_server.py).

Requests from any thread enter a mailbox; a driver thread drains up to
``max_batch`` of them, pads the ids to a multiple of ``seq_bucket``, runs ONE
batched ``encode`` and hands each request its rows. Works with any engine
exposing ``encode(ids [B, S], lengths [B]) -> (hidden, pooled or None)``:
``models.bert.BertEngine`` (float or int8, and under tp through its mesh) or
``models.longformer.LongformerEngine``. Results come back as fp32 numpy
arrays, whatever device and dtype the engine ran in. ``T5BatchingServer``
does the same for ``engine.t5_engine.T5Engine.generate``.

The driver runs in rounds (``parallel/lockstep.py``, as ``lockstep``), one
batch a round. Under a mesh with several ranks on tp (the engine's ``mesh``)
the rounds run in lockstep over the process group: rank 0 takes the requests
and its driver publishes each batch's members (their ids, from which every
rank pads to the same width, and for T5 the batch's decode settings); every
other rank calls ``follow()`` and runs the same batches until rank 0
closes.
"""
from __future__ import annotations

import threading
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..parallel.lockstep import Rounds, serves_in_lockstep


class _Pending:
    __slots__ = ("ids", "event", "hidden", "pooled", "error")

    def __init__(self, ids):
        self.ids = ids
        self.event = threading.Event()
        self.hidden = None
        self.pooled = None
        self.error: Optional[BaseException] = None


def _host_fp32(x) -> np.ndarray:
    """An engine output (a tensor on any device, or an array) as fp32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


class _Batching:
    """The driver of both servers: rounds that take one batch from the
    mailbox (``_take``), run it (``_run``) and hand it back (``_deliver``),
    in lockstep over the process group under a mesh of several ranks."""

    _thread_name = "ftcf-batch-driver"
    _join_s = 30.0

    def _start(self, engine) -> None:
        self._lock = threading.Lock()
        self._mailbox: list = []
        self._shutdown = False
        self.batches_run = 0
        self.requests_served = 0
        self.lockstep = Rounds(self._collect, self._apply, lambda: None,
                               lambda: bool(self._mailbox), self._fail, self._thread_name,
                               serves_in_lockstep(getattr(engine, "mesh", None)))

    def _enqueue(self, item) -> None:
        ls = self.lockstep
        ls.check_leader()
        if ls.error is not None:
            raise RuntimeError("pool driver died") from ls.error
        if self._shutdown:
            raise RuntimeError("server is shut down")
        with self._lock:
            self._mailbox.append(item)
        if ls.error is not None:
            # the driver died between the check and the append: its failure
            # broadcast may have missed this request
            self._fail(ls.error)
        else:
            ls.wake()

    def follow(self) -> None:
        """Under a mesh, every rank but 0: run rank 0's batches until it
        closes."""
        self.lockstep.follow()

    def close(self):
        self._shutdown = True
        self.lockstep.close(self._join_s)
        self._fail(RuntimeError("server is shut down"))

    # ------------------------------------------------------------ driver ----
    def _collect(self):
        batch = self._take()
        return [(self._published(batch), batch)] if batch else []

    def _apply(self, rows, batch) -> bool:
        try:
            out = self._run(rows)
        except BaseException as e:  # noqa: BLE001 -- the batch's own failure, told to its callers
            self._fail_batch(batch or [], e)
            if not isinstance(e, Exception):
                raise
            return True
        if batch is None:
            self.requests_served += len(rows)
        else:
            self._deliver(batch, out)
        return False

    def _fail(self, error) -> None:
        with self._lock:
            left = list(self._mailbox)
            self._mailbox.clear()
        self._fail_batch(left, error)


class EncoderBatchingServer(_Batching):
    """Thread-safe dynamic batching around one encoder engine."""

    _thread_name = "ftcf-encoder-driver"

    def __init__(self, engine, max_batch: int = 16, seq_bucket: int = 16,
                 max_seq_len: int = 2048):
        self.engine = engine
        self.max_batch = int(max_batch)
        self.seq_bucket = int(seq_bucket)
        self.max_seq_len = int(max_seq_len)
        self._start(engine)

    # ------------------------------------------------------------ client ----
    def encode(self, ids: Sequence[int], timeout: Optional[float] = None):
        """Blocking per-request encode; returns (hidden [n, H], pooled [H] or
        None) as fp32 numpy for this request's n real tokens."""
        ids = list(ids)
        if not (0 < len(ids) <= self.max_seq_len):
            raise ValueError(f"sequence length {len(ids)} not in (0, {self.max_seq_len}]")
        p = _Pending(ids)
        self._enqueue(p)
        if not p.event.wait(timeout):
            raise TimeoutError("encode still queued/running")
        if p.error is not None:
            raise RuntimeError("encoder batch failed") from p.error
        return p.hidden, p.pooled

    # ------------------------------------------------------------ driver ----
    def _take(self) -> List[_Pending]:
        with self._lock:
            batch = self._mailbox[: self.max_batch]
            del self._mailbox[: len(batch)]
        return batch

    @staticmethod
    def _published(batch) -> list:
        return [p.ids for p in batch]

    def _run(self, rows):
        lens = np.array([len(r) for r in rows], np.int32)
        W = -(-int(lens.max()) // self.seq_bucket) * self.seq_bucket
        ids = np.zeros((len(rows), W), np.int32)
        for i, r in enumerate(rows):
            ids[i, : len(r)] = r
        hidden, pooled = self.engine.encode(ids, lens)
        self.batches_run += 1
        return _host_fp32(hidden), None if pooled is None else _host_fp32(pooled)

    def _deliver(self, batch, out) -> None:
        hidden, pooled = out
        for i, p in enumerate(batch):
            p.hidden = hidden[i, : len(p.ids)]
            p.pooled = None if pooled is None else pooled[i]
            self.requests_served += 1
            p.event.set()

    @staticmethod
    def _fail_batch(batch, error) -> None:
        for p in batch:
            p.error = error
            p.event.set()


class T5BatchingServer(_Batching):
    """Dynamic micro-batching around ``engine.t5_engine.T5Engine.generate``:
    requests from any thread coalesce into one generate call when they share
    ``(output_len, beam_width, length_penalty)``, up to ``max_batch`` of
    them (the head of the mailbox and its peers, in arrival order); each
    row's ``top_k``, ``top_p``, ``temperature`` and ``random_seed`` ride the
    engine's per-row vectors. ``batches_run`` counts the generate calls,
    ``requests_served`` the requests answered."""

    _thread_name = "ftcf-t5-driver"
    _join_s = 60.0
    _ROW = ("ids", "output_len", "beam_width", "top_k", "top_p", "temperature", "random_seed",
            "length_penalty")

    def __init__(self, engine, max_batch: int = 8, seq_bucket: int = 8,
                 max_seq_len: int = 2048):
        self.engine = engine
        self.max_batch = int(max_batch)
        self.seq_bucket = int(seq_bucket)
        self.max_seq_len = int(max_seq_len)
        self._start(engine)

    def generate(self, ids: Sequence[int], output_len: int, beam_width: int = 1,
                 top_k: int = 1, top_p: float = 0.0, temperature: float = 1.0,
                 random_seed: int = 0, length_penalty: float = 1.0,
                 timeout: Optional[float] = None):
        """Blocking per-request generate; returns the request's slice of the
        engine's ``T5Output`` (output_ids [beams, L], sequence_lengths [beams],
        scores [beams])."""
        if not (0 < len(ids) <= self.max_seq_len):
            raise ValueError(f"sequence length {len(ids)} not in (0, {self.max_seq_len}]")
        req = {
            "ids": list(ids), "output_len": int(output_len),
            "beam_width": int(beam_width), "top_k": int(top_k),
            "top_p": float(top_p), "temperature": float(temperature),
            "random_seed": int(random_seed),
            "length_penalty": float(length_penalty),
            "event": threading.Event(), "result": None, "error": None,
        }
        self._enqueue(req)
        if not req["event"].wait(timeout):
            raise TimeoutError("generate still queued/running")
        if req["error"] is not None:
            raise RuntimeError("t5 batch failed") from req["error"]
        return req["result"]

    @staticmethod
    def _key(r):
        return r["output_len"], r["beam_width"], r["length_penalty"]

    def _take(self) -> List[dict]:
        with self._lock:
            batch, rest = [], []
            for r in self._mailbox:  # the head request and its same-static peers
                if len(batch) < self.max_batch and (
                        not batch or self._key(r) == self._key(batch[0])):
                    batch.append(r)
                else:
                    rest.append(r)
            self._mailbox[:] = rest
        return batch

    @classmethod
    def _published(cls, batch) -> list:
        return [{k: r[k] for k in cls._ROW} for r in batch]

    def _run(self, rows):
        out = self.engine.generate(
            [r["ids"] for r in rows],
            rows[0]["output_len"],
            beam_width=rows[0]["beam_width"],
            top_k=[r["top_k"] for r in rows],
            top_p=[r["top_p"] for r in rows],
            temperature=[r["temperature"] for r in rows],
            random_seed=[r["random_seed"] for r in rows],
            length_penalty=rows[0]["length_penalty"],
        )
        self.batches_run += 1
        return out

    def _deliver(self, batch, out) -> None:
        for i, r in enumerate(batch):
            r["result"] = type(out)(
                output_ids=out.output_ids[i],
                sequence_lengths=out.sequence_lengths[i],
                scores=out.scores[i],
            )
            self.requests_served += 1
            r["event"].set()

    @staticmethod
    def _fail_batch(batch, error) -> None:
        for r in batch:
            r["error"] = error
            r["event"].set()
