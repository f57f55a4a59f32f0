"""Micro-batching server for encoder families (port of
engine/encoder_server.py).

Requests from any thread enter a mailbox; a driver thread drains up to
``max_batch`` of them, pads the ids to a multiple of ``seq_bucket``, runs ONE
batched ``encode`` and hands each request its rows. Works with any engine
exposing ``encode(ids [B, S], lengths [B]) -> (hidden, pooled or None)``:
``models.bert.BertEngine`` (float or int8) or
``models.longformer.LongformerEngine``. Results come back as fp32 numpy
arrays, whatever device and dtype the engine ran in. ``T5BatchingServer``
does the same for ``engine.t5_engine.T5Engine.generate``.
"""
from __future__ import annotations

import threading
from typing import List, Optional, Sequence

import numpy as np
import torch


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


class EncoderBatchingServer:
    """Thread-safe dynamic batching around one encoder engine."""

    def __init__(self, engine, max_batch: int = 16, seq_bucket: int = 16,
                 max_seq_len: int = 2048):
        self.engine = engine
        self.max_batch = int(max_batch)
        self.seq_bucket = int(seq_bucket)
        self.max_seq_len = int(max_seq_len)
        self._lock = threading.Lock()
        self._mailbox: List[_Pending] = []
        self._wake = threading.Event()
        self._shutdown = False
        self.batches_run = 0  # how many batched forwards ran
        self.requests_served = 0
        self._thread = threading.Thread(
            target=self._drive, name="ftcf-encoder-driver", daemon=True
        )
        self._thread.start()

    # ------------------------------------------------------------ client ----
    def encode(self, ids: Sequence[int], timeout: Optional[float] = None):
        """Blocking per-request encode; returns (hidden [n, H], pooled [H] or
        None) as fp32 numpy for this request's n real tokens."""
        assert not self._shutdown, "server is shut down"
        ids = list(ids)
        if not (0 < len(ids) <= self.max_seq_len):
            raise ValueError(f"sequence length {len(ids)} not in (0, {self.max_seq_len}]")
        p = _Pending(ids)
        with self._lock:
            self._mailbox.append(p)
        self._wake.set()
        if not p.event.wait(timeout):
            raise TimeoutError("encode still queued/running")
        if p.error is not None:
            raise RuntimeError("encoder batch failed") from p.error
        return p.hidden, p.pooled

    def close(self):
        self._shutdown = True
        self._wake.set()
        self._thread.join(timeout=30)

    # ------------------------------------------------------------ driver ----
    def _drive(self):
        while not self._shutdown:
            with self._lock:
                batch = self._mailbox[: self.max_batch]
                del self._mailbox[: len(batch)]
            if not batch:
                self._wake.wait()
                self._wake.clear()
                continue
            try:
                lens = np.array([len(p.ids) for p in batch], np.int32)
                W = -(-int(lens.max()) // self.seq_bucket) * self.seq_bucket
                ids = np.zeros((len(batch), W), np.int32)
                for i, p in enumerate(batch):
                    ids[i, : len(p.ids)] = p.ids
                hidden, pooled = self.engine.encode(ids, lens)
                hidden = _host_fp32(hidden)
                pooled = None if pooled is None else _host_fp32(pooled)
                self.batches_run += 1
                for i, p in enumerate(batch):
                    p.hidden = hidden[i, : len(p.ids)]
                    p.pooled = None if pooled is None else pooled[i]
                    self.requests_served += 1
                    p.event.set()
            except BaseException as e:  # noqa: BLE001 -- surfaced per request
                for p in batch:
                    p.error = e
                    p.event.set()


class T5BatchingServer:
    """Dynamic micro-batching around ``engine.t5_engine.T5Engine.generate``:
    requests from any thread coalesce into one generate call when they share
    ``(output_len, beam_width, length_penalty)``, up to ``max_batch`` of
    them (the head of the mailbox and its peers, in arrival order); each
    row's ``top_k``, ``top_p``, ``temperature`` and ``random_seed`` ride the
    engine's per-row vectors. ``batches_run`` counts the generate calls,
    ``requests_served`` the requests answered."""

    def __init__(self, engine, max_batch: int = 8, seq_bucket: int = 8,
                 max_seq_len: int = 2048):
        self.engine = engine
        self.max_batch = int(max_batch)
        self.seq_bucket = int(seq_bucket)
        self.max_seq_len = int(max_seq_len)
        self._lock = threading.Lock()
        self._mailbox: List[dict] = []
        self._wake = threading.Event()
        self._shutdown = False
        self.batches_run = 0
        self.requests_served = 0
        self._thread = threading.Thread(
            target=self._drive, name="ftcf-t5-driver", daemon=True
        )
        self._thread.start()

    def generate(self, ids: Sequence[int], output_len: int, beam_width: int = 1,
                 top_k: int = 1, top_p: float = 0.0, temperature: float = 1.0,
                 random_seed: int = 0, length_penalty: float = 1.0,
                 timeout: Optional[float] = None):
        """Blocking per-request generate; returns the request's slice of the
        engine's ``T5Output`` (output_ids [beams, L], sequence_lengths [beams],
        scores [beams])."""
        if self._shutdown:
            raise RuntimeError("server is shut down")
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
        with self._lock:
            self._mailbox.append(req)
        self._wake.set()
        if not req["event"].wait(timeout):
            raise TimeoutError("generate still queued/running")
        if req["error"] is not None:
            raise RuntimeError("t5 batch failed") from req["error"]
        return req["result"]

    def close(self):
        self._shutdown = True
        self._wake.set()
        self._thread.join(timeout=60)

    @staticmethod
    def _key(r):
        return r["output_len"], r["beam_width"], r["length_penalty"]

    def _drive(self):
        while not self._shutdown:
            with self._lock:
                batch, rest = [], []
                for r in self._mailbox:  # the head request and its same-static peers
                    if len(batch) < self.max_batch and (
                            not batch or self._key(r) == self._key(batch[0])):
                        batch.append(r)
                    else:
                        rest.append(r)
                self._mailbox[:] = rest
            if not batch:
                self._wake.wait()
                self._wake.clear()
                continue
            try:
                out = self.engine.generate(
                    [r["ids"] for r in batch],
                    batch[0]["output_len"],
                    beam_width=batch[0]["beam_width"],
                    top_k=[r["top_k"] for r in batch],
                    top_p=[r["top_p"] for r in batch],
                    temperature=[r["temperature"] for r in batch],
                    random_seed=[r["random_seed"] for r in batch],
                    length_penalty=batch[0]["length_penalty"],
                )
                self.batches_run += 1
                for i, r in enumerate(batch):
                    r["result"] = type(out)(
                        output_ids=out.output_ids[i],
                        sequence_lengths=out.sequence_lengths[i],
                        scores=out.scores[i],
                    )
                    self.requests_served += 1
                    r["event"].set()
            except Exception as e:  # noqa: BLE001 -- surfaced per request
                for r in batch:
                    r["error"] = e
                    r["event"].set()
