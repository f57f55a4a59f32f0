"""Profiling annotations and trace capture on ``torch.profiler`` (port of
utils/profiling.py).

``annotate`` names a range that shows in the trace, ``trace`` captures one
around a block (and exports it as a Chrome trace into ``log_dir``), and
``summarize_trace`` gives the flat per-kernel device-time table that the JAX
package builds from its xprof trace, from the profile's ``key_averages``:
``[(name, ms, count, kind)]``, the most device time first.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import List, Tuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function


def annotate(name: str):
    """A named range in the trace: ``with annotate("attention"): ...``."""
    return record_function(name)


@contextlib.contextmanager
def trace(log_dir: str = None, cuda: bool = None, cpu: bool = True):
    """Profile the block and yield the ``torch.profiler.profile``; device
    activity is recorded when ``cuda`` (default: a card is there), host
    operators when ``cpu``, and the device is synchronised before the
    capture ends. With ``log_dir`` the trace is written there as
    ``trace_<time>_<pid>.json``."""
    cuda = torch.cuda.is_available() if cuda is None else cuda
    acts = ([ProfilerActivity.CPU] if cpu else []) + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(
            os.path.join(log_dir, f"trace_{time.time_ns()}_{os.getpid()}.json"))


def _kind(name: str) -> str:
    low = name.lower()
    return "memcpy" if "memcpy" in low else "memset" if "memset" in low else "kernel"


def summarize_trace(prof, top: int = 20) -> List[Tuple[str, float, int, str]]:
    """Flat device-time summary of a finished profile (what ``trace``
    yields): ``[(name, total ms, count, kind)]`` of every entry with device
    time, the most first, ``kind`` one of "kernel", "memcpy", "memset".
    ``top`` 0 or None keeps every row."""
    rows = []
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:  # older releases name it after CUDA
            t = getattr(e, "self_cuda_time_total", 0.0)
        if t > 0:
            rows.append((e.key, t / 1e3, e.count, _kind(e.key)))
    rows.sort(key=lambda r: -r[1])
    return rows[:top] if top else rows
