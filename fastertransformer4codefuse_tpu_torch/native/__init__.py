"""ctypes bindings to the repository's native host library (``native/`` at
the repository root: bulk checkpoint reads and the vocab trie).

This is host I/O, not a device kernel. The library is built on first use by
``native/build.sh`` (plain g++, a C ABI) into ``native/lib/``, which git
ignores. Everything here has a Python fallback: ``available()`` says whether
the library loaded, and callers log which reader ran.
"""
from __future__ import annotations

import ctypes
import logging
import os
import subprocess
from typing import List, Sequence

import numpy as np

logger = logging.getLogger(__name__)

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_LIB_PATH = os.path.join(_REPO_ROOT, "native", "lib", "libftcf_native.so")
_BUILD_SH = os.path.join(_REPO_ROOT, "native", "build.sh")

_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if not os.path.exists(_LIB_PATH) and os.path.exists(_BUILD_SH):
        try:
            subprocess.run(["sh", _BUILD_SH], check=True, capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError) as e:
            logger.warning("native library build failed (%s); Python readers serve", e)
            return None
    if not os.path.exists(_LIB_PATH):
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError as e:
        logger.warning("native library did not load (%s); Python readers serve", e)
        return None
    lib.ftcf_read_files.restype = ctypes.c_int
    lib.ftcf_read_files.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int,
        ctypes.c_int,
    ]
    lib.ftcf_file_size.restype = ctypes.c_int64
    lib.ftcf_file_size.argtypes = [ctypes.c_char_p]
    lib.ftcf_trie_new.restype = ctypes.c_void_p
    lib.ftcf_trie_insert.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32]
    lib.ftcf_trie_extensions.restype = ctypes.c_int
    lib.ftcf_trie_extensions.argtypes = [
        ctypes.c_void_p,
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int,
    ]
    lib.ftcf_trie_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _require():
    lib = _load()
    if lib is None:
        raise RuntimeError("the native library is unavailable (native/build.sh)")
    return lib


def file_size(path: str) -> int:
    """A file's size in bytes (-1 when it cannot be opened)."""
    return int(_require().ftcf_file_size(path.encode()))


def read_files(paths: Sequence[str], dests: Sequence[np.ndarray], threads: int = 16) -> None:
    """Read each file fully into the matching (contiguous, writable) array,
    on a pool of ``threads`` C++ threads."""
    lib = _require()
    n = len(paths)
    if n != len(dests):
        raise ValueError("one destination array per path")
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    c_dests = (ctypes.c_void_p * n)(*[d.ctypes.data_as(ctypes.c_void_p) for d in dests])
    c_sizes = (ctypes.c_int64 * n)(*[d.nbytes for d in dests])
    rc = lib.ftcf_read_files(c_paths, c_dests, c_sizes, n, threads)
    if rc != 0:
        raise IOError(f"native read failed for {paths[rc - 1]}")


class NativeTrie:
    """The C++ vocab trie behind ``api.trie.VocabTrie``'s interface:
    ``extensions()`` gives (token string, token id) pairs (the strings come
    from an id -> string map kept here; the C side stores ids), and
    ``printAutoSuggestions`` keeps the reference's 0 / -1 / 1 contract."""

    def __init__(self, vocab):
        lib = _require()
        self._lib = lib
        self._handle = lib.ftcf_trie_new()
        self.vocab = vocab
        self._id_to_tok = {}
        for tok, tid in vocab.items():
            lib.ftcf_trie_insert(self._handle, tok.encode(), tid)
            self._id_to_tok[tid] = tok

    def extension_ids(self, prefix: str) -> List[int]:
        cap = 4096
        while True:
            buf = (ctypes.c_int32 * cap)()
            count = self._lib.ftcf_trie_extensions(self._handle, prefix.encode(), buf, cap)
            if count <= cap:
                return list(buf[:count])
            cap = count

    def extensions(self, prefix: str):
        return [(self._id_to_tok[tid], tid) for tid in self.extension_ids(prefix)]

    def printAutoSuggestions(self, key: str, results: list) -> int:
        """0: the prefix is absent; -1: the prefix is a leaf token (nothing
        appended); 1: suggestions appended. Every trie node lies on a path to
        an inserted token, so "leaf" is "the only extension is the prefix"."""
        exts = self.extensions(key)
        if not exts:
            return 0
        if len(exts) == 1 and exts[0][0] == key:
            return -1
        results.extend(exts)
        return 1

    def __del__(self):
        handle, self._handle = getattr(self, "_handle", None), None
        if handle is not None:
            self._lib.ftcf_trie_free(handle)
