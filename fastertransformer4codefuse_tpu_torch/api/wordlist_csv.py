"""CSV word-list parsing for batch drivers (port of api/wordlist_csv.py).

The reference's C++ word-list reader for its cpp example (start_ids.csv,
stop_words.csv, bad_words.csv): each batch entry is two lines, flat token ids
then cumulative offsets.
"""
from __future__ import annotations

from typing import List

import numpy as np


def read_word_list_csv(path: str) -> np.ndarray:
    """Parse the reference's 2-line-per-batch CSV into [B, 2, L] int32."""
    rows: List[List[int]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rows.append([int(x) for x in line.split(",") if x.strip() != ""])
    if len(rows) % 2:
        raise ValueError("word-list csv must pair id rows with offset rows")
    pairs = [(rows[i], rows[i + 1]) for i in range(0, len(rows), 2)]
    L = max(max(len(a), len(b)) for a, b in pairs)
    out = np.full((len(pairs), 2, L), -1, np.int32)
    for i, (ids, offs) in enumerate(pairs):
        out[i, 0, : len(ids)] = ids
        out[i, 0, len(ids):] = 0
        out[i, 1, : len(offs)] = offs
    return out


def read_start_ids_csv(path: str) -> List[List[int]]:
    """Parse start_ids.csv (one comma-separated prompt per line)."""
    prompts = []
    with open(path) as f:
        for line in f:
            line = line.strip().rstrip(",")
            if line:
                prompts.append([int(x) for x in line.split(",")])
    return prompts
