"""Logging with the reference's environment contract (port of
utils/logger.py).

The level comes from ``FT_LOG_LEVEL`` (TRACE, DEBUG, INFO, WARNING, ERROR;
INFO by default), and ``FT_LOG_FIRST_RANK_ONLY`` (1, ON or TRUE) leaves only
errors to every process but rank 0. The rank is ``torch.distributed``'s once
a process group is up, else the ``RANK`` environment variable, else 0.
"""
from __future__ import annotations

import logging
import os

_LEVELS = {
    "TRACE": logging.DEBUG,
    "DEBUG": logging.DEBUG,
    "INFO": logging.INFO,
    "WARNING": logging.WARNING,
    "ERROR": logging.ERROR,
}

_configured = False


def _rank() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("RANK", "0") or 0)


def get_logger(name: str = "ftcf") -> logging.Logger:
    """The named logger, configured once per process from the environment."""
    global _configured
    logger = logging.getLogger(name)
    if not _configured:
        level = _LEVELS.get(os.environ.get("FT_LOG_LEVEL", "INFO").upper(), logging.INFO)
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter("[FTCF][%(levelname)s] %(asctime)s %(message)s"))
        logger.addHandler(handler)
        logger.setLevel(level)
        logger.propagate = False
        if (os.environ.get("FT_LOG_FIRST_RANK_ONLY", "").upper() in ("1", "ON", "TRUE")
                and _rank() != 0):
            logger.setLevel(logging.ERROR)
        _configured = True
    return logger
