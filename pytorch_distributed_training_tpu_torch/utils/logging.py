"""Rank-0-gated logging (counterpart: the JAX package's ``utils/logging.py``).

``get_logger`` returns an ordinary logger writing to stderr with the
process rank in every line; ``log0`` logs on rank 0 only. The rank comes
from ``torch.distributed`` when a process group is up, else 0.
``PDT_TPU_LOG_LEVEL`` sets the level, as in the JAX package.
"""

from __future__ import annotations

import logging
import os
import sys

_TEXT_FMT = "[%(asctime)s %(levelname)s p%(pindex)s %(name)s] %(message)s"


def _process_index() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


class _ProcessIndexFilter(logging.Filter):
    def filter(self, record: logging.LogRecord) -> bool:
        record.pindex = _process_index()
        return True


def _resolve_level() -> int:
    raw = os.environ.get("PDT_TPU_LOG_LEVEL", "").strip()
    if not raw:
        return logging.INFO
    if raw.isdigit():
        return int(raw)
    level = logging.getLevelName(raw.upper())
    return level if isinstance(level, int) else logging.INFO


def get_logger(name: str = "pdt_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        # stderr, not stdout: the stdio server owns stdout for its JSONL
        handler = logging.StreamHandler(sys.stderr)
        handler.addFilter(_ProcessIndexFilter())
        handler.setFormatter(logging.Formatter(_TEXT_FMT))
        logger.addHandler(handler)
        logger.setLevel(_resolve_level())
        logger.propagate = False
    return logger


def log0(msg: str, *args, logger: logging.Logger | None = None) -> None:
    """Log on rank 0 only."""
    if _process_index() == 0:
        (logger or get_logger()).info(msg, *args)
