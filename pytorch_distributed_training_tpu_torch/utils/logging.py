"""Rank-0-gated logging (counterpart: the JAX package's ``utils/logging.py``).

``get_logger`` returns an ordinary logger writing to stderr with the
process rank in every line; ``log0`` logs on rank 0 only. The rank comes
from ``torch.distributed`` when a process group is up, else 0.
``PDT_TPU_LOG_LEVEL`` sets the level, as in the JAX package.
``set_log_format("json")`` (``--log-format json``) switches every logger
made here to one JSON object a line (``ts``, ``level``, ``logger``,
``process``, ``msg``: JAX's keys).
"""

from __future__ import annotations

import json
import logging
import os
import sys

_FORMATS = ("text", "json")
_TEXT_FMT = "[%(asctime)s %(levelname)s p%(pindex)s %(name)s] %(message)s"
_current_format = "text"
_configured: set[str] = set()  # logger names whose handlers we own


def current_rank() -> int:
    """This process's rank (JAX's ``process_index``), 0 without a group."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


class _ProcessIndexFilter(logging.Filter):
    def filter(self, record: logging.LogRecord) -> bool:
        record.pindex = current_rank()
        return True


class _JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        return json.dumps({
            "ts": record.created,
            "level": record.levelname,
            "logger": record.name,
            "process": getattr(record, "pindex", 0),
            "msg": record.getMessage(),
        })


def _make_formatter() -> logging.Formatter:
    if _current_format == "json":
        return _JsonFormatter()
    return logging.Formatter(_TEXT_FMT)


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
        handler.setFormatter(_make_formatter())
        logger.addHandler(handler)
        logger.setLevel(_resolve_level())
        logger.propagate = False
        _configured.add(name)
    return logger


def set_log_format(fmt: str) -> None:
    """Switch the loggers made here, now and later, between text lines
    and JSON records."""
    global _current_format
    if fmt not in _FORMATS:
        raise ValueError(f"log format must be one of {_FORMATS}, got {fmt!r}")
    _current_format = fmt
    for name in _configured:
        for handler in logging.getLogger(name).handlers:
            handler.setFormatter(_make_formatter())


def log0(msg: str, *args, logger: logging.Logger | None = None) -> None:
    """Log on rank 0 only."""
    if current_rank() == 0:
        (logger or get_logger()).info(msg, *args)
