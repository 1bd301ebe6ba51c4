"""Leveled logging with the reference's message style.

The reference logs with raw printf and ``[INFO]``/``[ERROR]``/``[TIME]``
prefixes and no verbosity control (reference PumiTallyImpl.cpp:23-28,
292-294, 445, 536). We keep the exact prefix style — host-app log
scrapers keyed on it keep working — but route through ``logging`` with
a settable level (env ``PUMIUMTALLY_LOG`` or ``set_verbosity``).
"""

from __future__ import annotations

import logging
import os
import sys

_LOGGER_NAME = "pumiumtally_tpu_torch"
_PREFIXES = {
    logging.DEBUG: "[DEBUG]",
    logging.INFO: "[INFO]",
    logging.WARNING: "[WARNING]",
    logging.ERROR: "[ERROR]",
    logging.CRITICAL: "[CRITICAL]",
}


class _PrefixFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        prefix = _PREFIXES.get(record.levelno, f"[{record.levelname}]")
        return f"{prefix} {record.getMessage()}"


class _CurrentStderrHandler(logging.StreamHandler):
    """StreamHandler resolving ``sys.stderr`` at EMIT time.

    The module logger installs its handler once per process; a handler
    holding the stream OBJECT captured at that moment writes past any
    later ``sys.stderr`` replacement — pytest's capsys among them, which
    made test outcomes depend on whether an earlier test had already
    touched the logger (e.g. the bf16 block-kernel reroute logs during
    engine construction)."""

    def __init__(self) -> None:
        super().__init__(sys.stderr)

    @property
    def stream(self):
        return sys.stderr

    @stream.setter
    def stream(self, value) -> None:
        # The base __init__ (and setStream) assign the captured object;
        # discard it — the property above always answers with the
        # CURRENT sys.stderr.
        pass


def get_logger() -> logging.Logger:
    logger = logging.getLogger(_LOGGER_NAME)
    if not logger.handlers:
        handler = _CurrentStderrHandler()
        handler.setFormatter(_PrefixFormatter())
        logger.addHandler(handler)
        logger.propagate = False
        level = os.environ.get("PUMIUMTALLY_LOG", "INFO").upper()
        logger.setLevel(getattr(logging, level, logging.INFO))
    return logger


def set_verbosity(level: str) -> None:
    """'DEBUG' | 'INFO' | 'WARNING' | 'ERROR' | 'CRITICAL'."""
    get_logger().setLevel(getattr(logging, level.upper()))
