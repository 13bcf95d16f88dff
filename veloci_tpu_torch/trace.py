"""Tracing: logging set-up and scoped timers.

The port's copy of ``veloci_tpu/trace.py`` (reference src/trace.rs:
``enable_log``, env_logger with timestamp and file:line, idempotent; and
the ``measure_time`` macros ``info_time!`` / ``debug_time!`` /
``trace_time!``). The logger is named ``veloci_tpu_torch``.

Usage::

    from veloci_tpu_torch.trace import enable_log, info_time

    enable_log()              # or VELOCI_LOG=info in the environment
    with info_time("search"):
        ...

A timer logs ``<label> took <ms>ms`` at its level when it ends, and costs
one level check when the logger is not enabled for that level.
:func:`..search.executor.search` runs inside ``info_time("search")``.
"""

from __future__ import annotations

import logging
import os
import time
from contextlib import contextmanager

__all__ = ["enable_log", "info_time", "debug_time", "trace_time", "logger"]

logger = logging.getLogger("veloci_tpu_torch")
_ENABLED = False

TRACE = 5
logging.addLevelName(TRACE, "TRACE")


def enable_log(level: str | None = None) -> None:
    """Idempotent logging set-up (reference trace.rs:8-29): the level is
    ``level``, else ``VELOCI_LOG``, else warning; records go to stderr."""
    global _ENABLED
    if _ENABLED:
        return
    _ENABLED = True
    level = level or os.environ.get("VELOCI_LOG", "warning")
    numeric = {
        "trace": TRACE,
        "debug": logging.DEBUG,
        "info": logging.INFO,
        "warning": logging.WARNING,
        "error": logging.ERROR,
    }.get(level.lower(), logging.WARNING)
    handler = logging.StreamHandler()
    handler.setFormatter(
        logging.Formatter("[%(asctime)s %(levelname)s %(module)s:%(lineno)d] %(message)s")
    )
    logger.addHandler(handler)
    logger.setLevel(numeric)


@contextmanager
def _timed(level: int, label: str):
    if not logger.isEnabledFor(level):
        yield
        return
    start = time.perf_counter()
    try:
        yield
    finally:
        logger.log(level, "%s took %.3fms", label, (time.perf_counter() - start) * 1e3)


def info_time(label: str):
    return _timed(logging.INFO, label)


def debug_time(label: str):
    return _timed(logging.DEBUG, label)


def trace_time(label: str):
    return _timed(TRACE, label)
