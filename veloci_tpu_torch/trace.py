"""Tracing: logging set-up and the program's spans.

The port's copy of ``veloci_tpu/trace.py`` (reference src/trace.rs:
``enable_log``, env_logger with timestamp and file:line, idempotent; and
the ``measure_time`` macros ``info_time!`` / ``debug_time!`` /
``trace_time!``). The logger is named ``veloci_tpu_torch``.

Usage::

    from veloci_tpu_torch.trace import enable_log, info_time

    enable_log()              # or VELOCI_LOG=info in the environment
    with info_time("search"):
        ...

Each timer is a span of the program. While a ``torch.profiler`` profile is
running, it enters ``torch.profiler.record_function(label)``, so the span
sits in the profiler's trace on the clock of the device's events. While
the logger is enabled for the timer's level, it logs ``<label> took
<ms>ms`` when it ends. When neither holds, the timer is one shared
context object that does nothing: no ``record_function``, no clock read.
Nothing else turns spans on. So at ``info`` each root span below logs one
line a call: the server, which parses every request body with
``Request.from_dict`` and answers each fold with ``search_batch``, writes
a ``request.parse took`` line per request and a ``search_batch took`` line
per fold.

To get the spans, run the calls under ``torch.profiler.profile`` (with
``ProfilerActivity.CUDA`` beside ``CPU`` for the device's kernels); each
span is a user annotation of the trace. Their names are fixed. A root
span is one call into the program: ``request.parse``
(``Request.from_dict``), ``search`` (:func:`..search.executor.search`)
and ``search_batch`` (:func:`..search.batch.search_batch`, when called
directly). Every span below a root belongs to that root's call and nests
under the span that caused it, on the same thread:

* ``search.plan``: the admission of a lone request;
* ``search_batch.plan``, ``search_batch.prefetch`` (the fuzzy sweeps),
  ``search_batch.resolve`` (term lookup and routes),
  ``search_batch.answer`` (a route's gathers and sorts, with children
  ``answer.upload``, ``answer.candidates``, ``answer.num_hits``,
  ``answer.topk``, ``answer.readback`` and ``answer.emit``) and
  ``search_batch.why_found``;
* the dense executor's ``execute.leaves``, ``execute.combine``,
  ``execute.extras``, ``execute.topk`` and ``execute.emit``;
* the device sorts and gathers of ``ops/``: ``gather_runs``,
  ``tree_candidates_single``, ``_slot_entries``, ``segmented_topk`` and
  ``topk_dense``.

The work the spans do is counted on the index:
``TorchIndex.gathered_rows`` (posting rows read, by route) and
``TorchIndex.sorted_keys`` (keys the device sorts or selects over, by
route), beside ``TorchIndex.path_counts``.
"""

from __future__ import annotations

import logging
import os
import time

from torch.autograd import _profiler_enabled
from torch.autograd.profiler import record_function

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


class _Off:
    """The span while neither the profiler nor the log wants it."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    """A span on the profiler's trace (``record``), in the log (``start``
    set on entry), or both."""

    __slots__ = ("level", "label", "record", "start")

    def __init__(self, level: int, label: str, profiled: bool):
        self.level = level
        self.label = label
        self.record = record_function(label) if profiled else None
        self.start = None

    def __enter__(self):
        if self.record is not None:
            self.record.__enter__()
        if logger.isEnabledFor(self.level):
            self.start = time.perf_counter()
        return None

    def __exit__(self, *exc):
        ms = None if self.start is None else (time.perf_counter() - self.start) * 1e3
        if self.record is not None:
            self.record.__exit__(*exc)
        if ms is not None:
            logger.log(self.level, "%s took %.3fms", self.label, ms)
        return False


def _timed(level: int, label: str):
    profiled = _profiler_enabled()
    if not profiled and not logger.isEnabledFor(level):
        return _OFF
    return _Span(level, label, profiled)


def info_time(label: str):
    return _timed(logging.INFO, label)


def debug_time(label: str):
    return _timed(logging.DEBUG, label)


def trace_time(label: str):
    return _timed(TRACE, label)
