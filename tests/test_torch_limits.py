"""Time limits for the port's tests, and tests of them.

Every ``tests/test_torch_*.py`` imports :func:`bounded` and
:func:`bounded_module` from here; as autouse fixtures they bound each test
by ``TEST_LIMIT_S`` and each module's fixtures, set up before or between
its tests, by ``SETUP_LIMIT_S`` (the slowest, a module's reference batch
on the CPU, takes up to two minutes). So a test that waits on a thread, a
socket, a lock or a child process without end fails alone, and the worker
goes on with the next test:

* At the limit, SIGALRM raises ``pytest.fail`` in the main thread. The test
  fails, named, and its message holds the stack of every thread.
* A wait that no signal breaks (the main thread inside C code) meets a
  hard limit ``HARD_GRACE_S`` later: ``faulthandler`` writes every
  thread's stack to ``hangs.log`` in the worker's pytest temporary
  directory and ends the process. pytest-xdist reports the test as
  "crashed while running" and starts a new worker for the rest.
"""

import faulthandler
import os
import signal
import subprocess
import sys
import textwrap
import threading
import traceback
from pathlib import Path

import pytest

TEST_LIMIT_S = 300.0
SETUP_LIMIT_S = 900.0
HARD_GRACE_S = 60.0

_what = ["", 0.0]  # what the armed limit bounds, and the limit
_hang_log = []  # the hard limit's file, opened once a process


def _stacks() -> str:
    names = {t.ident: t.name for t in threading.enumerate()}
    return "\n".join(f"--- thread {names.get(ident, ident)}\n" + "".join(traceback.format_stack(frame))
                     for ident, frame in sys._current_frames().items())


def _on_alarm(_signum, _frame):
    what, limit = _what
    pytest.fail(f"{what} ran past its {limit:g}-s limit; the stack of every thread:\n{_stacks()}",
                pytrace=False)


def _arm(what: str, limit: float, tmp_path_factory) -> None:
    if not _hang_log:
        _hang_log.append(open(tmp_path_factory.getbasetemp() / "hangs.log", "a"))
    _what[:] = [what, limit]
    signal.signal(signal.SIGALRM, _on_alarm)
    signal.setitimer(signal.ITIMER_REAL, limit)
    faulthandler.dump_traceback_later(limit + HARD_GRACE_S, exit=True, file=_hang_log[0])


def _disarm() -> None:
    signal.setitimer(signal.ITIMER_REAL, 0)
    faulthandler.cancel_dump_traceback_later()


@pytest.fixture(scope="module", autouse=True)
def bounded_module(request, tmp_path_factory):
    """Bounds the module's fixtures set up before its first test."""
    _arm(f"the fixtures of {request.module.__name__}", SETUP_LIMIT_S, tmp_path_factory)
    yield
    _disarm()


@pytest.fixture(autouse=True)
def bounded(request, bounded_module, tmp_path_factory):
    """Bounds the test; then, until the next test, the module fixtures set
    up or torn down in between."""
    _arm(request.node.nodeid, TEST_LIMIT_S, tmp_path_factory)
    yield
    _arm(f"the fixtures of {request.module.__name__}", SETUP_LIMIT_S, tmp_path_factory)


# ---------------------------------------------------------------- the limits at work

_STUCK = """
import signal
import threading

import test_torch_limits
from test_torch_limits import bounded, bounded_module  # noqa: F401

test_torch_limits.TEST_LIMIT_S = 1.0
test_torch_limits.HARD_GRACE_S = 2.0


def test_waits_forever():
    threading.Event().wait()


def test_deaf_to_signals():
    signal.pthread_sigmask(signal.SIG_BLOCK, [signal.SIGALRM])
    threading.Event().wait()


def test_after():
    assert True
"""


def _run_stuck(tmp_path, *args):
    (tmp_path / "test_stuck.py").write_text(textwrap.dedent(_STUCK))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(Path(__file__).parent), os.environ.get("PYTHONPATH", "")]))
    return subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", "-p", "no:randomly",
         f"--basetemp={tmp_path / 'base'}", *args, str(tmp_path / "test_stuck.py")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120,
    )


def test_a_wait_without_end_fails_alone_and_named(tmp_path):
    """The soft limit: the stuck test fails with its stack, the next runs."""
    proc = _run_stuck(tmp_path, "-k", "forever or after")
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "1 failed, 1 passed" in proc.stdout, proc.stdout
    assert "test_waits_forever ran past its 1-s limit" in proc.stdout
    assert "in test_waits_forever" in proc.stdout  # the main thread's stack


def test_a_wait_deaf_to_signals_ends_its_worker(tmp_path):
    """The hard limit: the worker ends with every stack in hangs.log;
    pytest-xdist names the test and runs the rest on a new worker."""
    proc = _run_stuck(tmp_path, "-p", "xdist", "-n", "1", "-k", "deaf or after")
    out = proc.stdout + proc.stderr
    assert proc.returncode == 1, out
    assert "crashed while running" in out and "test_deaf_to_signals" in out, out
    assert "1 failed, 1 passed" in out, out
    logs = list((tmp_path / "base").rglob("hangs.log"))
    assert any("test_deaf_to_signals" in log.read_text() for log in logs), logs
