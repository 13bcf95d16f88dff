"""The kernel build's first use under threads (``veloci_tpu_torch/ops/_build.py``).

Server threads that reach a kernel first all call ``_build.load`` at once.
With ``build_all`` and the library loader stubbed (the CPU has no ``nvcc``),
one build runs and every thread gets the same library; and the build's
temporary files are named apart per thread, so two builds in one process
never write one path.
"""

import threading
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

from veloci_tpu_torch.ops import _build


class _FakeLib:
    """A loaded library: every symbol an object that takes argument types."""

    def __getattr__(self, name):
        fn = SimpleNamespace()
        object.__setattr__(self, name, fn)
        return fn


@pytest.mark.parametrize("threads", [2, 8, 32])
def test_load_builds_once_under_threads(monkeypatch, threads):
    builds, loads = [], []

    def build_all(sources=None):
        builds.append(list(sources))
        time.sleep(0.05)  # wide enough for every thread to arrive meanwhile
        return {s: Path(f"/nonexistent/{s}.so") for s in sources}

    def cdll(path):
        loads.append(path)
        return _FakeLib()

    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "build_all", build_all)
    monkeypatch.setattr(_build.ctypes, "CDLL", cdll)
    barrier = threading.Barrier(threads)
    got = [None] * threads

    def first_use(i):
        barrier.wait()
        got[i] = _build.load("fake.cu", {"veloci_fake": []})

    workers = [threading.Thread(target=first_use, args=(i,)) for i in range(threads)]
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout=60)
    assert not any(w.is_alive() for w in workers)
    assert builds == [["fake.cu"]] and len(loads) == 1
    assert all(lib is got[0] for lib in got) and got[0] is not None
    assert got[0].veloci_fake.argtypes == []
    assert _build.load("fake.cu", {}) is got[0]


def test_build_temporaries_are_named_per_thread(monkeypatch, tmp_path):
    """Two threads building one source at once write two temporary paths."""
    started = []
    both = threading.Barrier(2, timeout=30)  # both builds run at once (a thread id is reused after its exit)

    class Proc:
        returncode = 1  # a failed build: nothing is renamed into place

        def __init__(self, cmd, **_kw):
            started.append(cmd[cmd.index("-o") + 1])

        def communicate(self):
            both.wait()
            return "stub", None

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", Proc)
    source = sorted(p.name for p in _build.CSRC.glob("*.cu"))[0]
    errors = []

    def build():
        try:
            _build.build_all([source])
        except RuntimeError as e:
            errors.append(str(e))

    workers = [threading.Thread(target=build) for _ in range(2)]
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout=60)
    assert not any(w.is_alive() for w in workers)
    assert len(started) == 2 and len(set(started)) == 2, started
    assert len(errors) == 2 and all("nvcc failed" in e for e in errors)
