"""Run a reference test file on the port.

``rebind("test_minimal", globals())`` reads ``tests/test_minimal.py``,
replaces the module name ``veloci_tpu`` by ``veloci_tpu_torch`` (whole
words: imports, ``python -m veloci_tpu.cli`` in subprocess calls) and
``tests.corpus`` by ``corpus``, and executes the result into the calling
test module's namespace, so that pytest collects its tests and fixtures as
that module's own. The reference file itself is not changed. ``omit``
names cases (test functions) of the file that are not run on the port, each
with its reason; every name must be a case of the file.

Beside them the module gets a module-scoped autouse fixture that makes the
CPU the port's default device for its tests (``set_default_device("cpu")``)
and restores the old default afterwards, and the time limits of
``test_torch_limits``.
"""

import re
from pathlib import Path
from typing import Dict, Optional

import pytest

from test_torch_limits import bounded, bounded_module  # noqa: F401 -- re-exported into each rebound module
from veloci_tpu_torch.persistence import default_device, set_default_device

TESTS = Path(__file__).resolve().parent


def rebind_source(text: str) -> str:
    """The reference test file's text, bound to the port."""
    text = re.sub(r"\btests\.corpus\b", "corpus", text)
    return re.sub(r"\bveloci_tpu\b", "veloci_tpu_torch", text)


@pytest.fixture(scope="module", autouse=True)
def on_the_cpu():
    """The port's entry points default to the CPU for this module's tests."""
    old = default_device()
    set_default_device("cpu")
    yield
    set_default_device(old)


def rebind(name: str, namespace: dict, omit: Optional[Dict[str, str]] = None) -> None:
    """Execute ``tests/<name>.py``, bound to the port, into ``namespace``,
    without the cases named in ``omit`` (case name -> reason)."""
    path = TESTS / f"{name}.py"
    exec(compile(rebind_source(path.read_text()), str(path), "exec"), namespace)
    for case, reason in (omit or {}).items():
        if not (case.startswith("test_") and callable(namespace.get(case)) and reason):
            raise ValueError(f"omit: {case!r} is not a case of tests/{name}.py, or has no reason")
        del namespace[case]
    namespace.update(on_the_cpu=on_the_cpu, bounded=bounded, bounded_module=bounded_module)
