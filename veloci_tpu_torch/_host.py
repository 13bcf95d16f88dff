"""JAX-free access to the reference package's host layers.

The index builder, the on-disk format, the term dictionary and the request
model in ``veloci_tpu/`` are plain numpy, but importing any of them as
``veloci_tpu.<module>`` runs ``veloci_tpu/__init__.py``, which imports the
search executor and with it JAX. This module registers a private alias
package, ``veloci_tpu_torch._ref``, whose ``__path__`` is the
``veloci_tpu/`` directory and whose ``__init__`` never runs. Modules
imported through it resolve their relative imports inside the alias, so the
host code is shared, not copied, and the real ``veloci_tpu`` package in
``sys.modules`` is neither imported nor replaced.

The alias's ``search`` sub-package is registered the same way: its
``__init__`` imports the JAX executor, but the query generator imports
``search.stopwords`` from it. Only modules without a module-level JAX
import may be reached this way (``create``, ``persistence``, ``indices``,
``query.request``, ``query.generator``, ``query.parser``,
``search.stopwords``, ``error`` and what they import);
``Persistence.load`` and the device accessors of ``Persistence`` import
JAX when called and are never called by the port.
"""

from __future__ import annotations

import importlib
import importlib.util
import sys
from pathlib import Path

REF_DIR = Path(__file__).resolve().parent.parent / "veloci_tpu"
ALIAS = __name__.rsplit(".", 1)[0] + "._ref"


def _alias_package(name: str = ALIAS, directory: Path = REF_DIR):
    """Register ``directory`` as the package ``name`` without running its
    ``__init__``."""
    pkg = sys.modules.get(name)
    if pkg is None:
        spec = importlib.util.spec_from_file_location(
            name, directory / "__init__.py", submodule_search_locations=[str(directory)]
        )
        pkg = importlib.util.module_from_spec(spec)  # __init__ is not executed
        sys.modules[name] = pkg
    return pkg


def ref_module(name: str):
    """Import ``veloci_tpu/<name>.py`` through the alias package."""
    _alias_package()
    _alias_package(f"{ALIAS}.search", REF_DIR / "search")
    return importlib.import_module(f"{ALIAS}.{name}")


create = ref_module("create")
indices = ref_module("indices")
persistence = ref_module("persistence")
request = ref_module("query.request")
generator = ref_module("query.generator")
error = ref_module("error")
