"""veloci_tpu_torch — the PyTorch + CUDA port of veloci_tpu, for one NVIDIA H100.

The JAX package ``veloci_tpu/`` is the reference; this package answers the
same requests on a torch device and never imports JAX. Its host layers
(index build, on-disk format, term dictionaries, request model) are the
reference package's own modules, reached through :mod:`._host` without
running ``veloci_tpu/__init__.py``.

Current slice: :func:`search_batch` over requests whose tree is a search
leaf, a flat OR or AND, an AND of ORs, or an OR of such ANDs, with leaves
that are exact, fuzzy at any distance, or ``starts_with`` -- which covers
the query generator's output for query strings with ``*`` wildcards. The
Levenshtein sweeps are hand-written CUDA kernels
(``csrc/banded_levenshtein.cu``, ``csrc/full_levenshtein.cu``). Other
request shapes raise ``NotImplementedError``.

    index = load_index("path/to/index", "cuda")
    results = search_batch([Request.from_dict(d) for d in dicts], index)
    query = search_query(index, SearchQueryGeneratorParameters(search_term="haus AND bu*"))
    results = search_batch([query], index)

``Request``, ``SearchQueryGeneratorParameters`` and ``search_query`` are the
reference's own objects.
"""

from ._host import generator as _generator
from ._host import request as _request
from .persistence import TorchIndex, load_index, read_persistence
from .search.batch import search_batch
from .search.result import Hit, SearchResult

Request = _request.Request
SearchQueryGeneratorParameters = _generator.SearchQueryGeneratorParameters
search_query = _generator.search_query

__all__ = [
    "Hit",
    "Request",
    "SearchQueryGeneratorParameters",
    "SearchResult",
    "TorchIndex",
    "load_index",
    "read_persistence",
    "search_batch",
    "search_query",
]
