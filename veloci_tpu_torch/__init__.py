"""veloci_tpu_torch — the PyTorch + CUDA port of veloci_tpu, for one NVIDIA H100.

The JAX package ``veloci_tpu/`` is the reference; this package answers the
same requests on a torch device, imports neither JAX nor anything of the
reference package, and runs without it. Its host layers (index build with
the native indexer, on-disk format, term dictionaries, request model, query
generator) are its own copies of the reference's, writing and reading the
same index files and building the same request trees.

Current slice: :func:`search_batch` answers requests whose tree is a
search leaf, a flat OR or AND, an AND of ORs, or an OR of such ANDs, with
leaves that are exact, fuzzy at any distance, or ``starts_with``, with or
without token-value boosts -- which covers the query generator's output for
query strings with ``*`` wildcards at the end -- and with filters, boost
columns, facets and phrase boosts, on its batched tree routes. :func:`search`
answers one request: on those routes when they take it, else (deep trees,
leaves with several terms, leaf and node boost options, 1:n boosts, facet
fields past the batched gates, regex leaves -- a ``*`` inside a query-string
word -- and leaves that ask for snippets) on the per-request dense
executor, which ``search_batch`` also hands such requests to, with
``boost_term`` and ``text_locality`` requests. ``why_found`` rides either
route. :func:`search_to_result_with_doc` reads a result's documents back
(whole, or the ``select`` fields), and :func:`highlight_field` gives a
field's snippets. :func:`suggest` and :func:`suggest_batch` answer suggest
requests (:func:`suggest_query` builds one from a prefix), and
:meth:`TorchIndex.warmup` readies an index for its first request. The
Levenshtein sweeps, the regex DFA walk and the executor's dense posting
resolve are hand-written CUDA kernels (``csrc/banded_levenshtein.cu``,
``csrc/full_levenshtein.cu``, ``csrc/regex_dfa.cu``,
``csrc/dense_resolve.cu``). ``explain``, on a request or in a leaf's
options, is answered on the dense executor, and :func:`explain_plan`
renders a request's plan. ``server.py`` serves an index over HTTP and
``cli.py`` builds and serves one
(``python -m veloci_tpu_torch.cli serve <db> --device cuda``).

    result = search(Request.from_dict(d), Persistence.create_from_str(ndjson, config))  # the reference's call
    index = load_index("path/to/index")  # on the card; load_index(path, "cpu") on the CPU
    results = search_batch([Request.from_dict(d) for d in dicts], index)
    result = search(Request.from_dict(d), index)
    with_docs = search_to_result_with_doc(index, result, select=["title"])
    query = search_query(index, SearchQueryGeneratorParameters(search_term="haus AND bu*"))
    results = search_batch([query], index)
    index.warmup()  # once, after load
    suggestions = suggest(index, suggest_query("hau", index, fields=["title"]))
    plan = explain_plan(Request.from_dict(d), index)

An index is built with ``Persistence.create_from_str(ndjson, config)`` (or
``Persistence.from_built(create_indices_from_str(ndjson, config))``) and
written with ``Persistence.save(directory)``. Every entry point takes that
``Persistence`` as the reference's do, and answers on its upload, made once
on the default device: the card, unless :func:`set_default_device` names
another (``set_default_device("cpu")`` for the CPU). ``trace.enable_log``
with ``VELOCI_LOG=info`` logs each ``search``'s time.

The package's names are loaded at first use (PEP 562), so that a command
that needs no torch, such as the CLI's ``test_very_large_index``, does not
import it.
"""

import importlib
import sys
import types

_FROM = {  # each public name -> the module of this package that defines it
    "add_token_values_to_tokens": ".create",
    "create_indices_from_str": ".create",
    "VelociError": ".error",
    "to_line_delimited": ".json_flatten",
    "Persistence": ".persistence",
    "TorchIndex": ".persistence",
    "default_device": ".persistence",
    "load_index": ".persistence",
    "set_default_device": ".persistence",
    "SearchQueryGeneratorParameters": ".query.generator",
    "search_query": ".query.generator",
    "suggest_query": ".query.generator",
    "FacetRequest": ".query.request",
    "Request": ".query.request",
    "RequestBoostPart": ".query.request",
    "RequestPhraseBoost": ".query.request",
    "RequestSearchPart": ".query.request",
    "SearchRequest": ".query.request",
    "search_batch": ".search.batch",
    "explain_plan": ".search.executor",
    "search": ".search.executor",
    "search_to_result_with_doc": ".search.executor",
    "suggest": ".search.executor",
    "suggest_batch": ".search.executor",
    "highlight_field": ".search.field_search",
    "DocWithHit": ".search.result",
    "Hit": ".search.result",
    "SearchResult": ".search.result",
    "SearchResultWithDoc": ".search.result",
}


def __getattr__(name):
    module = _FROM.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(module, __name__), name)
    globals()[name] = value
    return value


class _Package(types.ModuleType):
    """This package's module type. Importing the ``search`` subpackage sets
    the package's ``search`` to it; the name stays the function, as in the
    reference, whose ``__init__`` imports the function after the
    subpackage."""

    def __setattr__(self, name, value):
        if name == "search" and isinstance(value, types.ModuleType):
            value = value.search
        super().__setattr__(name, value)


sys.modules[__name__].__class__ = _Package

__version__ = "0.1.0"

__all__ = [
    "DocWithHit",
    "FacetRequest",
    "Hit",
    "Persistence",
    "Request",
    "RequestBoostPart",
    "RequestPhraseBoost",
    "RequestSearchPart",
    "SearchQueryGeneratorParameters",
    "SearchRequest",
    "SearchResult",
    "SearchResultWithDoc",
    "TorchIndex",
    "VelociError",
    "__version__",
    "add_token_values_to_tokens",
    "create_indices_from_str",
    "default_device",
    "explain_plan",
    "highlight_field",
    "load_index",
    "search",
    "search_batch",
    "search_query",
    "search_to_result_with_doc",
    "set_default_device",
    "suggest",
    "suggest_batch",
    "suggest_query",
    "to_line_delimited",
]
