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
written with ``Persistence.save(directory)``.
"""

from .create import add_token_values_to_tokens, create_indices_from_str
from .persistence import Persistence, TorchIndex, load_index
from .query.generator import SearchQueryGeneratorParameters, search_query, suggest_query
from .query.request import Request
from .search.batch import search_batch
from .search.executor import explain_plan, search, search_to_result_with_doc, suggest, suggest_batch
from .search.field_search import highlight_field
from .search.result import DocWithHit, Hit, SearchResult, SearchResultWithDoc

__all__ = [
    "DocWithHit",
    "Hit",
    "Persistence",
    "Request",
    "SearchQueryGeneratorParameters",
    "SearchResult",
    "SearchResultWithDoc",
    "TorchIndex",
    "add_token_values_to_tokens",
    "create_indices_from_str",
    "explain_plan",
    "highlight_field",
    "load_index",
    "search",
    "search_batch",
    "search_query",
    "search_to_result_with_doc",
    "suggest",
    "suggest_batch",
    "suggest_query",
]
