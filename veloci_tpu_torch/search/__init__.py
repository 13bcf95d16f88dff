"""Search layer: field matching, batched routing, the per-request executor,
results. Exports what ``veloci_tpu/search/__init__.py`` does.

At the package's top level ``veloci_tpu_torch.search`` is the
:func:`.executor.search` function, as in the reference; import this
package's modules with ``importlib.import_module("veloci_tpu_torch.search.batch")``
or ``from veloci_tpu_torch.search import batch``, not with a dotted
``import ... as``.
"""

from .executor import explain_plan, search, search_to_result_with_doc  # noqa: F401
from .result import (  # noqa: F401
    DocWithHit,
    Hit,
    SearchResult,
    SearchResultWithDoc,
)
