"""The cases and generator requests of ``test_torch_generic.py`` on the
document-sharded mesh, against the port's unsharded index, on a ``[1, 8]``
and a ``[2, 4]`` mesh of CPU devices, through ``search`` and
``search_batch`` (:mod:`mesh_suites`; the executor's cases are in
``test_torch_mesh_suites.py``).

Tolerance: exact: ids, order, ``num_hits``, facet lists, the f32 bits of
every score, and the raised error's type.
"""

import test_torch_generic as tg
import pytest

import mesh_suites
from test_torch_limits import bounded, bounded_module  # noqa: F401 -- a time limit on each test and module fixture


@pytest.fixture(scope="module")
def answers():
    return mesh_suites.detached_answers(tg)


@pytest.mark.parametrize("shape", list(mesh_suites.SHAPES.values()), ids=list(mesh_suites.SHAPES))
def test_suite_cases_on_the_mesh_equal_detached(answers, shape):
    mesh_suites.check_on_mesh(answers, shape)
