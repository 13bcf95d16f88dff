"""Shared by ``test_torch_mesh_suites*.py``: a port suite's corpus, its
requests and their detached answers, and the check of those answers on
the document-sharded mesh. Each corpus has a test file of its own, so
that the runner's workers take the corpora side by side.

Tolerance: exact: ids, order, ``num_hits``, facet lists, the f32 bits of
every score, and the raised error's type.
"""

import test_torch_executor as te
import test_torch_generic as tg

import veloci_tpu_torch as vt
from corpus import TOKEN_VALUES, data_ndjson
from test_torch_mesh import _bits, _cpu_mesh
from veloci_tpu_torch import Persistence as PortPersistence
from veloci_tpu_torch import TorchIndex, create_indices_from_str

SHAPES = {"d8": (8, 1), "q2xd4": (4, 2)}


def _index(mod):
    """The suite's corpus built by the port, on the CPU."""
    if mod is te:
        p = PortPersistence.from_built(create_indices_from_str(data_ndjson(), te.CONFIG))
        vt.add_token_values_to_tokens(p, *TOKEN_VALUES)
    elif mod is tg:
        p = PortPersistence.from_built(create_indices_from_str(tg._corpus(), tg.CONFIG))
        vt.add_token_values_to_tokens(p, *tg._token_values())
    else:
        p = PortPersistence.from_built(create_indices_from_str(mod._corpus(), "{}"))
    return TorchIndex.from_persistence(p, "cpu")


def _names(mod):
    return list(te.CASES) if mod is te else list(mod.CASES) + list(mod.GENERATED)


def _request(mod, index, name):
    return vt.Request.from_dict(te.CASES[name]) if mod is te else mod._port_request(index, name)


def _calls(mod, index):
    calls = {"search": lambda r: vt.search(r, index)}
    if mod is te:
        calls["dense_only"] = lambda r: vt.search(r, index, dense_only=True)
    return calls


def detached_answers(mod):
    """The suite's index, case names, requests, the requests that do not
    raise, and their detached answers: one ``search_batch`` of the latter,
    and, on the executor corpus, each request through ``search`` and
    ``search(dense_only=True)`` (on the other two a lone request's answer
    is its answer in the batch, which their own test files hold)."""
    index = _index(mod)
    names = _names(mod)
    reqs = [_request(mod, index, n) for n in names]
    if mod is te:  # its cases include requests that raise
        want = {k: [_bits(tg._outcome(lambda: f(r))) for r in reqs] for k, f in _calls(mod, index).items()}
        ok = [r for r, w in zip(reqs, want["search"]) if not isinstance(w, str)]
        want["batch"] = [_bits(r) for r in vt.search_batch(ok, index)]
    else:
        ok = reqs
        want = {"batch": [_bits(r) for r in vt.search_batch(reqs, index)]}
        want["search"] = want["batch"]
    return mod, index, names, reqs, ok, want


def check_on_mesh(answers, shape):
    """Every request of the suite on a mesh of ``shape`` (d, q), through
    each call and one ``search_batch``, equals its detached answer."""
    mod, index, names, reqs, ok, want = answers
    index.attach_mesh(_cpu_mesh(*shape))
    try:
        for k, f in _calls(mod, index).items():
            got = [_bits(tg._outcome(lambda: f(r))) for r in reqs]
            assert got == want[k], [n for n, g, w in zip(names, got, want[k]) if g != w]
        assert [_bits(r) for r in vt.search_batch(ok, index)] == want["batch"]
    finally:
        index.detach_mesh()
