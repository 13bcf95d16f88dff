"""``tests/test_units.py`` run on the port (``tests/torch_rebind.py``), but
for six cases, each left out for the reason beside it: five import ``jax``
and a JAX-only entry of the reference that the port does not copy (ROADMAP,
"Names of the JAX package the port does not copy"), one asserts the
reference's route labels (ROADMAP C13)."""
from torch_rebind import rebind

OMIT = {
    "test_levenshtein_sweep_matches_host":
        "imports jax and veloci_tpu.ops.levenshtein.levenshtein_sweep, the XLA sweep; the port's sweeps "
        "are held to the Pallas kernels and to the host distances by tests/test_torch_levenshtein.py "
        "and tests/test_torch_bitparallel.py",
    "test_fused_banded_fuzzy_parity":
        "imports jax and veloci_tpu.ops.fuzzy_step (the fused one-request banded program); "
        "tests/test_torch_resolve_select.py holds B2's port to the Pallas single-query kernel",
    "test_batched_banded_fuzzy_parity":
        "imports jax and veloci_tpu.ops.fuzzy_step's batched banded program and its XLA twin; "
        "tests/test_torch_levenshtein.py holds B1's port to the Pallas batch kernel",
    "test_dynlen_banded_batch_parity":
        "imports jax and veloci_tpu.ops.pallas_levenshtein's banded batch with its static unroll; "
        "tests/test_torch_levenshtein.py holds B1's port to the same Pallas kernel",
    "test_block_gather_matches_element_gather":
        "imports jax and veloci_tpu.ops.search_step._gather_postings, the XLA block gather; the port "
        "gathers its packed runs with ops/search_step.gather_runs, held by tests/test_torch_search.py",
    "test_explain_plan_renders_compiler_structure":
        "asserts the reference's route labels ('execution path: host tree' or 'device tree'); the "
        "port's explain_plan names its own routes (ROADMAP C13), and "
        "tests/test_torch_explain.py::test_explain_plan_renders_compiler_structure keeps the case's "
        "other assertions on the port",
}

rebind("test_units", globals(), omit=OMIT)
