"""The benchmark of veloci_tpu_torch: one cell a run (``run.py``)."""
