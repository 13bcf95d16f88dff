"""Query layer: request model, query-language parser, request generator
(the port's copies of ``veloci_tpu/query/``)."""
