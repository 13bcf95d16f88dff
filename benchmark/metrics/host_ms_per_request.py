"""The host's time in the program's calls, ms per request answered in the
traced window: the root spans' time (``request.parse``, ``search``) less
the blocking waits on the device inside them (``harness/spans.py``)."""

from benchmark.harness import spans

spans.install()


def read(record):
    seconds = spans.per_request(record, spans.root_host_s)
    return None if seconds is None else 1e3 * seconds
