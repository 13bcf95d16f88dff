"""The host's blocking waits on the device inside the program's calls, ms
per request answered in the traced window: synchronise calls and copies
from device to host inside the root spans (``harness/spans.py``)."""

from benchmark.harness import spans

spans.install()


def read(record):
    seconds = spans.per_request(record, spans.root_wait_s)
    return None if seconds is None else 1e3 * seconds
