"""Keys the device sorted or selected over in the traced window, per request
answered there: the window's delta of ``TorchIndex.sorted_keys``."""

from benchmark.harness import spans

spans.install()


def read(record):
    return spans.per_request(record, lambda t: spans.work(t, "sorted_keys"))
