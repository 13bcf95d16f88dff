"""Posting rows the device gathered in the traced window, per request
answered there: the window's delta of ``TorchIndex.gathered_rows``."""

from benchmark.harness import spans

spans.install()


def read(record):
    return spans.per_request(record, lambda t: spans.work(t, "gathered_rows"))
