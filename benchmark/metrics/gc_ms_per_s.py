"""Milliseconds the interpreter spent in full (generation-2) collections
per second of the window, from the harness's gc callback."""


def read(record):
    w = record["window"]
    return w.gc_ms / w.seconds if w.seconds > 0 else None
