"""Requests answered in the window over the window's seconds (host clock)."""


def read(record):
    w = record["window"]
    return w.answered / w.seconds if w.seconds > 0 else None
