"""Seconds in ``TorchIndex.warmup``, ending in a synchronise (host clock)."""


def read(record):
    return record["setup"].get("warmup")
