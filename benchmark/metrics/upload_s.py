"""Seconds to read the index directory and upload it to the device, ending
in a synchronise (host clock)."""


def read(record):
    return record["setup"].get("upload")
