"""Seconds from the process's start to the window, less the harness's own
work (making the traffic, starting a trace): the program's imports, corpus,
index build or read, upload, warmup and the traffic's first shapes."""


def read(record):
    return record["setup_s"]
