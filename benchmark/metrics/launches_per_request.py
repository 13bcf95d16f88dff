"""Device events (kernels, copies, memsets) the profiler saw in the traced
window, per request answered there."""


def read(record):
    t, w = record["trace"], record["window"]
    if not t or not w.answered or not t["device_events"]:
        return None
    return t["device_events"] / w.answered
