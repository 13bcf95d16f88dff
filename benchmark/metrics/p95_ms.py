"""The 95th percentile of every answered request's latency in the window,
ms (host clock): in a batch cell each request takes its batch's time."""

import numpy as np


def read(record):
    lat = record["window"].request_latencies_ms()
    return float(np.percentile(lat, 95)) if len(lat) else None
