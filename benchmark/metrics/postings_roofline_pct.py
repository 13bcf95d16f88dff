"""The least time the card could take for the traced window's requests
over the time it was busy, in %: 8 bytes a posting row of each (term,
field) the requests' leaves match, as the reference index counts them,
and 4 a hit written, over the card's memory bandwidth. A lower bound."""


def read(record):
    t, peak, nbytes = record["trace"], record["peak_bytes_per_s"], record["postings_bytes"]
    if not t or not peak or not nbytes or t["busy_s"] <= 0:
        return None
    return 100.0 * nbytes / peak / t["busy_s"]
