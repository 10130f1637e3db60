"""`bench_h100.readers.idle_share` in the HMR 2.0 engine cell."""

from bench_h100.readers import idle_share


def read(trace, info):
    return idle_share(trace)
