"""`bench_h100.readers.mfu` in the eval cell."""

from bench_h100.readers import mfu


def read(trace, info):
    return mfu(trace, info)
