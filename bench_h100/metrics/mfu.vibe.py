"""`bench_h100.readers.mfu` in the vibe cell."""

from bench_h100.readers import mfu


def read(trace, info):
    return mfu(trace, info)
