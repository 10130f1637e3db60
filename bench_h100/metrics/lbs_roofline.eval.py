"""The skinning kernel's share of its bound: the least time of every launch
the traced chunk makes (`bench_h100.flops.lbs_bound_s` at each launch's
batch, which the chunk's shape fixes) over the kernel's device time, in %.
Nothing is read where the trace does not hold exactly those launches."""

from bench_h100.flops import lbs_bound_s


def read(trace, info):
    times = [e - s for name, s, e in trace.kernels if "lbs_skin" in name]
    sizes = info["lbs_batches"]
    if not times or len(times) != len(sizes):
        return None
    return 100.0 * sum(lbs_bound_s(B) for B in sizes) / sum(times)
