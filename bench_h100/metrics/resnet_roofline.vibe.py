"""`bench_h100.readers.resnet_roofline` in the vibe cell."""

from bench_h100.readers import resnet_roofline


def read(trace, info):
    return resnet_roofline(trace, info)
