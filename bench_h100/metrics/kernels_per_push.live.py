"""Kernels the card ran in the traced ticks, copies left out, over the
ticks' pushes."""


def read(trace, info):
    if not trace.device:
        return None
    return len(trace.kernels) / info["pushes"]
