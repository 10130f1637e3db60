"""The bootstrap's and the window scan's share of the TF32 peak: the slice's
FLOPs besides ResNet-50's (the windows' GRUs, regressor and SMPL and the
VIBE bootstraps, by the copied formulas) over the device time of the
kernels launched under the spans `engine.boot` and `engine.scan` times
494.5 TFLOP/s, in %: against the operations peak alone, as
`resnet_roofline` is."""

from bench_h100.spans import roofline

SPANS = ("tepose:engine.boot", "tepose:engine.scan")


def read(trace, info):
    return roofline(trace, SPANS, info["flops"] - info["resnet_flops"])
