"""VIBE's temporal head's share of the TF32 peak: the slice's FLOPs besides
ResNet-50's (the GRU, the linear, the regressor and SMPL, by the copied
formulas) over the device time of the kernels launched under the span
`vibe.temporal` times 494.5 TFLOP/s, in %."""

from bench_h100.spans import roofline

SPANS = ("tepose:vibe.temporal",)


def read(trace, info):
    return roofline(trace, SPANS, info["flops"] - info["resnet_flops"])
