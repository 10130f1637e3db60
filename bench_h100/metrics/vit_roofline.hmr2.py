"""The ViT's share of the TF32 peak: `vit_flops` of the crops the program
counted over the device time of the kernels launched under the span
`hmr2.backbone` (CUPTI's overhead copies left out) times 494.5 TFLOP/s,
in %. Its products put it above the ridge, so operations bound it."""

from bench_h100.spans import roofline

SPANS = ("tepose:hmr2.backbone",)


def read(trace, info):
    if info.get("vit_flops") is None:
        return None
    return roofline(trace, SPANS, info["vit_flops"])
