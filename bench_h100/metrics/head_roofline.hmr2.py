"""The head's share of the TF32 peak: the transformer decoder's and SMPL's
FLOPs (`hmr2_head_flops`, `smpl_flops`) of the crops the program counted
over the device time of the kernels launched under the span `hmr2.head`
(the decoder, 6D to theta, SMPL with the skinning kernel, the projection)
times 494.5 TFLOP/s, in %."""

from bench_h100.spans import roofline

SPANS = ("tepose:hmr2.head",)


def read(trace, info):
    if info.get("head_flops") is None:
        return None
    return roofline(trace, SPANS, info["head_flops"])
