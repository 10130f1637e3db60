"""Readings that several per-layer metrics take from a traced slice; each
metric's own reader in `metrics/` picks one."""

from __future__ import annotations

from bench_h100.flops import PEAK_FLOPS


def idle_share(trace):
    """Share of the slice in which no kernel or copy ran on the card, from
    the union of the device intervals, in %."""
    if not trace.device:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.span_s)


def mfu(trace, info):
    """The whole step's share of the card's peak: the FLOPs the slice's
    frames need by the copied formulas (`bench_h100.flops`), over the
    slice's time times the dense TF32 peak, in %."""
    if not trace.device:
        return None
    return 100.0 * info["flops"] / (trace.span_s * PEAK_FLOPS)


def resnet_roofline(trace, info):
    """ResNet-50's share of its roofline: `resnet50_flops` of the slice's
    crops over the device time of the kernels launched under
    `aten::convolution` times the dense TF32 peak, in %. The convolutions'
    arithmetic intensity puts them above the ridge, so operations bound
    them."""
    t = trace.device_s_under("aten::convolution")
    if t <= 0.0:
        return None
    return 100.0 * info["resnet_flops"] / (t * PEAK_FLOPS)
