"""`bench_h100.readers.mfu` in the HMR 2.0 engine cell: the ViT's, the
head's and SMPL's FLOPs (`bench_h100/flops_hmr2.py`) of the crops the
program's counter `HMR2_STATS` counted in the slice, over the slice's time
times 494.5 TFLOP/s, in %; nothing where the program has no such counter."""

from bench_h100.readers import mfu


def read(trace, info):
    if info.get("flops") is None:
        return None
    return mfu(trace, info)
