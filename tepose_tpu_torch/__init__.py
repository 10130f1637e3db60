"""tepose_tpu_torch — the PyTorch/CUDA port of tepose_tpu for NVIDIA Hopper.

The JAX package `tepose_tpu` is the reference: every module here names its
counterpart there and is held to it by the `tests/test_torch_*.py` parity
tests. This package imports `torch` and never `jax` (not even through
`tepose_tpu`, whose package `__init__` pulls in JAX), so the JAX-free host
helpers it needs are copies pinned equal to their originals by tests.

Ported so far: the theta-feedback eval rollout behind
`python -m tepose_tpu_torch.evaluate`, and the serving path on the device:
the ResNet-50 backbone, the lane-batched fast encoder and window scan, the
offline `streaming.engine.StreamingEngine` and the frame-at-a-time
`streaming.live.LiveSession`, and the training path behind
`python -m tepose_tpu_torch.train` (the GCN motion discriminator, the
masked LSGAN loss, the theta-feedback trainer, validation and checkpoints),
and the host CLI around them: `python -m tepose_tpu_torch.demo` (offline and
live, with the trackers, 1-euro smoothing, Temporal SMPLify and the native
rasterizer) and evaluate's `--filter`, `--render` and `--plot`, the
release tools, offline DB building, and the scale-out slice (`parallel/`):
`evaluate --devices`, `StreamingEngine(mesh=)`, `LiveSession(mesh=)` and
`FeatureExtractor(mesh=)` over a list of devices in one process, and
data-parallel training over `torch.distributed` behind `train --devices`.
Every SMPL forward that builds the mesh skins through the LBS kernel, CUDA
C++ written for sm_90a (`csrc/lbs_skinning.cu`, built by `kernels.py`);
the train step and SMPLify's objective read the vertex-free joints instead.
"""

__version__ = "0.1.0"
