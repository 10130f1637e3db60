"""tepose_tpu_torch — the PyTorch/CUDA port of tepose_tpu for NVIDIA Hopper.

The JAX package `tepose_tpu` is the reference: every module here names its
counterpart there and is held to it by the `tests/test_torch_*.py` parity
tests. This package imports `torch` and never `jax` (not even through
`tepose_tpu`, whose package `__init__` pulls in JAX), so the JAX-free host
helpers it needs are copies pinned equal to their originals by tests.

Ported so far: the theta-feedback eval rollout behind
`python -m tepose_tpu_torch.evaluate`, with the LBS skinning step as a CUDA
kernel written for sm_90a (`csrc/lbs_skinning.cu`, built by `kernels.py`).
"""

__version__ = "0.1.0"
