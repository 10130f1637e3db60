"""Numeric precision of the port's training and evaluation, on the card's
own mechanisms.

  * `strict_f32`: full float32 for matmuls and cuDNN (TF32 off), the
    parity contract of every entry point; `device_scope` is the same
    inside `torch.inference_mode()` for the inference paths, the caller's
    flags restored after;
  * training compute (`TrainHyper.compute_dtype`, `train --precision`,
    `TRAIN.PRECISION`): "bfloat16" casts both nets' parameters and the
    window inputs to bf16 inside the differentiated step
    (`cast_params` under `torch.func.functional_call`, so the float32
    master parameters receive float32 gradients through the cast), as
    `tepose_tpu/train/trainer.py` does; `parse_train_precision` takes the
    spellings and error messages of the JAX `train.py`;
  * evaluation tiers (`evaluate --precision`, the spellings of the JAX
    `evaluate.py`): "float32" is `strict_f32`, "tensorfloat32" is Hopper
    TF32 in cuBLAS and cuDNN, "bfloat16" runs the TePose and VIBE forward
    with bf16 parameters and window inputs while SMPL, the skinning kernel
    and the metrics stay float32. The TPU's tiers of the same names are
    other arithmetic (multi-pass MXU modes), so the port measures its own
    drift against a float64 run.

bf16 GEMMs accumulate in float32 on the TPU's MXU. cuBLAS may reduce
split-K partial sums in bf16 unless
`allow_bf16_reduced_precision_reduction` is off, so every bf16 path here
turns it off inside `bf16_scope` and restores the caller's setting.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Optional

import torch

TRAIN_BF16 = ("bf16", "bfloat16")
TRAIN_F32 = ("f32", "float32", "default")

EVAL_TIERS = {
    "float32": ("float32", "highest"),
    "tensorfloat32": ("tensorfloat32", "tf32", "high"),
    "bfloat16": ("bfloat16", "bf16", "default", "fast"),
}


def strict_f32() -> None:
    """Full float32 for matmuls and cuDNN (its GRUs included): TF32 keeps
    about three decimal digits, and the theta feedback compounds errors."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def parse_train_precision(value, source: str = "--precision"
                          ) -> Optional[str]:
    """`train.py`'s precision values: bf16 / bfloat16 -> "bfloat16",
    f32 / float32 / default -> None (float32); anything else exits naming
    `source`, as the JAX CLI does."""
    value = str(value)
    if value in TRAIN_BF16:
        return "bfloat16"
    if value in TRAIN_F32:
        return None
    raise SystemExit(f"unknown {source} {value!r} (choose bf16 or float32)")


def torch_dtype(name: Optional[str]) -> Optional[torch.dtype]:
    """The torch floating dtype named `name` ("bfloat16", ...), or None."""
    if name is None:
        return None
    dtype = getattr(torch, str(name), None)
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError(f"compute_dtype {name!r} is not a floating dtype")
    return dtype


def eval_tier(name: str) -> str:
    """The tier ("float32", "tensorfloat32" or "bfloat16") that `name`
    spells; unknown names exit naming the choices."""
    for tier, spellings in EVAL_TIERS.items():
        if name in spellings:
            return tier
    choices = ", ".join(s for spellings in EVAL_TIERS.values()
                        for s in spellings)
    raise SystemExit(f"unknown --precision {name!r}: choose float32 "
                     f"(default), tensorfloat32 or bfloat16 ({choices})")


def cast_params(module: torch.nn.Module,
                dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The module's parameters by name, the floating ones cast to `dtype`
    inside autograd, for `torch.func.functional_call`."""
    return {k: p.to(dtype) if p.is_floating_point() else p
            for k, p in module.named_parameters()}


@contextlib.contextmanager
def bf16_scope() -> Iterator[None]:
    """Inside, bf16 GEMMs reduce in float32 (the TPU's accumulation);
    the caller's setting comes back after."""
    m = torch.backends.cuda.matmul
    saved = m.allow_bf16_reduced_precision_reduction
    m.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        m.allow_bf16_reduced_precision_reduction = saved


@contextlib.contextmanager
def tier_scope(tier: str) -> Iterator[None]:
    """The flags of an eval tier (see `eval_tier`) inside, on top of
    `strict_f32`; the caller's flags come back after."""
    cuda, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (cuda.allow_tf32, cudnn.allow_tf32)
    try:
        cuda.allow_tf32 = cudnn.allow_tf32 = tier == "tensorfloat32"
        with (bf16_scope() if tier == "bfloat16"
              else contextlib.nullcontext()):
            yield
    finally:
        cuda.allow_tf32, cudnn.allow_tf32 = saved


@contextlib.contextmanager
def device_scope() -> Iterator[None]:
    """The inference paths' scope: `torch.inference_mode()` in strict
    float32 (`tier_scope("float32")`). Kernels are chosen at launch, so
    restoring the caller's flags before the queued work has run is safe."""
    with torch.inference_mode(), tier_scope("float32"):
        yield
