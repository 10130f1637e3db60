"""Offline preprocessing primitives: per-frame feature extraction.

Port of `tepose_tpu/data/preprocess.py::FeatureExtractor` (ref:
lib/data_utils/_feature_extractor.py:30-114): the frozen SPIN ResNet-50
over bbox crops gives the (N, 2048) feature tracks every DB stores. The
backbone stays on its device; uint8 crops from the native C++ cropper are
uploaded and normalised there. The JAX version's `conv_chunk` (a `lax.map`
over chunks sized for the TPU's VMEM), its flat-packed weights (for the
remote link) and its zero-padded last batch (for `jit`'s fixed shapes) have
no counterpart: each call runs `batch_size` crops, the last one the crops
that are left. With `mesh=` (a `parallel.mesh.Mesh`) the backbone is
replicated onto its devices and each batch splits into contiguous blocks,
one a device (`batch_size` must divide over the mesh), as the JAX
extractor shards each batch; the features come back in crop order.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from tepose_tpu_torch.models.backbone import (
    FEAT_DIM, ResNet50, normalize_crop, resnet50_features)
from tepose_tpu_torch.native import crop_normalize
from tepose_tpu_torch.parallel.mesh import gather_rows, replicate, row_blocks
from tepose_tpu_torch.streaming.engine import device_scope, upload


def read_rgb(path: str) -> np.ndarray:
    """An image file as RGB uint8 (H, W, 3), read by OpenCV as the JAX
    extractor reads it."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            "reading image files needs OpenCV (cv2), which is not "
            "installed: pass extract_from_images an `imread` callable that "
            "returns an RGB uint8 (H, W, 3) array for a path") from e
    img = cv2.imread(path)
    if img is None:
        raise FileNotFoundError(f"cv2 could not read {path}")
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


class FeatureExtractor:
    """Batched crop -> ResNet-50 feature pipeline on the backbone's device,
    in strict float32 (TF32 off for cuDNN's convolutions)."""

    def __init__(self, backbone: ResNet50, batch_size: int = 256,
                 crop_size: int = 224, mesh=None):
        if mesh is not None and batch_size % mesh.size:
            raise ValueError(f"batch_size {batch_size} must divide over the "
                             f"{mesh.size}-device mesh")
        self.backbone = backbone
        self.batch_size = batch_size
        self.crop_size = crop_size
        self.device = backbone.stem.w.device
        # each replica's rows of a batch, as the JAX extractor shards the
        # (padded) batch: a ragged last batch leaves the later blocks short
        # or empty
        self._replicas = ([backbone] if mesh is None
                          else replicate(backbone, mesh))
        self._blocks = ([slice(0, batch_size)] if mesh is None
                        else row_blocks(batch_size, mesh))

    def features_from_crops(self, crops: np.ndarray) -> np.ndarray:
        """(N, 3, S, S) -> (N, 2048) float32; uint8 crops normalise on the
        device. The batches are queued back to back, each split over the
        mesh's devices, and read back once at the end."""
        N, B = len(crops), self.batch_size
        if N == 0:
            return np.zeros((0, FEAT_DIM), np.float32)
        parts = []
        with device_scope():
            for i in range(0, N, B):
                batch = crops[i:i + B]
                for model, rows in zip(self._replicas, self._blocks):
                    if not len(batch[rows]):
                        continue
                    x = upload(batch[rows], model.stem.w.device)
                    if x.dtype == torch.uint8:
                        x = normalize_crop(x)
                    parts.append(resnet50_features(model, x))
            return gather_rows(parts).numpy()

    def extract_from_images(self, image_paths: Sequence[str],
                            bboxes: np.ndarray, scale: float = 1.3,
                            augment_fn=None,
                            imread: Optional[Callable[[str], np.ndarray]]
                            = None) -> np.ndarray:
        """Images + (N, 4) cxcywh bboxes -> (N, 2048) features.

        `imread(path)` gives each frame as RGB uint8 (H, W, 3); by default
        OpenCV reads the file (`read_rgb`). `augment_fn(img) -> img` runs
        on the full frame before cropping, the hook the `*_occ` DB variants
        use (`data.occlusion.occlude_with_objects`)."""
        imread = imread or read_rgb
        crops = np.zeros((len(image_paths), 3, self.crop_size,
                          self.crop_size), np.uint8)
        for i, path in enumerate(image_paths):
            img = imread(str(path))
            if augment_fn is not None:
                img = augment_fn(img)
            crops[i] = crop_normalize(img, bboxes[i:i + 1], self.crop_size,
                                      scale, normalize=False)[0]
        return self.features_from_crops(crops)

    def extract_from_frames(self, frames: Sequence[np.ndarray],
                            bboxes: np.ndarray,
                            scale: float = 1.3) -> np.ndarray:
        """In-memory RGB frames + bboxes -> features."""
        crops = np.stack([
            crop_normalize(frames[i], bboxes[i:i + 1], self.crop_size,
                           scale, normalize=False)[0]
            for i in range(len(frames))])
        return self.features_from_crops(crops)
