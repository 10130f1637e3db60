"""CUDA-only tests of the port's offline DB building: the feature extractor,
the 3DPW builder (SMPL with the skinning kernel over each track) and the
pseudo-thetas on the card against the same port code on the CPU.

They skip where no CUDA device is visible. This file imports no JAX, so on
a GPU host without JAX it runs without the suite's conftest:

  python -m pytest --noconftest -p no:cacheprovider \
      tests/test_torch_preprocess_cuda.py
"""

import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "tools")]

import make_torch_preprocess_golden as pg  # noqa: E402
import tepose_tpu_torch.ops.lbs_skinning as LS  # noqa: E402
from tepose_tpu_torch.data.preprocess import FeatureExtractor  # noqa: E402

pytestmark = pytest.mark.requires_cuda

# SMPL at full size (the kernel's real V); VIBE narrow; chunks of 20 frames
# over videos of 23 (a chunk and a tail), 20 (exact) and 7 (short)
SPEC = dict(pg.FULL_SPEC, vibe_n_layers=1, vibe_hidden_size=64, frames=16,
            height=96, width=128, pseudo_lengths=[23, 20, 7], vibe_batch=20)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_features_from_crops_cuda_matches_cpu(cuda):
    """uint8 crops normalised on the card, ragged last batch; within 1e-4
    of the features' magnitude (cuDNN picks other conv algorithms)."""
    from tepose_tpu_torch.models.backbone import resnet50_init

    rs = np.random.RandomState(0)
    crops = rs.randint(0, 256, (19, 3, 64, 64)).astype(np.uint8)
    out = {}
    for dev in ("cpu", cuda):
        bb = resnet50_init(torch.Generator().manual_seed(2), dev)
        out[str(dev)] = FeatureExtractor(bb, batch_size=8,
                                         crop_size=64).features_from_crops(
            crops)
    want = out["cpu"]
    np.testing.assert_allclose(out["cuda"], want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def test_threedpw_and_pseudo_theta_cuda_match_cpu(cuda, tmp_path):
    """The fabricated 3DPW test split and the pseudo-theta videos on the
    card against the CPU, at phase 11's bars: host arrays equal, pose and
    joints3D within 1e-4, features within 1e-4 of their magnitude,
    pseudo-thetas within 1e-6; the skinning kernel launched."""
    folder, frames = pg.fabricate_3dpw(str(tmp_path), SPEC)
    want = pg.port_outputs(pg.port_setup(SPEC, "cpu"), folder, frames)
    before = LS.LAUNCHES
    got = pg.port_outputs(pg.port_setup(SPEC, cuda), folder, frames)
    torch.cuda.synchronize()
    # one launch a track, one a chunk (23 -> 2, 20 -> 1, 7 -> 1)
    assert LS.LAUNCHES - before == SPEC["people"] + 4
    for k, (d, bar) in pg.golden_deviation(got, want).items():
        assert d <= bar, (k, d, bar)
