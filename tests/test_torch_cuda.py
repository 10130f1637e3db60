"""CUDA-only tests of the port: the LBS skinning kernel against its plain
version, its input checks, and the eval rollout on the card against the CPU.

They skip where no CUDA device is visible. This file imports no JAX, so on a
GPU host without JAX it runs without the suite's conftest:

  python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))

import tepose_tpu_torch.ops.lbs_skinning as LS  # noqa: E402
from tepose_tpu_torch.models.smpl import synthetic_smpl_model  # noqa: E402

pytestmark = pytest.mark.requires_cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(V, B, device, seed=0):
    rs = np.random.RandomState(seed)
    wT = synthetic_smpl_model(0, V, device=device).lbs_weights_t
    A = rs.randn(B, 24, 4, 4).astype(np.float32)
    A[:, :, 3] = [0, 0, 0, 1]
    v = rs.randn(B, V, 3).astype(np.float32)
    return wT, torch.from_numpy(A).to(device), torch.from_numpy(v).to(device)


@pytest.mark.parametrize("V,B", [(6890, 1), (6890, 8), (6890, 256), (700, 3)])
def test_lbs_kernel_matches_plain(cuda, V, B):
    """fp32 atol 1e-5, as tests/test_lbs_pallas.py holds the TPU kernel."""
    wT, A, v = _inputs(V, B, cuda)
    before = LS.LAUNCHES
    out = LS.lbs_skinning(wT, A, v)
    torch.cuda.synchronize()
    assert LS.LAUNCHES == before + 1
    ref = LS.lbs_skinning_reference(wT, A, v)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)


def test_lbs_kernel_rejects_bad_inputs(cuda):
    wT, A, v = _inputs(700, 2, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        LS.lbs_skinning(wT, A, v.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(TypeError, match="float32"):
        LS.lbs_skinning(wT, A.double(), v)
    with pytest.raises(ValueError, match="one CUDA device"):
        LS.lbs_skinning(wT, A.cpu(), v)
    with pytest.raises(RuntimeError, match="forward only"):
        LS.lbs_skinning(wT, A, v.clone().requires_grad_())
    with pytest.raises(ValueError, match="joints"):
        LS.lbs_skinning(torch.zeros(33, 700, device=cuda),
                        torch.zeros(2, 33, 4, 4, device=cuda), v)


def test_rollout_on_cuda_matches_cpu(cuda):
    """The small-width eval rollout on the card, through the kernel, against
    the same rollout on the CPU (plain einsum): 0.1 mm joints and MPVPE."""
    from make_torch_port_golden import port_rollout, port_setup

    spec = dict(seqlen=6, n_layers=2, hidden_size=32, vibe_n_layers=2,
                vibe_hidden_size=32, num_verts=700, smpl_seed=0, gen_seed=0,
                vibe_seed=1, data_seed=5, num_videos=2, min_len=24,
                max_len=26)
    before = LS.LAUNCHES
    out = port_rollout(port_setup(spec, cuda))
    assert LS.LAUNCHES > before
    ref = port_rollout(port_setup(spec, "cpu"))
    for key, atol in (("pred_j3d", 1e-4), ("mpvpe", 1e-4),
                      ("pred_theta", 1e-3)):
        np.testing.assert_allclose(out[key], ref[key], atol=atol, rtol=0)
