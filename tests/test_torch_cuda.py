"""CUDA-only tests of the port: the LBS skinning kernel against its plain
version, its input checks, and the eval rollout, the serving engine and
the live session on the card against the CPU.

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


SERVE_SPEC = dict(seqlen=6, n_layers=2, hidden_size=32, vibe_n_layers=2,
                  vibe_hidden_size=32, num_verts=700, smpl_seed=0, gen_seed=0,
                  vibe_seed=1, backbone_seed=2, crop_seed=3, crop_size=64,
                  lengths=[7, 12], window_bucket=16, vert_stride=7)


def test_engine_on_cuda_matches_cpu(cuda):
    """The small-width serving engine on the card, through the kernel,
    against the same engine on the CPU, at chip_smoke.py's golden bars."""
    import make_torch_serve_golden as sg

    cpu = sg.port_serve(sg.port_setup(SERVE_SPEC, "cpu"))
    setup = sg.port_setup(SERVE_SPEC, cuda)
    for path in ("crops", "features"):
        before = LS.LAUNCHES
        got = sg.port_serve(setup, path)
        assert LS.LAUNCHES > before
        golden = dict(cpu, spec=SERVE_SPEC)
        for k, (d, bar) in sg.golden_deviation(got, golden).items():
            assert d <= bar, (path, k, d, bar)


def test_live_on_cuda_matches_engine(cuda):
    """LiveSession with the backbone on the card, one slot reset, against
    the engine on the card at tests/test_live.py's bar."""
    import make_torch_serve_golden as sg
    from tepose_tpu_torch.streaming.live import LiveSession

    setup = sg.port_setup(SERVE_SPEC, cuda)
    offline = sg.port_engine(setup).run_tracklets_from_crops(setup["crops"])
    c0, c1 = setup["crops"]
    keys = ("theta", "verts", "kp_2d", "kp_3d")
    live = LiveSession(setup["smpl"], setup["gen"], setup["vibe"],
                       n_streams=2, backbone=setup["backbone"], outputs=keys)
    before = LS.LAUNCHES
    for t in range(len(c1)):
        f0 = t % len(c0)
        out = live.push(np.stack([c0[f0], c1[t]]),
                        reset=np.array([t == len(c0), False]))
        for slot, (res, f) in enumerate(((offline[0], f0), (offline[1], t))):
            assert bool(out["valid"][slot]) == (f >= 5)
            for k in keys:
                np.testing.assert_allclose(
                    out[k][slot], res[k][f], rtol=2e-4, atol=2e-5,
                    err_msg=f"{t} {slot} {k}")
    assert LS.LAUNCHES > before


def test_live_on_cuda_matches_cpu(cuda):
    """The same pushes, one slot reset, through a LiveSession on the card
    and one on the CPU, at chip_smoke.py's golden bars (kp_2d relative to
    its magnitude)."""
    import make_torch_serve_golden as sg
    from tepose_tpu_torch.streaming.live import LiveSession

    keys = ("theta", "verts", "kp_2d", "kp_3d")
    sessions = []
    for device in (cuda, "cpu"):
        s = sg.port_setup(SERVE_SPEC, device)
        sessions.append(LiveSession(s["smpl"], s["gen"], s["vibe"],
                                    n_streams=2, backbone=s["backbone"],
                                    outputs=keys))
    c0, c1 = s["crops"]
    before = LS.LAUNCHES
    for t in range(len(c1)):
        x = np.stack([c0[t % len(c0)], c1[t]])
        reset = np.array([t == len(c0), False])
        got, want = (live.push(x, reset=reset) for live in sessions)
        np.testing.assert_array_equal(got["valid"], want["valid"])
        for k in keys:
            atol = {"theta": sg.THETA_ATOL,
                    "kp_2d": sg.KP2D_RTOL * np.abs(want[k]).max()}.get(
                        k, sg.METRE_ATOL)
            np.testing.assert_allclose(got[k], want[k], atol=atol, rtol=0,
                                       err_msg=f"{t} {k}")
    assert LS.LAUNCHES > before


def test_serving_modules_stay_on_cuda(cuda):
    """The engine refuses modules on two devices; nothing moves to the CPU
    or falls back to the einsum."""
    import make_torch_serve_golden as sg

    setup = sg.port_setup(SERVE_SPEC, cuda)
    setup["backbone"] = setup["backbone"].cpu()
    with pytest.raises(ValueError, match="serving path runs on"):
        sg.port_engine(setup)
