"""CUDA-only tests of the port: the LBS skinning kernel against its plain
version, its input checks and launch shapes, and the eval rollout, the
serving engine, VIBE over crops, the live session, a training window and
trainer validation on the card against the CPU.

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


# every batch size of the main path at V = 6890 (live 1-32, engine 8 and
# 48, eval 32, 160 and 192), the large batch, and ragged vertex counts
@pytest.mark.parametrize("V,B", [(6890, 1), (6890, 8), (6890, 32), (6890, 48),
                                 (6890, 160), (6890, 192), (6890, 256),
                                 (700, 3), (301, 3)])
def test_lbs_kernel_matches_plain(cuda, V, B):
    """fp32 atol 1e-5, as tests/test_lbs_pallas.py holds the TPU kernel."""
    wT, A, v = _inputs(V, B, cuda)
    before = LS.LAUNCHES
    out = LS.lbs_skinning(wT, A, v)
    torch.cuda.synchronize()
    assert LS.LAUNCHES == before + 1
    ref = LS.lbs_skinning_reference(wT, A, v)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("B", [5, 32])
def test_lbs_kernel_takes_4_byte_aligned_views(cuda, B):
    """Contiguous views at storage offset 1 of larger buffers: every input
    only 4-byte aligned, and odd samples' rows off a 16-byte boundary, for
    one (B = 5) and four (B = 32) vertices per thread."""
    views = []
    for t in _inputs(6890, B, cuda):
        buf = torch.empty(t.numel() + 1, device=cuda)
        buf[1:] = t.reshape(-1)
        views.append(buf[1:].view(t.shape))
    assert all(t.is_contiguous() and t.data_ptr() % 16 for t in views)
    out = LS.lbs_skinning(*views)
    torch.testing.assert_close(out, LS.lbs_skinning_reference(*views),
                               atol=1e-5, rtol=0)


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


@pytest.mark.parametrize("J", [1, 17, 32])
def test_lbs_kernel_other_joint_counts(cuda, J):
    """Joint counts other than SMPL's 24 run the 32-joint instantiation
    with the missing joints zero."""
    rs = np.random.RandomState(J)
    w = rs.rand(J, 301).astype(np.float32)
    A = rs.randn(4, J, 4, 4).astype(np.float32)
    v = rs.randn(4, 301, 3).astype(np.float32)
    wT, A, v = (torch.from_numpy(x).to(cuda) for x in (w, A, v))
    torch.testing.assert_close(LS.lbs_skinning(wT, A, v),
                               LS.lbs_skinning_reference(wT, A, v),
                               atol=1e-5, rtol=0)


def test_lbs_kernel_every_launch_shape(cuda):
    """The kernel at every block size each variant takes, each with several
    sample groups, against the plain version; a shape it does not take
    raises."""
    B, V = 7, 1000
    wT, A, v = _inputs(V, B, cuda)
    ref = LS.lbs_skinning_reference(wT, A, v)
    for vpt, most in LS.THREADS.items():
        for threads in range(32, most + 1, 32):
            tiles = -(-V // (threads * vpt))
            for groups in (1, 3, B):
                cfg = LS.LaunchConfig(threads, vpt, tiles, groups)
                out = torch.full_like(v, float("nan"))
                LS._launch(wT, A, v, out, cfg)
                torch.testing.assert_close(out, ref, atol=1e-5, rtol=0,
                                           msg=lambda m: f"{cfg}: {m}")
    for cfg in (LS.LaunchConfig(96, 4, 4, 1), LS.LaunchConfig(160, 1, 7, 1),
                LS.LaunchConfig(64, 2, 8, 1), LS.LaunchConfig(64, 4, 4, 8)):
        with pytest.raises(RuntimeError, match="launch failed"):
            LS._launch(wT, A, v, torch.empty_like(v), cfg)


def test_lbs_launch_rule_fits_one_wave(cuda):
    """The launch rule assumes BLOCKS_PER_SM blocks of each variant fit an
    SM at once; the card's occupancy query agrees."""
    from tepose_tpu_torch.kernels import lbs_library

    for J, vpt in ((24, 1), (24, 4), (17, 1)):
        n = lbs_library().tepose_lbs_blocks_per_sm(J, vpt, LS.THREADS[vpt])
        assert n >= LS.BLOCKS_PER_SM, (J, vpt, n)


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


def test_vibe_demo_forward_on_cuda_matches_cpu(cuda):
    """VIBE over normalised crops at tests/test_torch_parity_extras.py's
    size (64 vertices, 1 x 4 crops of 64 x 64, VIBE 1 x 16) on the card,
    skinned in one kernel launch, against the CPU at chip_smoke.py's
    serving bars (kp_2d relative to its magnitude)."""
    import make_torch_serve_golden as sg
    from tepose_tpu_torch.models.backbone import resnet50_init
    from tepose_tpu_torch.models.tepose import (
        Vibe, VibeConfig, vibe_demo_forward)

    images = np.random.RandomState(2).randn(1, 4, 3, 64, 64).astype(
        np.float32)
    outs, launches = [], []
    for device in (cuda, "cpu"):
        vibe = Vibe(VibeConfig(4, 1, 16), device=device,
                    generator=torch.Generator().manual_seed(3)).eval()
        backbone = resnet50_init(torch.Generator().manual_seed(2),
                                 device).eval()
        before = LS.LAUNCHES
        with torch.no_grad():
            out = vibe_demo_forward(vibe, backbone,
                                    synthetic_smpl_model(1, 64, device=device),
                                    torch.from_numpy(images).to(device))
        launches.append(LS.LAUNCHES - before)
        outs.append({k: v.cpu().numpy() for k, v in out.items()})
    assert launches == [1, 0]
    got, want = outs
    assert set(got) == set(want) and got["theta"].shape == (1, 4, 85)
    for k, w in want.items():
        atol = {"theta": sg.THETA_ATOL, "rotmat": sg.THETA_ATOL,
                "kp_2d": sg.KP2D_RTOL * np.abs(w).max()}.get(k, sg.METRE_ATOL)
        np.testing.assert_allclose(got[k], w, atol=atol, rtol=0, err_msg=k)


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


TRAIN_SPEC = dict(seqlen=6, n_layers=1, hidden_size=16, num_verts=700,
                  n_2d=3, n_3d=4, vidlen=10, num_gcn_scales=2,
                  num_g3d_scales=2, gen_lr=5e-5, gen_wd=0.0, disc_lr=1e-4,
                  disc_wd=1e-4, disc_update_steps=1, smpl_seed=0,
                  gen_seed=0, disc_seed=1, data_seed=11, windows=(1, 3))


def test_train_window_on_cuda_matches_cpu(cuda):
    """One small-width training window on the card against the same window
    on the CPU, dropout off: losses rtol 1e-4, window 1's sum ||g||^2 rtol
    1e-3, BN statistics 1e-4 of each array's magnitude, parameters within
    2 lr; the step skins nothing."""
    import make_torch_train_golden as tg

    want = tg.port_segment(tg.port_setup(TRAIN_SPEC, "cpu"), 1)
    before = LS.LAUNCHES
    got = tg.port_segment(tg.port_setup(TRAIN_SPEC, cuda), 1)
    assert LS.LAUNCHES == before
    for k, v in want["losses"].items():
        np.testing.assert_allclose(got["losses"][k], v, rtol=1e-4, err_msg=k)
    for k, (d, bar) in tg.pair_deviation(got, want).items():
        assert d <= bar, (k, d, bar)
    assert got["adam_steps"] == want["adam_steps"] == {"gen": [1],
                                                       "disc": [1]}
    np.testing.assert_allclose(got["grad_sq"], want["grad_sq"], rtol=1e-3)
    for k, v in want["disc_state"].items():
        np.testing.assert_allclose(got["disc_state"][k], v, rtol=0,
                                   atol=1e-4 * max(np.abs(v).max(), 1e-6),
                                   err_msg=k)
    for group, lr in (("gen", TRAIN_SPEC["gen_lr"]),
                      ("disc", TRAIN_SPEC["disc_lr"])):
        for k, v in want[group].items():
            np.testing.assert_allclose(got[group][k], v, rtol=0,
                                       atol=2 * lr, err_msg=k)


def test_lbs_refuses_grad_on_the_training_path(cuda):
    """The skinning kernel is forward only: an SMPL forward whose inputs
    need a gradient raises while grad is on (the train step takes the
    vertex-free joints instead); under no_grad it launches."""
    from tepose_tpu_torch.models.smpl import smpl_forward

    smpl = synthetic_smpl_model(0, 700, device=cuda)
    betas = torch.zeros(2, 10, device=cuda, requires_grad=True)
    pose = torch.zeros(2, 72, device=cuda)
    with pytest.raises(RuntimeError, match="forward only"):
        smpl_forward(smpl, betas, pose, pose2rot=True)
    before = LS.LAUNCHES
    with torch.no_grad():
        smpl_forward(smpl, betas, pose, pose2rot=True)
    assert LS.LAUNCHES == before + 1


def test_train_validation_on_cuda_matches_cpu(cuda):
    """Trainer validation's scan on the card, through the kernel, against
    the CPU: 0.1 mm joints and vertex error."""
    import make_torch_train_golden as tg
    from tepose_tpu_torch.train.validate import validate_scan

    feats_np = (np.random.RandomState(2).randn(3, 12, 2048) * 0.1).astype(
        np.float32)
    outs = []
    for device in ("cpu", cuda):
        setup = tg.port_setup(TRAIN_SPEC, device)
        feats = torch.from_numpy(feats_np).to(device)
        pseu = torch.zeros(3, 5, 85, device=device)
        pseu[..., 0] = 1.0
        theta = torch.zeros(3, 12, 85, device=device)
        jreg = torch.full((17, 700), 1 / 700, device=device)
        before = LS.LAUNCHES
        outs.append(validate_scan(setup["gen"].eval(), setup["smpl"], feats,
                                  pseu, theta, jreg, 7))
        assert LS.LAUNCHES == before + (14 if device == cuda else 0)
    for k in ("pred_j3d", "pve"):
        np.testing.assert_allclose(outs[1][k].cpu().numpy(),
                                   outs[0][k].numpy(), atol=1e-4, rtol=0)


def test_trace_records_the_card(cuda, tmp_path):
    """utils.profiling.trace on cuda writes a Chrome trace holding the LBS
    kernel's launch as a device kernel event."""
    from tepose_tpu_torch.utils.profiling import trace

    wT, A, v = _inputs(6890, 8, cuda)
    with trace(str(tmp_path), cuda) as t:
        LS.lbs_skinning(wT, A, v)
    import json

    with open(t.path) as f:
        kernels = [e["name"] for e in json.load(f)["traceEvents"]
                   if e.get("cat") == "kernel"]
    assert any("lbs_skin" in n for n in kernels), kernels[:10]


def test_counted_flops_counts_the_cudnn_gru(cuda):
    """cuDNN's fused GRU is counted through the `_cudnn_rnn` mapping, as
    the GRU formula gives it."""
    from tepose_tpu_torch.utils import flops as F

    T, B, IN, H, NL = 6, 4, 2133, 64, 2
    for bidir in (False, True):
        gru = torch.nn.GRU(IN, H, NL, bidirectional=bidir).to(cuda)
        with torch.no_grad():
            got = F.counted_flops(gru, torch.zeros(T, B, IN, device=cuda))
        assert got == B * F.gru_flops(T, IN, H, NL, bidir)


def test_peak_flops_on_the_card(cuda):
    from tepose_tpu_torch.utils import flops as F

    name = torch.cuda.get_device_name(cuda)
    assert F.peak_flops(cuda) == F.peak_flops_for(name)
    if name.startswith("NVIDIA H100"):
        assert F.peak_flops(cuda, torch.bfloat16) > F.peak_flops(cuda)


# ------------------------------------------------------------- scale-out

TWO_SHARDS = ["cuda:0", "cuda:0"]


def test_sharded_eval_on_two_shards_of_the_card(cuda):
    """make_sharded_eval_rollout on [cuda:0, cuda:0] against the rollout on
    cuda:0 (1e-5, the JAX mesh test's bar): every LBS launch of one device
    becomes one a shard."""
    from tepose_tpu_torch.eval.evaluator import (
        eval_rollout, make_sharded_eval_rollout)
    from tepose_tpu_torch.models.tepose import (
        TePose, TePoseConfig, Vibe, VibeConfig)
    from tepose_tpu_torch.parallel.mesh import make_mesh

    rs = np.random.RandomState(0)
    smpl = synthetic_smpl_model(0, 700, device=cuda)
    gen = TePose(TePoseConfig(6, 2, 32), device=cuda,
                 generator=torch.Generator().manual_seed(0)).eval()
    vibe = Vibe(VibeConfig(6, 2, 32), device=cuda,
                generator=torch.Generator().manual_seed(1)).eval()
    B, T = 4, 20
    x = [torch.from_numpy(a.astype(np.float32)).to(cuda) for a in (
        rs.randn(B, T, 2048) * 0.1, rs.randn(B, 5, 85) * 0.1,
        rs.randn(B, T, 85) * 0.1)]
    jreg = torch.from_numpy(rs.rand(17, 700).astype(np.float32)).to(cuda)
    before = LS.LAUNCHES
    want = eval_rollout(gen, vibe, smpl, *x, jreg, T - 5)
    torch.cuda.synchronize()
    single = LS.LAUNCHES - before
    fn = make_sharded_eval_rollout(gen, vibe, smpl, jreg,
                                   make_mesh(devices=TWO_SHARDS))
    before = LS.LAUNCHES
    got = fn(*x, T - 5)
    torch.cuda.synchronize()
    assert LS.LAUNCHES - before == 2 * single > 0
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.cpu().numpy(),
                                   atol=1e-5, rtol=0, err_msg=k)


def test_engine_on_two_shards_of_the_card(cuda):
    """StreamingEngine(mesh=[cuda:0, cuda:0]) against the engine on cuda:0
    at chip_smoke.py's golden bars, crops and features."""
    import make_torch_serve_golden as sg
    from tepose_tpu_torch.parallel.mesh import make_mesh

    setup = sg.port_setup(SERVE_SPEC, cuda)
    want = sg.port_serve(setup)
    eng = sg.port_engine(setup, mesh=make_mesh(devices=TWO_SHARDS))
    before = LS.LAUNCHES
    for results in (eng.run_tracklets_from_crops(setup["crops"]),
                    eng.run_tracklets(eng.extract_features_multi(
                        setup["crops"]))):
        got = sg.golden_outputs(results, SERVE_SPEC)
        for k, (d, bar) in sg.golden_deviation(
                got, dict(want, spec=SERVE_SPEC)).items():
            assert d <= bar, (k, d, bar)
    assert LS.LAUNCHES > before


def test_engine_staging_ring_on_the_card(cuda, monkeypatch):
    """Crops staged chunk by chunk through the pinned ring (`_staged`) give
    the card's own outputs bit for bit with each replica block staged
    whole as the engine once did (concatenated, pinned and uploaded in one
    copy, then cut into chunks on the card), on the TePose route, its
    feature path and the per-frame route, each called twice: the ring
    allocates nothing on the second call, and the host's waits for a slot
    are counted."""
    import make_torch_engine_golden as eg
    import make_torch_serve_golden as sg
    from tepose_tpu_torch.parallel.mesh import upload
    from tepose_tpu_torch.streaming import engine as E

    setup = sg.port_setup(SERVE_SPEC, cuda)
    # lengths 7 and 12 in one bucket: 19 frames, chunks of 4 straddling
    tepose = sg.port_engine(setup, crop_batch=4)
    hmr2 = E.StreamingEngine(
        synthetic_smpl_model(0, 64, device=cuda), eg.hmr2_model().to(cuda),
        crop_batch=4, max_frames_per_call=7)
    rs = np.random.RandomState(4)
    frames = [(rs.rand(n, 3, 64, 64) * 255).astype(np.uint8)
              for n in eg.LENGTHS]
    calls = {
        "crops": lambda: tepose.run_tracklets_from_crops(setup["crops"]),
        "features": lambda: [{"feats": f} for f in
                             tepose.extract_features_multi(setup["crops"])],
        "frames": lambda: hmr2.run_tracklets_from_crops(frames)}

    def runs():
        out = {}
        for name, call in calls.items():
            out[name] = []
            for _ in range(2):
                before = dict(E.STAGING_STATS)
                out[name].append(call())
                torch.cuda.synchronize()
                out[name].append(
                    {k: E.STAGING_STATS[k] - before[k] for k in before})
        return out

    got = runs()

    def whole(self, r, pieces):
        flat = np.concatenate([np.asarray(a)[lo:hi] for a, lo, hi in pieces])
        x = upload(flat, self._replicas[r].device)
        for i in range(0, len(x), self.crop_batch):
            yield x[i:i + self.crop_batch]

    monkeypatch.setattr(E.StreamingEngine, "_staged", whole)
    want = runs()
    for name in calls:
        first, stats1, second, stats2 = got[name]
        assert stats1["chunks"] > 1 and stats1["bytes"] > 0, name
        assert stats2["ring_allocs"] == 0, name
        assert stats2["slot_waits"] >= 0 and stats2["slot_wait_s"] >= 0.0
        for outs in (first, second, want[name][0]):
            assert len(outs) == len(want[name][2])
            for o, w in zip(outs, want[name][2]):
                for k in w:
                    assert o[k].dtype == w[k].dtype, (name, k)
                    assert np.array_equal(o[k], w[k]), (name, k)


def test_world1_nccl_segment_matches_plain(cuda):
    """The data-parallel segment at world size 1 over NCCL against the
    plain segment, at update rate 0.9 with dropout, both in deterministic
    mode (chip_smoke.deterministic): losses 1e-6 relative, every leaf
    within 1e-6 of its magnitude."""
    import dataclasses
    import socket

    import make_torch_train_golden as tg
    from tepose_tpu_torch.parallel import distributed, dp
    from tepose_tpu_torch.train.trainer import train_segment

    spec = dict(tg.FULL_SPEC, n_layers=1, hidden_size=16, num_verts=48,
                n_2d=4, n_3d=4, num_gcn_scales=2, num_g3d_scales=2,
                windows=(3,))

    def run(sharded):
        s = tg.port_setup(spec, cuda)
        s["hp"] = dataclasses.replace(s["hp"], update_theta_rate=0.9)
        args = (s["gen"], s["disc"], s["smpl"], s["gen_opt"], s["disc_opt"],
                s["hp"], s["weights"], s["batch_2d"], s["batch_3d"],
                s["amass"], torch.Generator(device=cuda).manual_seed(5))
        losses = (dp.sharded_train_segment if sharded else train_segment)(
            *args)
        return losses, tg.port_state(s)

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from chip_smoke import deterministic

    with deterministic():
        want = run(False)
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    distributed.maybe_initialize(f"localhost:{port}", 1, 0, backend="nccl",
                                 timeout_s=60)
    try:
        with deterministic():
            got = run(True)
    finally:
        distributed.shutdown()
    for k, v in want[0].items():
        assert abs(got[0][k] - v) <= 1e-6 * max(abs(v), 1e-12), k
    for g in ("gen", "disc", "disc_state"):
        for k, v in want[1][g].items():
            assert np.abs(got[1][g][k] - v).max() <= 1e-6 * max(
                np.abs(v).max(), 1e-12), (g, k)


def test_bf16_train_window_gate_on_cuda(cuda):
    """bf16 training compute on the card at small width: the one-window
    gate of tools/bf16_gate.py against the float32 window (update cosine
    > 0.98, relative norm < 0.2, losses within 5 %, metrics finite, all
    state float32), with no LBS launch in the step."""
    import bf16_gate
    import make_torch_train_golden as tg

    spec = dict(tg.FULL_SPEC, n_layers=1, hidden_size=32, num_verts=64,
                n_2d=2, n_3d=3, num_gcn_scales=3, num_g3d_scales=2,
                windows=(1,))
    before = LS.LAUNCHES
    f32 = bf16_gate.port_window(spec, cuda, None)
    bf16 = bf16_gate.port_window(spec, cuda, "bfloat16")
    torch.cuda.synchronize()
    res = bf16_gate.gate(f32, bf16)
    assert all(ok for _, _, ok in res.values()), res
    assert LS.LAUNCHES == before


def _scan_setup(cuda, hidden, V, B, T, seed=0):
    """A TePose of `hidden` units (S = 6, 2 layers), a V-vertex SMPL,
    features (B, T, 2048), a ring (B, 5, 85) and a J14 regressor, seeded."""
    from tepose_tpu_torch.models.tepose import TePose, TePoseConfig

    rs = np.random.RandomState(seed)
    gen = TePose(TePoseConfig(6, 2, hidden), device=cuda,
                 generator=torch.Generator().manual_seed(seed)).eval()
    feats, buf0 = (torch.from_numpy(a.astype(np.float32)).to(cuda) for a in (
        rs.randn(B, T, 2048) * 0.1, rs.randn(B, 5, 85) * 0.1))
    jreg = torch.from_numpy(rs.rand(17, V).astype(np.float32)).to(cuda)
    return gen, synthetic_smpl_model(seed, V, device=cuda), feats, buf0, jreg


def _eager_scan(gen, smpl, feats, buf0, W, jreg=None,
                outputs=("theta", "kp_3d")):
    """The window loop without graphs, on the same device."""
    from tepose_tpu_torch.streaming import fast_scan as FS

    with torch.inference_mode():
        return FS._fast_scan(gen, smpl, feats, buf0, W, jreg, outputs, None,
                             graphed=False)


def _assert_rel(got, want, bar=1e-6):
    for k, v in want.items():
        gap = (got[k] - v).abs().max().item()
        assert gap <= bar * v.abs().max().item(), (k, gap)


# a small width with and without the J14 regressor, each projection mode;
# the full width at B = 32 over 123 windows
@pytest.mark.parametrize("hidden,V,B,T,jreg,pre", [
    (32, 700, 3, 20, False, True), (32, 700, 3, 20, True, False),
    (1024, 6890, 32, 128, False, True)])
def test_graphed_scan_matches_eager_windows(cuda, hidden, V, B, T, jreg,
                                            pre):
    """`fast_stream_scan` on the card replays one captured graph a window
    and skins once a window; its theta, verts and kp_3d equal the eager
    window loop's within 1e-6 of their magnitude, through every window's
    theta feedback."""
    from tepose_tpu_torch.streaming import fast_scan as FS

    gen, smpl, feats, buf0, J = _scan_setup(cuda, hidden, V, B, T)
    J = J if jreg else None
    W = T - 5
    outputs = ("theta", "verts", "kp_3d")
    before, launches = dict(FS.GRAPH_STATS), LS.LAUNCHES
    got = FS.fast_stream_scan(gen, smpl, feats, buf0, W, J, outputs, pre)
    # the first window runs eagerly before the capture, the rest replay
    assert FS.GRAPH_STATS == {"captures": before["captures"] + 1,
                              "replays": before["replays"] + W - 1,
                              "eager_windows": before["eager_windows"] + 1}
    assert LS.LAUNCHES == launches + W
    with torch.inference_mode():
        want = FS._fast_scan(gen, smpl, feats, buf0, W, J, outputs, pre,
                             graphed=False)
    assert got["kp_3d"].shape == (B, W, 14 if jreg else 49, 3)
    _assert_rel(got, want)


def test_graphed_scan_outputs_are_fresh(cuda):
    """Two calls on different features: the second leaves the first call's
    outputs as they were (they are copies, not the graph's buffers), and
    the second call reuses the graph."""
    from tepose_tpu_torch.streaming import fast_scan as FS

    gen, smpl, feats, buf0, _ = _scan_setup(cuda, 32, 700, 3, 20)
    first = FS.fast_stream_scan(gen, smpl, feats, buf0, 15)
    kept = {k: v.clone() for k, v in first.items()}
    captures = FS.GRAPH_STATS["captures"]
    second = FS.fast_stream_scan(gen, smpl, feats.flip(1), buf0, 15)
    assert FS.GRAPH_STATS["captures"] == captures
    for k, v in kept.items():
        assert torch.equal(first[k], v), k
        assert not torch.equal(second[k], v), k
    _assert_rel(second, _eager_scan(gen, smpl, feats.flip(1), buf0, 15))


@pytest.mark.parametrize("change", ["allow_tf32", "drop_fast_pack"])
def test_graphed_scan_recaptures(cuda, change):
    """TF32 on for matmuls, or a new pack, captures one graph more, and the
    replays match the eager window loop under the same flags and weights."""
    from tepose_tpu_torch.streaming import fast_scan as FS

    gen, smpl, feats, buf0, _ = _scan_setup(cuda, 32, 700, 3, 20)
    FS.fast_stream_scan(gen, smpl, feats, buf0, 15)
    captures = FS.GRAPH_STATS["captures"]
    try:
        if change == "allow_tf32":
            torch.backends.cuda.matmul.allow_tf32 = True
        else:
            with torch.no_grad():
                gen.encoder.gru_fwd.weight_hh_l0.mul_(1.5)
            gen.drop_fast_pack()
        got = FS.fast_stream_scan(gen, smpl, feats, buf0, 15)
        assert FS.GRAPH_STATS["captures"] == captures + 1
        want = _eager_scan(gen, smpl, feats, buf0, 15)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    _assert_rel(got, want)


def test_graphed_scan_counts_one_lbs_launch_a_window(cuda):
    """After the capture, each replayed window adds the one skinning launch
    its graph holds to `lbs_skinning.LAUNCHES`."""
    from tepose_tpu_torch.streaming import fast_scan as FS

    gen, smpl, feats, buf0, _ = _scan_setup(cuda, 32, 700, 3, 20)
    FS.fast_stream_scan(gen, smpl, feats, buf0, 15)
    before = LS.LAUNCHES
    FS.fast_stream_scan(gen, smpl, feats, buf0, 12)
    assert LS.LAUNCHES == before + 12


def test_graphed_scan_reaches_a_frozen_ring(cuda, monkeypatch):
    """A `_feedback_loop` whose ring never advances, patched in as the
    benchmark's fault test patches it, changes the graphed scan's outputs:
    the replays read the theta feedback the loop hands them."""
    from tepose_tpu_torch.streaming import fast_scan as FS

    gen, smpl, feats, buf0, _ = _scan_setup(cuda, 32, 700, 3, 20)
    want = FS.fast_stream_scan(gen, smpl, feats, buf0, 15)

    def frozen_ring(window, theta_buf0, num_windows, outputs):
        zero = torch.zeros_like(theta_buf0[:, :1])
        outs = [window(k, torch.cat([theta_buf0, zero], dim=1))
                for k in range(num_windows)]
        return {k: torch.stack([o[k] for o in outs], dim=1) for k in outputs}

    monkeypatch.setattr(FS, "_feedback_loop", frozen_ring)
    replays = FS.GRAPH_STATS["replays"]
    got = FS.fast_stream_scan(gen, smpl, feats, buf0, 15)
    assert FS.GRAPH_STATS["replays"] == replays + 15
    assert torch.equal(got["theta"][:, 0], want["theta"][:, 0])
    assert (got["theta"][:, 1:] - want["theta"][:, 1:]).abs().max() > 1e-6


# ------------------------------------------------- ViT-H's 3xTF32 linears

VIT_SHAPES = [("qkv", 3840, 1280), ("proj", 1280, 1280), ("fc1", 5120, 1280),
              ("fc2", 1280, 5120)]


def _vit_inputs(M, N, K, device, seed=0):
    """An activation like a LayerNorm's output, a weight like the ViT's
    (std 0.02), a bias and a residual, drawn on the card."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(M, K, device=device, generator=g)
    w = torch.randn(N, K, device=device, generator=g) * 0.02
    b = torch.randn(N, device=device, generator=g) * 0.02
    r = torch.randn(M, N, device=device, generator=g)
    return x, w, b, r


def _rel64(y, want64) -> float:
    """Largest gap from the float64 result over its largest magnitude."""
    return float((y.double() - want64).abs().max() / want64.abs().max())


@pytest.mark.parametrize("M", [24_576, 2112, 192])
@pytest.mark.parametrize("name,N,K", VIT_SHAPES)
def test_vit_linear_kernel_is_float32_accurate(cuda, name, N, K, M):
    """At the ViT's four shapes and the main path's row counts (128 crops,
    a call's last chunk of 11, one crop), the kernel's worst error from the
    float64 product is within 4x of cuBLAS's strict float32 SGEMM's."""
    import tepose_tpu_torch.ops.vit_linear as VL

    x, w, b, _ = _vit_inputs(M, N, K, cuda)
    before = VL.LAUNCHES
    y = VL.vit_linear(x, w, b)
    torch.cuda.synchronize()
    assert VL.LAUNCHES == before + 1
    want = torch.nn.functional.linear(x.double(), w.double(), b.double())
    sgemm = _rel64(torch.nn.functional.linear(x, w, b), want)
    assert _rel64(y, want) <= 4 * sgemm, (_rel64(y, want), sgemm)


@pytest.mark.parametrize("epilogue", ["bias", "gelu", "residual", "no_bias"])
@pytest.mark.parametrize("bn", [128, 64])
def test_vit_linear_epilogues_match_plain(cuda, epilogue, bn):
    """Each epilogue with each tile width, on a ragged row count, against
    the plain version in float64, within 4x of the plain version's own
    float32 error."""
    import tepose_tpu_torch.ops.vit_linear as VL

    x, w, b, r = _vit_inputs(300, 1280, 1280, cuda, seed=1)
    b = None if epilogue == "no_bias" else b
    kw = {"gelu": {"gelu": True}, "residual": {"residual": r}}.get(epilogue,
                                                                  {})
    code = VL.EPILOGUES["gelu" if epilogue == "gelu" else
                        "residual" if epilogue == "residual" else "bias"]
    got = VL._operator()[1](x, w, b, kw.get("residual"), code, bn)
    want = VL.vit_linear_reference(
        x.double(), w.double(), None if b is None else b.double(),
        gelu=epilogue == "gelu",
        residual=r.double() if epilogue == "residual" else None)
    plain = VL.vit_linear_reference(x, w, b, **kw)
    assert _rel64(got, want) <= 4 * _rel64(plain, want)


def test_vit_linear_refuses_bad_inputs(cuda):
    import tepose_tpu_torch.ops.vit_linear as VL

    x, w, b, r = _vit_inputs(192, 1280, 1280, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        VL.vit_linear(x.t().contiguous().t(), w, b)
    with pytest.raises(ValueError, match="contiguous"):
        VL.vit_linear(x, w, b, residual=r.t().contiguous().t())
    with pytest.raises(TypeError, match="float32"):
        VL.vit_linear(x.double(), w.double(), b.double())
    with pytest.raises(TypeError, match="float32"):
        VL.vit_linear(x, w.half(), b)
    with pytest.raises(ValueError, match="16-byte"):
        VL.vit_linear(torch.empty(192 * 1280 + 1, device=cuda)[1:].view(
            192, 1280), w, b)
    with pytest.raises(ValueError, match="one device"):
        VL.vit_linear(x, w, b.cpu())
    with pytest.raises(ValueError, match="multiples of 32"):
        VL.vit_linear(x[:, :1000].contiguous(), w[:, :1000].contiguous(), b)
    with pytest.raises(ValueError, match="tile width"):
        VL.vit_linear(x, w[:96].contiguous(), b[:96].contiguous())
    with pytest.raises(RuntimeError, match="forward only"):
        VL.vit_linear(x, w.clone().requires_grad_(), b)


def test_hmr2_chunk_launches_the_vit_kernel(cuda):
    """One 128-crop chunk of `hmr2_forward` at the published widths makes
    4 x 32 launches, one for each linear of each block."""
    import tepose_tpu_torch.ops.vit_linear as VL
    from tepose_tpu_torch.models.hmr2 import HMR2, hmr2_forward

    model = HMR2(device="meta").to_empty(device=cuda).eval()
    g = torch.Generator(device=cuda).manual_seed(0)
    with torch.no_grad():
        for t in [*model.parameters(), *model.buffers()]:
            t.copy_(torch.randn(t.shape, device=cuda, generator=g) * 0.02)
    smpl = synthetic_smpl_model(0, 6890, device=cuda)
    images = torch.randn(128, 3, 256, 256, device=cuda, generator=g)
    before = VL.LAUNCHES
    with torch.inference_mode():
        out = hmr2_forward(model, smpl, images)
    torch.cuda.synchronize()
    assert VL.LAUNCHES - before == 4 * 32
    assert torch.isfinite(out["verts"]).all()


def test_vit_linear_kernels_are_credited_to_the_span_around_them(cuda):
    """The launch sits inside the operator `tepose::vit_linear_3xtf32`, so a
    profiler credits its kernels (the W split and the product) to the host
    events around the call: a span's device time holds them."""
    from torch.profiler import ProfilerActivity, profile

    import tepose_tpu_torch.ops.vit_linear as VL
    from tepose_tpu_torch.utils.profiling import span

    x, w, b, r = _vit_inputs(2112, 1280, 1280, cuda)
    VL.vit_linear(x, w, b, residual=r)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with span("hmr2.backbone"):
            VL.vit_linear(x, w, b, residual=r)
        torch.cuda.synchronize()
    names = []
    stack = [e for e in prof.events() if e.name == "tepose:hmr2.backbone"
             and e.device_type == torch.autograd.DeviceType.CPU]
    assert len(stack) == 1
    while stack:
        e = stack.pop()
        names += [k.name for k in e.kernels]
        stack.extend(e.cpu_children)
    assert any("vit_gemm_kernel" in n for n in names), names
    assert any("split_tf32_kernel" in n for n in names), names
