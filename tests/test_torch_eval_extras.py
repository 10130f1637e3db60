"""Port parity of Temporal SMPLify and evaluate's --filter, --render,
--render_plain and --plot.

SMPLify: the objective's value and gradient against `jax.value_and_grad` of
the JAX module's objective, the guarded angle-axis conversion's gradients,
short and full runs against `tepose_tpu.models.smplify.smplify_refine`
(V = 128, T = 5), that only the final forward skins, and the demo golden's
writer and committed file. Bars: the objective 1e-5 relative, its gradient
1e-4 of each leaf's largest element; runs within 4x the float32-versus-
float64 drift that tools/make_torch_demo_golden.py measures at their size
(SMPLIFY_BARS at full width). evaluate: `run_eval` with the flags
against the JAX `run_eval` on shared small weights (TePose and VIBE 1 x 16,
96 vertices): metrics within 1e-4 relative, the --plot arrays within 1e-3
mm/s^2 plus 1e-4 relative, the --render_plain videos within the golden-
image bars of tests/test_render_golden.py.
"""

import argparse
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import evaluate as jax_evaluate
from tepose_tpu.models import smplify as JS
from tepose_tpu.models.regressor import projection as jax_projection
from tepose_tpu.models.smpl import (
    smpl_forward as jax_smpl_forward, synthetic_smpl_model as jax_smpl)
from tepose_tpu.models.tepose import (
    TePoseConfig as JaxTePoseConfig, VibeConfig as JaxVibeConfig,
    tepose_init, vibe_init)
from tepose_tpu.ops import geometry as JG
from tepose_tpu_torch import config as TCFG
from tepose_tpu_torch import evaluate as port_evaluate
from tepose_tpu_torch.models import smpl as TSMPL
from tepose_tpu_torch.models import smplify as TS
from tepose_tpu_torch.models.smpl import synthetic_smpl_model
from tepose_tpu_torch.models.tepose import (
    TePose, TePoseConfig, Vibe, VibeConfig)
from tepose_tpu_torch.ops import geometry as TG
from tepose_tpu_torch.weights import state_dict_from_jax_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import make_torch_demo_golden as golden_writer  # noqa: E402
from test_render_golden import _ssim  # noqa: E402

V, T = 128, 5
BARS = golden_writer.SMPLIFY_BARS


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs six workers on this host's
    cores, and these tests' small ops gain nothing from more."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def fit():
    """A perturbed fit and noisy targets at V = 128, T = 5."""
    rs = np.random.RandomState(3)
    aa = (rs.randn(T, 24, 3) * 0.3).astype(np.float32)
    rot = np.asarray(JG.batch_rodrigues(jnp.asarray(aa.reshape(-1, 3))))
    kp = np.concatenate([rs.randn(T, 49, 2) * 0.4, rs.rand(T, 49, 1)], -1)
    kp[..., 2][rs.rand(T, 49) < 0.1] = 0.0
    return dict(rotmat=rot.reshape(T, 24, 3, 3),
                betas=(rs.randn(T, 10) * 0.3).astype(np.float32),
                cam=(np.tile([0.9, 0.02, -0.01], (T, 1))
                     + rs.randn(T, 3) * 0.01).astype(np.float32),
                kp=kp.astype(np.float32))


def _jax_objective(smpl, cfg, kp_2d):
    """The objective of tepose_tpu/models/smplify.py:83-107."""
    conf, target = kp_2d[..., 2:], kp_2d[..., :2]

    def objective(p):
        n = p["pose6d"].shape[0]
        rotmat = JG.rot6d_to_rotmat(p["pose6d"].reshape(-1, 6)).reshape(
            n, 24, 3, 3)
        out = jax_smpl_forward(smpl, p["betas"], rotmat)
        pred2d = jax_projection(out["joints49"], p["cam"])
        reproj = (conf * (pred2d - target) ** 2).sum((1, 2))
        pose_aa = JG.rotmat_to_angle_axis(rotmat.reshape(-1, 3, 3)).reshape(
            n, 24, 3)
        smooth_pose = jnp.concatenate(
            [jnp.zeros((1,)),
             ((p["pose6d"][1:] - p["pose6d"][:-1]) ** 2).sum((1, 2))])
        smooth_cam = jnp.concatenate(
            [jnp.zeros((1,)), ((p["cam"][1:] - p["cam"][:-1]) ** 2).sum(-1)])
        total = (cfg.kp_weight * reproj
                 + cfg.shape_prior_weight * (p["betas"] ** 2).sum(-1)
                 + cfg.smooth_pose_weight * smooth_pose
                 + cfg.smooth_cam_weight * smooth_cam
                 + cfg.angle_prior_weight * JS._angle_prior(pose_aa))
        return total.sum()

    return objective


def test_smplify_objective_value_and_grad_match_jax(fit):
    cfg = JS.SmplifyConfig()
    p = {"pose6d": np.asarray(JG.rotmat_to_rot6d(jnp.asarray(fit["rotmat"]))),
         "betas": fit["betas"], "cam": fit["cam"]}
    with jax.default_matmul_precision("float32"):
        value, grad = jax.jit(jax.value_and_grad(_jax_objective(
            jax_smpl(0, V), cfg, jnp.asarray(fit["kp"]))))(
                {k: jnp.asarray(v) for k, v in p.items()})
    params = TS.SmplifyParams(*(torch.tensor(p[k])
                                for k in ("pose6d", "betas", "cam")))
    loss = TS.smplify_objective(synthetic_smpl_model(0, V), params,
                                torch.from_numpy(fit["kp"]),
                                TS.SmplifyConfig())
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(value), rtol=1e-5)
    for k in ("pose6d", "betas", "cam"):
        g, want = getattr(params, k).grad.numpy(), np.asarray(grad[k])
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(), err_msg=k)


def test_rotmat_to_angle_axis_gradients_finite_as_in_jax(rng):
    """The guarded `where`s give finite gradients at the identity, at 180
    degrees about each axis, at tiny angles and at random rotations, equal
    to JAX's within 1e-4 of their magnitude."""
    aa = np.concatenate([
        np.zeros((1, 3)), np.eye(3) * np.pi, np.eye(3) * 1e-7,
        rng.randn(8, 3)]).astype(np.float32)
    rot = np.asarray(JG.batch_rodrigues(jnp.asarray(aa)))
    w = rng.randn(*aa.shape).astype(np.float32)
    want = np.asarray(jax.grad(lambda r: (JG.rotmat_to_angle_axis(r) * w)
                               .sum())(jnp.asarray(rot)))
    r = torch.tensor(rot, requires_grad=True)
    (TG.rotmat_to_angle_axis(r) * torch.from_numpy(w)).sum().backward()
    got = r.grad.numpy()
    assert np.isfinite(want).all() and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


# The golden tool's inputs at the tests' size; bars 4x the larger float32-
# versus-float64 drift `tools/make_torch_demo_golden.py drift` measured at
# this size for 5 and 60 iterations (JAX's: kp_3d and verts 1.72e-6, kp_2d
# 1.57e-6; the other outputs within the full-width bars)
RUN_SPEC = dict(golden_writer.FULL_SPEC, num_verts=V, T=T,
                num_vert_subset=64, vert_frame_step=1)
RUN_BARS = dict(BARS, kp_3d=7e-6, kp_2d=7e-6, verts=7e-6)


@pytest.mark.parametrize("num_iters", [5, 60])
def test_smplify_run_matches_jax(num_iters):
    """Short and full (the default 60 iterations) runs on the same fit."""
    spec = dict(RUN_SPEC, num_iters=num_iters)
    kp = golden_writer.jax_targets(spec)
    want = golden_writer.jax_smplify(spec, kp)
    got = golden_writer.port_smplify(spec, kp, "cpu")
    assert got.keys() == want.keys()
    assert got["losses"][-1] < got["losses"][0]
    dev = golden_writer.deviation(golden_writer.smplify_outputs(got, spec),
                                  golden_writer.smplify_outputs(want, spec))
    assert all(d <= RUN_BARS[k] for k, d in dev.items()), dev


def test_smplify_skins_only_the_final_forward(fit, monkeypatch):
    calls = []
    orig = TSMPL.lbs_skinning

    def counting(*a):
        calls.append(a[2].shape[0])
        return orig(*a)

    monkeypatch.setattr(TSMPL, "lbs_skinning", counting)
    smpl = synthetic_smpl_model(0, V)
    # inputs made under inference mode, as an engine's outputs would be
    with torch.inference_mode():
        out = TS.smplify_refine(
            smpl, *(torch.tensor(fit[k]) for k in
                    ("rotmat", "betas", "cam", "kp")),
            TS.SmplifyConfig(num_iters=3))
    assert calls == [T]
    assert out["verts"].shape == (T, V, 3)


SMALL_SPEC = dict(golden_writer.FULL_SPEC, num_verts=300, T=6, num_iters=10,
                  num_vert_subset=40, vert_frame_step=2, filter_len=12)


def test_demo_golden_writer_matches_port_small():
    golden = golden_writer.make_golden(SMALL_SPEC)
    got = golden_writer.port_smplify(SMALL_SPEC, golden["kp_2d_target"],
                                     "cpu")
    dev = golden_writer.golden_deviation(
        golden_writer.smplify_outputs(got, SMALL_SPEC), golden)
    assert all(d <= bar for d, bar in dev.values()), dev
    j14 = golden_writer.port_filter(SMALL_SPEC, golden["filter_theta"],
                                    "cpu")
    np.testing.assert_allclose(j14, golden["filter_j14"], rtol=0,
                               atol=golden_writer.FILTER_ATOL)


def test_committed_demo_golden_matches_port_on_cpu():
    """The committed full-width golden, which the card is held to, is
    reproduced by the port on the CPU within the same bars."""
    path = golden_writer.GOLDEN_PATH
    assert os.path.getsize(path) < 200_000
    golden = golden_writer.load_golden(path)
    spec = golden["spec"]
    assert spec == golden_writer.FULL_SPEC
    got = golden_writer.port_smplify(spec, golden["kp_2d_target"], "cpu")
    dev = golden_writer.golden_deviation(
        golden_writer.smplify_outputs(got, spec), golden)
    assert all(d <= bar for d, bar in dev.values()), dev
    assert golden["smplify_losses"][-1] < golden["smplify_losses"][0]
    j14 = golden_writer.port_filter(spec, golden["filter_theta"], "cpu")
    np.testing.assert_allclose(j14, golden["filter_j14"], rtol=0,
                               atol=golden_writer.FILTER_ATOL)


# ------------------------------------------------------------ evaluate

EV = 96


_SYNTHETIC_EVAL_DATA = port_evaluate.synthetic_eval_data


def _tiny_eval_data():
    return _SYNTHETIC_EVAL_DATA(num_videos=2, min_len=20, max_len=30, seed=4)


@pytest.fixture(scope="module")
def eval_models():
    """Shared small weights: the JAX trees and the port's modules."""
    jcfg = JaxTePoseConfig(seqlen=6, n_layers=1, hidden_size=16)
    jvcfg = JaxVibeConfig(seqlen=16, n_layers=1, hidden_size=16,
                          add_linear=True)
    jgen = jax.device_get(tepose_init(jax.random.PRNGKey(0), jcfg))
    jvibe = jax.device_get(vibe_init(jax.random.PRNGKey(1), jvcfg))
    g = torch.Generator().manual_seed(0)
    gen = TePose(TePoseConfig(6, 1, 16), generator=g, device="cpu")
    vibe = Vibe(VibeConfig(16, 1, 16, add_linear=True), generator=g,
                device="cpu")
    gen.load_state_dict(state_dict_from_jax_tree(jgen), strict=True)
    vibe.load_state_dict(state_dict_from_jax_tree(jvibe), strict=True)
    jreg = port_evaluate.synthetic_j_regressor(EV)
    return dict(
        jax=(jax_smpl(0, EV), jcfg, jvcfg, jgen, jvibe, jreg),
        port=(synthetic_smpl_model(0, EV), gen.eval(), vibe.eval(),
              torch.from_numpy(jreg)))


def _eval_args(**kw):
    ns = argparse.Namespace(dataset="3dpw", seq="", render=False,
                            render_plain=False, filter=False, plot=False,
                            frame=0, eval_batch=None, eval_bucket=None)
    for k, v in kw.items():
        setattr(ns, k, v)
    return ns


def _run_both(eval_models, monkeypatch, tmp_path, **flags):
    """run_eval of both packages on the shared weights and data, each in a
    directory of its own (their outputs land under ./output)."""
    monkeypatch.setattr(jax_evaluate, "build_models",
                        lambda cfg, synthetic: eval_models["jax"])
    monkeypatch.setattr(port_evaluate, "build_models",
                        lambda cfg, synthetic, device: eval_models["port"])
    for m in (jax_evaluate, port_evaluate):
        monkeypatch.setattr(m, "synthetic_eval_data", _tiny_eval_data)
    cfg = TCFG.get_cfg_defaults()
    cfg.DATASET.SEQLEN = 6
    out = {}
    for name in ("jax", "port"):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        if name == "jax":
            with jax.default_matmul_precision("float32"):
                out[name] = jax_evaluate.run_eval(cfg, _eval_args(**flags),
                                                  synthetic=True)
        else:
            out[name] = port_evaluate.run_eval(cfg, _eval_args(**flags),
                                               synthetic=True, device="cpu")
    for k, v in out["jax"].items():
        np.testing.assert_allclose(out["port"][k], v, rtol=1e-4, err_msg=k)
    return {n: tmp_path / n / "output" / "3dpw_test_output"
            for n in ("jax", "port")}


def _video_frames(path):
    import cv2

    cap = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f)
    cap.release()
    return frames


def _same_video(a, b):
    fa, fb = _video_frames(a), _video_frames(b)
    assert len(fa) == len(fb) > 0
    assert all(f.max() > 0 for f in fa)     # a mesh in every frame
    for x, y in zip(fa, fb):
        diff = np.abs(x.astype(int) - y.astype(int))
        assert diff.mean() < 3.0 and (diff > 10).mean() < 0.02
        assert _ssim(x[..., ::-1], y[..., ::-1]) > 0.97


def test_run_eval_filter_plot_render_plain_match_jax(eval_models,
                                                     monkeypatch, tmp_path):
    pytest.importorskip("cv2")
    pytest.importorskip("matplotlib")
    dirs = _run_both(eval_models, monkeypatch, tmp_path, filter=True,
                     plot=True, render_plain=True)
    names = sorted(_tiny_eval_data())
    for n in names:
        arrays = [np.load(dirs[k] / "plot" / f"tepose_accel_pred_{n}.npy")
                  for k in ("port", "jax")]
        np.testing.assert_allclose(*arrays, rtol=1e-4, atol=1e-3)
        assert (dirs["port"] / "plot"
                / f"tepose_accel_pred_error_{n}.png").is_file()
        _same_video(*(dirs[k] / "video" / f"tepose_{n}_plain_0.mp4"
                      for k in ("port", "jax")))


def test_run_eval_render_matches_jax(eval_models, monkeypatch, tmp_path):
    """--render without --filter: the synthetic data have no images or
    boxes, so both packages draw on a black canvas at cam [1, 1, 0, 0]."""
    pytest.importorskip("cv2")
    dirs = _run_both(eval_models, monkeypatch, tmp_path, render=True)
    for n in sorted(_tiny_eval_data()):
        _same_video(*(dirs[k] / "video" / f"tepose_{n}_0.mp4"
                      for k in ("port", "jax")))


def test_run_eval_filter_refuses_mpii3d():
    with pytest.raises(SystemExit, match="not supported for mpii3d"):
        port_evaluate.run_eval(None, _eval_args(dataset="mpii3d",
                                                filter=True),
                               synthetic=True, device="cpu")
