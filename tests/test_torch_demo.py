"""`python -m tepose_tpu_torch.demo` end to end against the JAX `demo.py`.

Both CLIs run on the same mp4 with their `build_demo_models` replaced by
the same small weights (the JAX trees, and the port's modules loaded from
them through `weights.state_dict_from_jax_tree`): TePose 1 x 16, VIBE
1 x 16, the random He-init ResNet-50 on 64 x 64 crops, SMPL with 64
vertices and convex-hull faces, as tests/test_live_demo.py shrinks the
JAX demo. Offline: OpenPose JSONs with --smooth, --sideview, --save_pkl
and --save_obj, and with --run_smplify; live: two streams with the people
tracker and one with the person tracker. Bars: outputs without SMPLify
within rtol/atol 1e-4, the crops-path bar of tests/test_torch_serve.py (the
ResNet-50's features are near 1e3); after SMPLify 4x the port's own
spread on the same tracklets (float32 against float64, and against a
1e-5 perturbation of its start), measured in the test: these synthetic
keypoints leave the 3D pose undetermined, so float noise moves it by up to
a few percent; rendered videos within the golden-image bars of
tests/test_render_golden.py.
"""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

import demo as jax_demo
import tepose_tpu.native as jax_native
import tepose_tpu_torch.native as port_native
from tepose_tpu.models.backbone import resnet50_init as jax_resnet50_init
from tepose_tpu.models.smpl import synthetic_smpl_model as jax_smpl
from tepose_tpu.models.tepose import (
    TePoseConfig as JaxTePoseConfig, VibeConfig as JaxVibeConfig,
    tepose_init, vibe_init)
from tepose_tpu_torch import demo as port_demo
from tepose_tpu_torch.models.backbone import ResNet50
from tepose_tpu_torch.models.smpl import hull_faces, synthetic_smpl_model
from tepose_tpu_torch.models.tepose import (
    TePose, TePoseConfig, Vibe, VibeConfig)
from tepose_tpu_torch.weights import state_dict_from_jax_tree

TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, TESTS)

from test_live_demo import _two_person_churn_frames  # noqa: E402
from test_torch_eval_extras import _same_video  # noqa: E402

pytestmark = pytest.mark.heavy

TOL = dict(rtol=1e-4, atol=1e-4)
CROP = 64


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs six workers on this host's
    cores, and these tests' small ops gain nothing from more."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def models():
    jcfg = JaxTePoseConfig(seqlen=6, n_layers=1, hidden_size=16)
    jvcfg = JaxVibeConfig(seqlen=16, n_layers=1, hidden_size=16,
                          add_linear=True)
    jgen = jax.device_get(tepose_init(jax.random.PRNGKey(0), jcfg))
    jvibe = jax.device_get(vibe_init(jax.random.PRNGKey(1), jvcfg))
    jbb = jax.device_get(jax_resnet50_init(jax.random.PRNGKey(2)))
    g = torch.Generator().manual_seed(0)
    gen = TePose(TePoseConfig(6, 1, 16), generator=g, device="cpu")
    vibe = Vibe(VibeConfig(16, 1, 16, add_linear=True), generator=g,
                device="cpu")
    bb = ResNet50(device="cpu")
    for mod, tree in ((gen, jgen), (vibe, jvibe), (bb, jbb)):
        mod.load_state_dict(state_dict_from_jax_tree(tree), strict=True)
    smpl = synthetic_smpl_model(0, 64)
    faces = hull_faces(smpl)
    return dict(
        jax=(jax_smpl(0, 64), faces, jcfg, jvcfg, jgen, jvibe, jbb),
        port=port_demo.DemoModels(smpl=smpl, faces=faces, gen=gen.eval(),
                                  vibe=vibe.eval(), backbone=bb.eval()))


@pytest.fixture
def shared(models, monkeypatch):
    """Both demos build the shared models and crop at 64 x 64."""
    monkeypatch.setattr(jax_demo, "build_demo_models",
                        lambda args: models["jax"])
    monkeypatch.setattr(port_demo, "build_demo_models",
                        lambda args: models["port"])
    for mod in (jax_native, port_native):
        orig = mod.crop_normalize
        monkeypatch.setattr(
            mod, "crop_normalize",
            lambda img, boxes, out_size=224, scale=1.2, normalize=True,
            _orig=orig: _orig(img, boxes, CROP, scale, normalize))
    return models


def _write_video(frames, path):
    import cv2

    wr = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 25,
                         (frames[0].shape[1], frames[0].shape[0]))
    for f in frames:
        wr.write(f)
    wr.release()


def _write_pose_jsons(folder, n, seed=0):
    """Two people's OpenPose (staf, 21 joints) keypoints around the two
    figures of `_two_person_churn_frames`, one JSON per frame."""
    rs = np.random.RandomState(seed)
    offsets = rs.randn(2, 21, 2) * [14, 30]
    os.makedirs(folder)
    for t in range(n):
        people = []
        for pid, (cx, cy) in enumerate(((80 + 25 * np.sin(t / 9.0), 108),
                                        (230, 132 + 12 * np.sin(t / 11.0)))):
            xy = offsets[pid] + [cx, cy] + rs.randn(21, 2)
            kp = np.concatenate([xy, 0.5 + rs.rand(21, 1) * 0.5], 1)
            people.append({"person_id": [pid],
                           "pose_keypoints_2d": kp.ravel().tolist()})
        with open(os.path.join(folder, f"{t:06d}_keypoints.json"), "w") as f:
            json.dump({"people": people}, f)


def _close(got, want, err_msg, **tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, err_msg
    np.testing.assert_allclose(got, want, err_msg=err_msg, **tol)


def _run_both(monkeypatch, tmp_path, argv, run):
    """`run(module, argv)` for each demo with its own output folder; the
    JAX demo reads its arguments from sys.argv."""
    out = {}
    for name, mod in (("jax", jax_demo), ("port", port_demo)):
        folder = str(tmp_path / name)
        full = argv + ["--output_folder", folder, "--synthetic"]
        if mod is jax_demo:
            monkeypatch.setattr(sys, "argv", ["demo.py"] + full)
            with jax.default_matmul_precision("float32"):
                run(mod, None)
        else:
            run(mod, full + ["--gpu", "cpu"])
        out[name] = folder
    return out


def _duo_inputs(tmp_path, n=28):
    frames, _ = _two_person_churn_frames(n_frames=n, leave_at=40)
    vid = tmp_path / "duo.mp4"
    _write_video(frames, vid)
    staf = str(tmp_path / "staf")
    _write_pose_jsons(staf, n)
    return frames, ["--vid_file", str(vid), "--tracking_method", "pose",
                    "--staf_dir", staf, "--save_pkl"]


def _main(mod, full):
    mod.main(*([] if full is None else [full]))


def _load_results(dirs):
    import joblib

    res = {k: joblib.load(os.path.join(d, "tepose_duo_output.pkl"))
           for k, d in dirs.items()}
    assert sorted(res["port"]) == sorted(res["jax"]) == [0, 1]
    for pid in (0, 1):
        got, want = res["port"][pid], res["jax"][pid]
        assert got.keys() == want.keys()
        np.testing.assert_array_equal(got["frame_ids"], want["frame_ids"])
        np.testing.assert_array_equal(got["bboxes"], want["bboxes"])
    return res


def test_demo_offline_matches_jax(shared, monkeypatch, tmp_path):
    """OpenPose tracklets, the engine, --smooth, --sideview rendering,
    --save_pkl and --save_obj."""
    pytest.importorskip("joblib")
    pytest.importorskip("cv2")
    _, argv = _duo_inputs(tmp_path)
    dirs = _run_both(monkeypatch, tmp_path,
                     argv + ["--smooth", "--sideview", "--save_obj"], _main)
    res = _load_results(dirs)
    for pid in (0, 1):
        for k in ("pred_cam", "orig_cam", "verts", "pose", "betas",
                  "joints3d", "kp_2d"):
            _close(res["port"][pid][k], res["jax"][pid][k], f"{pid}/{k}",
                   **TOL)
    _same_video(*(os.path.join(dirs[k], "tepose_duo_result.mp4")
                  for k in ("port", "jax")))
    objs = [os.path.join(dirs[k], "duo_obj", "p1_f000007.obj")
            for k in ("port", "jax")]
    lines = [open(p).read().splitlines() for p in objs]
    assert [x for x in lines[0] if x[0] == "f"] == \
        [x for x in lines[1] if x[0] == "f"]
    v = [np.array([x.split()[1:] for x in ln if x[0] == "v"], float)
         for ln in lines]
    _close(v[0], v[1], "obj", **TOL)


def _smplify_sensitivity(models, frames, argv):
    """The port's own SMPLify spread on the test's tracklets, per output,
    relative to its magnitude: the larger of float32 against float64 and
    float32 against float32 from an engine theta perturbed by 1e-5
    relative (the port and JAX engines differ by ~1e-5)."""
    import copy

    from tepose_tpu_torch.data.kp_utils import convert_kps
    from tepose_tpu_torch.data.transforms import (
        normalize_2d_kp, transform_keypoints)
    from tepose_tpu_torch.models.smplify import smplify_refine
    from tepose_tpu_torch.ops.geometry import batch_rodrigues

    m = models["port"]
    args = port_demo.parse_args(argv + ["--gpu", "cpu"])
    tracklets = port_demo.track(frames, args)
    outs = port_demo.run_offline(frames, tracklets, m, args)["engine_outputs"]
    smpl64 = copy.deepcopy(m.smpl).double()
    rs = np.random.RandomState(0)
    spread = {}
    for (pid, tr), eo in zip(tracklets.items(), outs):
        sq = port_demo.tracklet_crops(frames, tr)[0]
        kp = convert_kps(tr["joints2d"], "staf", "spin")
        kp[..., :2] = normalize_2d_kp(transform_keypoints(kp[..., :2], sq))

        def refine(theta, smpl, dtype):
            th = torch.tensor(theta, dtype=torch.float32)
            rot = batch_rodrigues(th[:, 3:75].reshape(-1, 3)).reshape(
                -1, 24, 3, 3)
            th = th.to(dtype)
            out = smplify_refine(smpl, rot.to(dtype), th[:, 75:],
                                 th[:, :3], torch.tensor(kp, dtype=dtype))
            return {k: v.double().numpy() for k, v in out.items()}

        base = refine(eo["theta"], m.smpl, torch.float32)
        others = (refine(eo["theta"], smpl64, torch.float64),
                  refine(eo["theta"] * (1 + 1e-5 * rs.randn(
                      *eo["theta"].shape)), m.smpl, torch.float32))
        for key, out_key, sl in (
                ("pred_cam", "theta", np.s_[:, :3]),
                ("pose", "theta", np.s_[:, 3:75]),
                ("betas", "theta", np.s_[:, 75:]),
                ("verts", "verts", np.s_[:]), ("joints3d", "kp_3d", np.s_[:]),
                ("kp_2d", "kp_2d", np.s_[:])):
            a = base[out_key][sl]
            d = max(np.abs(o[out_key][sl] - a).max() for o in others)
            spread[key] = max(spread.get(key, 0.0), d / np.abs(a).max())
    return spread


def test_demo_offline_smplify_matches_jax(shared, monkeypatch, tmp_path):
    """--run_smplify on tracklets whose keypoints do not determine a 3D
    pose (the random network's start and random 2D joints): the bars are 4x
    the port's own spread on the same tracklets (`_smplify_sensitivity`),
    which the test measures first."""
    pytest.importorskip("joblib")
    pytest.importorskip("cv2")
    frames, argv = _duo_inputs(tmp_path)
    spread = _smplify_sensitivity(shared, frames, argv)
    dirs = _run_both(monkeypatch, tmp_path, argv + ["--run_smplify"], _main)
    res = _load_results(dirs)
    for pid in (0, 1):
        got, want = res["port"][pid], res["jax"][pid]
        for k, rel in spread.items():
            _close(got[k], want[k], f"{pid}/{k} (spread {rel:.1e})", rtol=0,
                   atol=4 * rel * np.abs(want[k]).max())
        _close(got["orig_cam"], want["orig_cam"], f"{pid}/orig_cam", rtol=0,
               atol=4 * spread["pred_cam"] * np.abs(want["orig_cam"]).max())


@pytest.mark.parametrize("streams", [1, 2])
def test_demo_live_matches_jax(shared, monkeypatch, tmp_path, streams):
    joblib = pytest.importorskip("joblib")
    pytest.importorskip("cv2")
    frames, _ = _two_person_churn_frames(n_frames=40)
    vid = tmp_path / "duo.mp4"
    _write_video(frames, vid)
    argv = ["--live", "--vid_file", str(vid), "--live_streams",
            str(streams), "--live_bootstrap", "12", "--save_pkl"]

    def run(mod, full):
        args = mod.parse_args(*([] if full is None else [full]))
        assert mod.run_live(args, crop_size=CROP)["frames"] == 40

    dirs = _run_both(monkeypatch, tmp_path, argv, run)
    res = {k: joblib.load(os.path.join(d, "tepose_duo_live_output.pkl"))
           for k, d in dirs.items()}
    assert sorted(res["port"]) == sorted(res["jax"]) == list(range(streams))
    for s in range(streams):
        got, want = res["port"][s], res["jax"][s]
        assert got.keys() == want.keys()
        for k in ("valid", "present", "bboxes"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        for k in ("theta", "verts", "joints3d", "orig_cam"):
            _close(got[k], want[k], f"{s}/{k}", **TOL)
    _same_video(*(os.path.join(dirs[k], "tepose_duo_live_result.mp4")
                  for k in ("port", "jax")))


def test_demo_save_pkl_without_joblib(shared, monkeypatch, tmp_path):
    """--save_pkl writes through `data.db.write_db` with joblib blocked (the
    GPU host has none); joblib.load reads the file back as the port's
    reader does. (--live writes its pkl through the same function.)"""
    joblib = pytest.importorskip("joblib")
    pytest.importorskip("cv2")
    from tepose_tpu_torch.data.db import read_joblib

    _, argv = _duo_inputs(tmp_path)
    folder = str(tmp_path / "out")
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "joblib", None)
        port_demo.main(argv + ["--output_folder", folder, "--synthetic",
                               "--gpu", "cpu"])
    path = os.path.join(folder, "tepose_duo_output.pkl")
    got, want = joblib.load(path), read_joblib(path)
    assert sorted(got) == sorted(want) == [0, 1]
    for pid in (0, 1):
        assert got[pid].keys() == want[pid].keys()
        assert "verts" in got[pid]
        for k in got[pid]:
            np.testing.assert_array_equal(got[pid][k], want[pid][k], k)


def test_demo_refuses_profile_and_joints_only_meshes(tmp_path):
    """--profile was refused until the port had `utils.profiling.trace`;
    now the demo parses it and runs under the trace, where joints-only
    serving still refuses mesh outputs."""
    with pytest.raises(SystemExit, match="serving-joints"):
        port_demo.main(["--synthetic", "--gpu", "cpu", "--profile",
                        str(tmp_path / "trace"), "--serving",
                        "serving-joints", "--sideview"])
    with pytest.raises(SystemExit, match="serving-joints"):
        port_demo.main(["--synthetic", "--serving", "serving-joints",
                        "--sideview"])
