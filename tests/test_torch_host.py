"""The demo slice's host copies against their JAX-package originals.

quaternion slerp, the 1-euro and bbox filters, the demo_utils conversions
and video IO, the trackers and detectors on synthetic frames, the detection
and OpenPose loaders, vis, the kp_utils skeleton tables,
estimate_translation and plot_accel are copies: on the same numpy inputs
they must give equal outputs (exactly, as they run the same numpy code).
The native rasterizer and crops are a copy of the C++ built by the port
itself: equal bytes to the JAX package's library, its numpy versions within
the JAX package's own tests' tolerances, and the committed golden images
within tests/test_render_golden.py's bars.
"""

import json
import os
import sys

import numpy as np
import pytest

from tepose_tpu import native as JN
from tepose_tpu.data import kp_utils as JKP
from tepose_tpu.eval import metrics as JM
from tepose_tpu.ops import filters as JF
from tepose_tpu.ops import geometry as JG
from tepose_tpu.ops import quaternion as JQ
from tepose_tpu.streaming import demo_utils as JDU
from tepose_tpu.streaming import tracker as JT
from tepose_tpu.utils import vis as JVIS
from tepose_tpu_torch import native as TN
from tepose_tpu_torch.data import kp_utils as TKP
from tepose_tpu_torch.eval import metrics as TM
from tepose_tpu_torch.kernels import BUILD_DIR
from tepose_tpu_torch.ops import filters as TF
from tepose_tpu_torch.ops import geometry as TG
from tepose_tpu_torch.ops import quaternion as TQ
from tepose_tpu_torch.streaming import demo_utils as TDU
from tepose_tpu_torch.streaming import tracker as TT
from tepose_tpu_torch.utils import vis as TVIS

TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(TESTS), "tools"))

import make_render_goldens as RG  # noqa: E402
from test_live_demo import (  # noqa: E402
    _moving_person_frames, _two_person_churn_frames)
from test_render_golden import _assert_matches_golden  # noqa: E402


def _eq(a, b):
    """Equal nested outputs: dicts, sequences, arrays, scalars."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _eq(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _eq(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _rotmats(rng, T, J):
    return JG.batch_rodrigues(rng.randn(T * J, 3).astype(np.float32)
                              * 0.8).reshape(T, J, 3, 3)


# ------------------------------------------------------------ ops copies


def test_quaternion_copy_matches(rng):
    rm = np.asarray(_rotmats(rng, 12, 5))
    for ratio in (0.3, 0.7):
        _eq(TQ.smooth_rotmats_slerp(rm, ratio), JQ.smooth_rotmats_slerp(rm,
                                                                        ratio))
    q = [JQ.quaternion_from_matrix(m) for m in rm[:, 0]]
    for m, want in zip(rm[:, 0], q):
        _eq(TQ.quaternion_from_matrix(m), want)
        _eq(TQ.quaternion_matrix(want), JQ.quaternion_matrix(want))
    for f in (0.0, 0.25, 1.0):
        _eq(TQ.quaternion_slerp(q[0], q[1], f), JQ.quaternion_slerp(q[0],
                                                                    q[1], f))
    flipped = np.stack(q) * np.where(rng.rand(len(q)) > 0.5, 1, -1)[:, None]
    _eq(TQ.quat_correct_sequence(flipped), JQ.quat_correct_sequence(flipped))


def test_filters_copy_matches(rng):
    pose = rng.randn(30, 72) * 0.3
    betas = rng.randn(30, 10)
    _eq(TF.smooth_pose_params(pose, betas, 0.004, 0.7),
        JF.smooth_pose_params(pose, betas, 0.004, 0.7))
    f_t, f_j = (m.OneEuroFilter(0, pose[0], min_cutoff=0.5, beta=0.3)
                for m in (TF, JF))
    for t in range(1, 10):
        _eq(f_t(t, pose[t]), f_j(t, pose[t]))
    kps = [rng.rand(17, 3) * [200, 150, 1] for _ in range(20)]
    kps[3] = None
    kps[7][:, 2] = 0.0
    for vis in (0.3, 2.0):
        _eq(TF.get_all_bbox_params(kps, vis), JF.get_all_bbox_params(kps,
                                                                    vis))
    _eq(TF.get_smooth_bbox_params(kps, 0.3), JF.get_smooth_bbox_params(kps,
                                                                      0.3))
    params = rng.rand(25, 3).astype(np.float32) + 1
    for k in (4, 11):
        _eq(TF.smooth_bbox_params(params, k, 3.0),
            JF.smooth_bbox_params(params, k, 3.0))
    _eq(TF.bbox_params_to_cxcywh(params), JF.bbox_params_to_cxcywh(params))
    assert TF.kp_to_bbox_param(None) is None


def test_geometry_additions_match(rng):
    import jax.numpy as jnp
    import torch

    rm = np.array(_rotmats(rng, 4, 24))
    np.testing.assert_array_equal(
        TG.rotmat_to_rot6d(torch.from_numpy(rm)).numpy(),
        np.asarray(JG.rotmat_to_rot6d(jnp.asarray(rm))))
    S = rng.randn(3, 49, 3) * 0.3 + [0, 0, 5]
    j2d = np.concatenate([rng.rand(3, 49, 2) * 224, rng.rand(3, 49, 1)], -1)
    _eq(TG.estimate_translation(S, j2d), JG.estimate_translation(S, j2d))
    _eq(TG.estimate_translation_np(S[0, 25:], j2d[0, 25:, :2],
                                   j2d[0, 25:, 2], 1000.0, 256.0),
        JG.estimate_translation_np(S[0, 25:], j2d[0, 25:, :2],
                                   j2d[0, 25:, 2], 1000.0, 256.0))


def test_kp_utils_skeletons_match():
    assert sorted(TKP._SKELETONS) == sorted(JKP._SKELETONS)
    assert TKP.COMMON_LR == JKP.COMMON_LR
    for fmt in sorted(JKP._REGISTRY):
        _eq(TKP.skeleton(fmt), JKP.skeleton(fmt))


def test_plot_accel_matches(rng, tmp_path):
    pytest.importorskip("matplotlib")
    pred = rng.randn(30, 14, 3).astype(np.float32)
    gt = pred + rng.randn(30, 14, 3).astype(np.float32) * 0.05
    paths = [m.plot_accel(pred, gt, str(tmp_path / name), name="v")
             for m, name in ((TM, "port"), (JM, "jax"))]
    assert all(os.path.isfile(p) for p in paths)
    _eq(*(np.load(os.path.join(os.path.dirname(p),
                               "tepose_accel_pred_v.npy")) for p in paths))


# ------------------------------------------------------------ demo_utils


def test_demo_utils_conversions_match(rng):
    cam = rng.rand(6, 3) + [0.5, 0, 0]
    bbox = rng.rand(6, 4) * [320, 240, 100, 100] + [0, 0, 50, 50]
    _eq(TDU.convert_crop_cam_to_orig_img(cam, bbox, 320, 240),
        JDU.convert_crop_cam_to_orig_img(cam, bbox, 320, 240))
    kp = rng.rand(6, 49, 2) * 2 - 1
    _eq(TDU.convert_crop_coords_to_orig_img(bbox, kp.copy()),
        JDU.convert_crop_coords_to_orig_img(bbox, kp.copy()))
    results = {p: {"verts": rng.randn(n, 5, 3), "orig_cam": rng.rand(n, 4),
                   "bboxes": rng.rand(n, 3), "frame_ids": ids}
               for p, n, ids in ((0, 4, np.arange(4)),
                                 (7, 3, np.array([1, 3, 5])))}
    got = TDU.prepare_rendering_results(results, 6)
    want = JDU.prepare_rendering_results(results, 6)
    assert [list(f) for f in got] == [list(f) for f in want]
    _eq([dict(f) for f in got], [dict(f) for f in want])


def test_demo_utils_video_io_matches(tmp_path):
    pytest.importorskip("cv2")
    frames, _ = _moving_person_frames(n_frames=8)
    path = str(tmp_path / "v.mp4")
    TDU.write_video(frames, path, fps=25.0)
    assert TDU.video_fps(path) == JDU.video_fps(path) == 25.0
    _eq(list(TDU.read_video_frames(path)), list(JDU.read_video_frames(path)))
    live = str(tmp_path / "live.mp4")
    w = TDU.StreamingVideoWriter(live, 320, 240, 25.0)
    for f in frames:
        w.write(f)
    w.close()
    assert w.n == 8 and len(list(JDU.read_video_frames(live))) == 8
    with pytest.raises(FileNotFoundError):
        next(TDU.read_video_frames(str(tmp_path / "missing.mp4")))


# ------------------------------------------------------------ tracking


def test_iou_tracker_and_loaders_match(rng, tmp_path):
    n = 20
    boxes = np.array([[60, 80, 40, 60], [220, 90, 50, 70]], np.float32)
    frames = np.repeat(np.arange(n), 2)
    jitter = rng.randn(2 * n, 4).astype(np.float32)
    dets = str(tmp_path / "dets.npz")
    np.savez(dets, frames=frames, boxes=np.tile(boxes, (n, 1)) + jitter)
    _eq(TT.load_detections_npz(dets, n), JT.load_detections_npz(dets, n))
    tracked = str(tmp_path / "tracked.npz")
    np.savez(tracked, tracklet_0_bbox=np.tile(boxes[0], (n, 1)),
             tracklet_0_frames=np.arange(n),
             tracklet_1_bbox=np.tile(boxes[1], (5, 1)),
             tracklet_1_frames=np.arange(5) + 3)
    _eq(TT.load_detections_npz(tracked, n), JT.load_detections_npz(tracked,
                                                                   n))
    _eq(TT.detect_people_simple((240, 320, 3), 9),
        JT.detect_people_simple((240, 320, 3), 9))
    json_dir = tmp_path / "staf"
    json_dir.mkdir()
    for t in range(12):
        people = [{"person_id": [pid], "pose_keypoints_2d": (
            np.concatenate([rng.rand(21, 2) * 80 + 60 * pid,
                            rng.rand(21, 1)], 1)).ravel().tolist()}
            for pid in (0, 3) if not (pid == 3 and t == 5)]
        with open(json_dir / f"{t:06d}_keypoints.json", "w") as f:
            json.dump({"people": people}, f)
    got = TT.load_pose_tracklets(str(json_dir))
    assert sorted(got) == [0, 3]
    _eq(got, JT.load_pose_tracklets(str(json_dir)))
    for m in (TT, JT):
        with pytest.raises(FileNotFoundError, match="STAF"):
            m.run_staf("v.mp4", str(tmp_path / "o"), str(tmp_path / "none"))


def test_motion_detectors_match():
    pytest.importorskip("cv2")
    frames = [f for f in _two_person_churn_frames(n_frames=40)[0]]
    for name in ("detect_people_motion", "detect_people_stabilized",
                 "detect_people_auto"):
        got = getattr(TT, name)(frames)
        assert got, name
        _eq(got, getattr(JT, name)(frames))
    _eq(TT.estimate_camera_motion(frames[:12]),
        JT.estimate_camera_motion(frames[:12]))


def test_causal_trackers_match():
    pytest.importorskip("cv2")
    frames, _ = _two_person_churn_frames(n_frames=48)
    for make in (lambda m: m.CausalPersonTracker(bootstrap=10),
                 lambda m: m.CausalPeopleTracker(slots=2, bootstrap=12)):
        port, ref = make(TT), make(JT)
        for f in frames:
            _eq(port.update(f), ref.update(f))
        _eq(port.flush(), ref.flush())
    short, _ = _moving_person_frames(n_frames=6)
    port, ref = TT.CausalPersonTracker(), JT.CausalPersonTracker()
    for f in short:
        _eq(port.update(f), ref.update(f))
    _eq(port.flush(), ref.flush())


# ------------------------------------------------------------ vis


def test_vis_copy_matches(rng):
    pytest.importorskip("cv2")
    for k in (49, 25, 21, 17, 14, 24):
        assert TVIS.infer_kp_format(k) == JVIS.infer_kp_format(k)
    img = rng.randint(0, 255, (96, 128, 3)).astype(np.uint8)
    kp = np.concatenate([rng.rand(49, 2) * 2 - 1, rng.rand(49, 1)], 1)
    for fmt in (None, "common", "spin"):
        k = kp if fmt != "common" else kp[:14]
        _eq(TVIS.draw_skeleton(img.copy(), k, fmt=fmt),
            JVIS.draw_skeleton(img.copy(), k, fmt=fmt))
    verts = (rng.randn(40, 3) * 0.3).astype(np.float32)
    faces = rng.randint(0, 40, (60, 3)).astype(np.int32)
    cam4 = np.array([0.8, 0.9, 0.05, -0.02], np.float32)
    _eq(TVIS.draw_wireframe(img.copy(), verts, cam4, faces),
        JVIS.draw_wireframe(img.copy(), verts, cam4, faces))
    video = rng.randint(0, 255, (3, 2, 64, 64, 3)).astype(np.uint8)
    preds = {"theta": np.tile([0.9, 0, 0], (3, 2, 1)) + rng.rand(3, 2, 3)
             * 0.1, "verts": rng.randn(3, 2, 40, 3) * 0.3,
             "kp_2d": rng.rand(3, 2, 49, 2) * 2 - 1}
    target = {"kp_2d": rng.rand(3, 2, 49, 2) * 2 - 1}
    for f in (faces, None):
        _eq(TVIS.batch_visualize_vid_preds(video, preds, target, f, 2),
            JVIS.batch_visualize_vid_preds(video, preds, target, f, 2))


# ------------------------------------------------------------ native


def test_native_library_is_built_into_build_dir():
    lib = TN.get_lib()
    path = TN.library_path()
    assert lib._name == str(path) and path.is_file()
    assert path.parent == BUILD_DIR
    assert path.name.startswith("libtepose_native_")


def test_native_build_raises_without_gxx(monkeypatch, tmp_path):
    import pathlib

    monkeypatch.setattr(TN, "library_path",
                        lambda: pathlib.Path(tmp_path / "lib.so"))
    monkeypatch.setattr(TN.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        TN.build()


@pytest.mark.parametrize("name", list(RG.scenes().keys()))
def test_native_render_matches_golden_and_jax(name):
    pytest.importorskip("cv2")
    verts, faces, cam, bg, color, alpha = RG.scenes()[name]
    img = TN.render_mesh(verts, faces, cam, bg.copy(), color=color,
                         alpha=alpha)
    _assert_matches_golden(img, name)
    _eq(img, JN.render_mesh(verts, faces, cam, bg.copy(), color=color,
                            alpha=alpha))


def test_native_matches_jax_and_numpy(rng):
    verts = rng.randn(30, 3).astype(np.float32) * 0.3
    faces = rng.randint(0, 30, (40, 3)).astype(np.int32)
    cam = np.array([0.8, 0.8, 0.1, -0.1], np.float32)
    img = rng.randint(0, 255, (80, 80, 3)).astype(np.uint8)
    out = TN.render_mesh(verts, faces, cam, img.copy())
    _eq(out, JN.render_mesh(verts, faces, cam, img.copy()))
    ref = TN.render_mesh_reference(verts, faces, cam, img.copy())
    # tests/test_native.py's bar for the C++ against its numpy version
    assert (np.abs(out.astype(int) - ref.astype(int)) > 2).mean() < 0.01
    bboxes = np.array([[40, 40, 30, 50], [10, 70, 40, 40]], np.float32)
    for normalize in (True, False):
        got = TN.crop_normalize(img, bboxes, out_size=32,
                                normalize=normalize)
        _eq(got, JN.crop_normalize(img, bboxes, out_size=32,
                                   normalize=normalize))
        ref = TN.crop_normalize_reference(img, bboxes, out_size=32,
                                          normalize=normalize)
        assert got.dtype == ref.dtype
        np.testing.assert_allclose(got.astype(np.float32),
                                   ref.astype(np.float32),
                                   atol=1e-4 if normalize else 1, rtol=0)


# ------------------------------------------------ the last host copies


def test_multiple_datasets_copy_matches():
    """MultipleDatasets in both modes draws the same items as JAX's."""
    from tepose_tpu.data.datasets import MultipleDatasets as JMD
    from tepose_tpu_torch.data.datasets import MultipleDatasets as TMD

    members = [list(range(5)), list(range(100, 103)), list(range(200, 207))]
    for same_len in (True, False):
        a, b = (M(members, make_same_len=same_len, seed=3)
                for M in (JMD, TMD))
        assert len(a) == len(b)
        assert [a[i] for i in range(len(a))] == [b[i] for i in range(len(b))]
    with pytest.raises(IndexError):
        TMD(members, make_same_len=False)[len(b)]


def test_full_video_datasets_and_feature_windows_match(rng):
    """ThreeDPW_TEST / Human36M_VAL over a synthetic 3D DB, and
    FeatureDataset's windows: every item equal to the JAX copy's."""
    from tepose_tpu.data import datasets as JD
    from tepose_tpu_torch.data import datasets as TD
    from tests.test_datasets import synthetic_3d_db

    db, pse = synthetic_3d_db(rng, videos=((20, "a"), (9, "b"), (30, "c")))
    for name in ("ThreeDPW_TEST", "Human36M_VAL"):
        a = getattr(JD, name)("repr_wopw_3dpw_model", 6, db=db, psetheta=pse)
        b = getattr(TD, name)("repr_wopw_3dpw_model", 6, db=db, psetheta=pse)
        assert len(a) == len(b) > 0
        for i in range(len(a)):
            _eq(a[i], b[i])
    feats = rng.randn(11, 2048).astype(np.float32)
    a, b = JD.FeatureDataset(feats, 6), TD.FeatureDataset(feats, 6)
    assert len(a) == len(b) == 6
    for i in range(len(a)):
        _eq(a[i], b[i])
    assert len(TD.FeatureDataset(feats[:4], 6)) == 0


def test_crop_dataset_matches(rng):
    """CropDataset on frames and on a frame callable: the port's native
    crops equal the JAX package's for every bbox."""
    from tepose_tpu.data.datasets import CropDataset as JC
    from tepose_tpu_torch.data.datasets import CropDataset as TC

    frames = [rng.randint(0, 255, (120, 160, 3)).astype(np.uint8)
              for _ in range(3)]
    boxes = np.array([[80, 60, 50, 90], [70, 65, 40, 60], [90, 50, 70, 70],
                      [60, 40, 30, 50]], np.float32)
    ids = [0, 2, 1, 2]
    for src in (frames, lambda i: frames[i]):
        a = JC(src, boxes, frame_ids=ids, crop_size=64)
        b = TC(src, boxes, frame_ids=ids, crop_size=64)
        assert len(a) == len(b) == 4
        for i in range(4):
            x, y = a[i], b[i]
            assert y.shape == (3, 64, 64) and y.dtype == np.float32
            np.testing.assert_array_equal(x, y)


def test_pose_metrics_and_procrustes_match(rng):
    """align_pelvis, vertex_error and similarity_transform on tensors
    against the JAX functions (1e-6)."""
    import jax.numpy as jnp
    import torch

    from tepose_tpu.ops import procrustes as JP
    from tepose_tpu_torch.ops import procrustes as TP

    j = rng.randn(4, 5, 14, 3).astype(np.float32)
    np.testing.assert_allclose(TM.align_pelvis(torch.from_numpy(j)).numpy(),
                               np.asarray(JM.align_pelvis(jnp.asarray(j))),
                               atol=1e-6)
    np.testing.assert_allclose(
        TM.align_pelvis(torch.from_numpy(j), 0, 4).numpy(),
        np.asarray(JM.align_pelvis(jnp.asarray(j), 0, 4)), atol=1e-6)
    p, t = (rng.randn(6, 300, 3).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(
        TM.vertex_error(torch.from_numpy(p), torch.from_numpy(t)).numpy(),
        np.asarray(JM.vertex_error(jnp.asarray(p), jnp.asarray(t))),
        rtol=1e-6)
    S1 = rng.randn(14, 3).astype(np.float32)
    R = np.linalg.qr(rng.randn(3, 3))[0].astype(np.float32)
    S2 = (1.3 * S1 @ R.T + 0.2 + 0.01 * rng.randn(14, 3)).astype(np.float32)
    got = TP.similarity_transform(torch.from_numpy(S1), torch.from_numpy(S2))
    want = np.asarray(JP.similarity_transform(jnp.asarray(S1),
                                              jnp.asarray(S2)))
    assert got.shape == (14, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_import_class_and_move_dict_to_device():
    """import_class resolves what JAX's does; move_dict_to_device puts
    every array on the given device as a tensor of the values JAX's puts
    there, and leaves other values alone."""
    import torch

    from tepose_tpu.utils import logging as JLOG
    from tepose_tpu_torch.utils import logging as TLOG

    for name in ("collections.OrderedDict",
                 "tepose_tpu_torch.eval.tester.Tester"):
        assert TLOG.import_class(name) is JLOG.import_class(name)
    src = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
           "b": np.array([1, 2], np.int64), "name": "x", "n": 3}
    got = TLOG.move_dict_to_device(dict(src), "cpu")
    want = JLOG.move_dict_to_device(dict(src))
    assert got.keys() == want.keys()
    for k in ("a", "b"):
        assert isinstance(got[k], torch.Tensor) and got[k].device.type == "cpu"
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        # the source dtype stays (JAX narrows int64 to its int32 default)
        assert got[k].numpy().dtype == src[k].dtype
    assert got["name"] == want["name"] == "x" and got["n"] == want["n"] == 3


def test_tester_matches_jax(rng):
    """Tester.test on a TePose module against the JAX Tester on the same
    weights (as JAX params): every metric within 1e-4 relative (mm), the
    bar of tests/test_torch_train_loop.py::test_validate_epoch_matches_jax."""
    import jax
    import jax.numpy as jnp
    import torch

    from tepose_tpu.eval.tester import Tester as JTester
    from tepose_tpu.models.smpl import synthetic_smpl_model as jax_smpl
    from tepose_tpu.models.tepose import TePoseConfig as JCfg
    from tepose_tpu_torch.data import datasets as TD
    from tepose_tpu_torch.data.loaders import stack_items
    from tepose_tpu_torch.eval.tester import Tester as TTester
    from tepose_tpu_torch.models.smpl import synthetic_smpl_model
    from tepose_tpu_torch.models.tepose import TePose, TePoseConfig
    from tepose_tpu_torch.weights import jax_tree_from_state_dict
    from tests.test_datasets import synthetic_3d_db

    S, V = 6, 48
    gen = TePose(TePoseConfig(S, 1, 16, fast_encoder=True),
                 generator=torch.Generator().manual_seed(0), device="cpu")
    db, pse = synthetic_3d_db(rng, videos=((14, "a"), (17, "b"), (20, "c")))
    ds = TD.Dataset3D("repr_wopw_3dpw_model", "val", S, 16, "3dpw", db=db,
                      psetheta=pse)
    batches = [stack_items([ds[i] for i in range(len(ds))])]
    jreg = (np.random.RandomState(7).rand(17, V) ** 8).astype(np.float32)
    jreg /= jreg.sum(1, keepdims=True)
    got = TTester(cfg=None, gen=gen, smpl=synthetic_smpl_model(0, V),
                  valid_loader=batches, j_regressor=jreg).test()
    with jax.default_matmul_precision("float32"):
        want = JTester(
            cfg=None, gen_params=jax.tree_util.tree_map(
                jnp.asarray, jax_tree_from_state_dict(gen.state_dict())),
            smpl=jax_smpl(0, V), model_cfg=JCfg(S, 1, 16, fast_encoder=True),
            valid_loader=batches, j_regressor=jreg).test()
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
