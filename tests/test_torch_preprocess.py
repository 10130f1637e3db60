"""The port's offline DB building against the JAX builders, on the CPU.

Each builder of `tepose_tpu_torch.preprocess` runs beside its
`tools/preprocess/*.py` counterpart on the same fabricated raw data and the
same weights: the port's seeded ResNet-50 and VIBE exported to JAX trees,
`synthetic_smpl_model(0, 96)` in both packages, VIBE 1 x 32. Both feature
extractors run at 64 x 64 crops and batch 8 (the JAX one pads its last
batch, the port's runs it ragged); the JAX builders share one extractor,
so its ResNet-50 compiles once. Bars: host arrays equal, pose within 1e-5,
joints3D within 1e-5 m, features within 1e-4 of their largest magnitude
(the He-init ResNet-50 gives ~1e3), pseudo-thetas within 1e-4.
"""

import inspect
import os
import os.path as osp
import random
import shutil
import sys

import jax
import numpy as np
import pytest
import torch

import tepose_tpu.data.preprocess as jax_preprocess
from tepose_tpu.data import occlusion as jax_occlusion
from tepose_tpu.data.db import load_db as jax_load_db
from tepose_tpu.models.smpl import synthetic_smpl_model as jax_smpl
from tepose_tpu.models.tepose import VibeConfig as JaxVibeConfig
from tepose_tpu_torch.data import db as port_db
from tepose_tpu_torch.data.h5 import open_h5
from tepose_tpu_torch.data import occlusion as port_occlusion
from tepose_tpu_torch.data import preprocess as port_preprocess
from tepose_tpu_torch.preprocess import (
    amass as P_amass, h36m as P_h36m, insta as P_insta, mpii3d as P_mpii3d,
    pennaction as P_penn, posetrack as P_posetrack, pseudo_theta as P_pseudo,
    threedpw as P_3dpw)
from tepose_tpu_torch.weights import jax_tree_from_state_dict

TESTS = osp.dirname(osp.abspath(__file__))
REPO = osp.dirname(TESTS)
sys.path[:0] = [TESTS, osp.join(REPO, "tools"),
                osp.join(REPO, "tools", "preprocess")]

import amass as J_amass  # noqa: E402
import h36m as J_h36m  # noqa: E402
import insta as J_insta  # noqa: E402
import make_torch_insta_golden as ig  # noqa: E402
import make_torch_preprocess_golden as pg  # noqa: E402
import mpii3d as J_mpii3d  # noqa: E402
import pennaction as J_penn  # noqa: E402
import posetrack as J_posetrack  # noqa: E402
import pseudo_theta as J_pseudo  # noqa: E402
import threedpw as J_3dpw  # noqa: E402
from test_builders import _make_insta_example, _write_posetrack  # noqa: E402
from test_torch_release import _db_case, _deep_equal  # noqa: E402

CROP, BATCH, V = 64, 8, 96
ATOL = 1e-5          # pose (rad) and joints3D (m)
FEATURE_RTOL = 1e-4  # of the features' largest magnitude
THETA_ATOL = 1e-4
SMALL_SPEC = dict(pg.FULL_SPEC, num_verts=V, vibe_n_layers=1,
                  vibe_hidden_size=32, frames=16, height=96, width=128,
                  pseudo_lengths=[13, 10, 4], vibe_batch=10)
PORT_BUILDERS = (P_3dpw, P_h36m, P_mpii3d, P_posetrack, P_penn, P_insta)


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
    """The port's modules (CPU) and their JAX trees; one JAX extractor."""
    setup = pg.port_setup(SMALL_SPEC, "cpu")
    backbone = jax_tree_from_state_dict(setup["backbone"].state_dict())
    return dict(
        port=setup, jax_backbone=backbone,
        jax_vibe=jax_tree_from_state_dict(setup["vibe"].state_dict()),
        jax_smpl=jax_smpl(SMALL_SPEC["smpl_seed"], V),
        jax_extractor=jax_preprocess.FeatureExtractor(
            backbone, batch_size=BATCH, crop_size=CROP))


@pytest.fixture
def small_crops(models, monkeypatch):
    """Both packages' builders extract 64 x 64 crops in batches of 8."""
    def jax_fe(backbone, mesh=None):
        assert backbone is models["jax_backbone"] and mesh is None
        return models["jax_extractor"]

    monkeypatch.setattr(jax_preprocess, "FeatureExtractor", jax_fe)
    for mod in PORT_BUILDERS:
        monkeypatch.setattr(
            mod, "FeatureExtractor",
            lambda backbone, mesh=None: port_preprocess.FeatureExtractor(
                backbone, batch_size=BATCH, crop_size=CROP, mesh=mesh))
    return models


def _same_db(got, want, device_keys=("pose", "joints3D")):
    """Host arrays equal; `device_keys` within ATOL; features within
    FEATURE_RTOL of their magnitude."""
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if k == "features":
            np.testing.assert_allclose(
                g, w, rtol=0, atol=FEATURE_RTOL * np.abs(w).max(), err_msg=k)
        elif k in device_keys:
            np.testing.assert_allclose(g, w, rtol=0, atol=ATOL, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


def _jpg_frames(folder, n, shape, rs, name="{:06d}.jpg"):
    import cv2

    os.makedirs(folder, exist_ok=True)
    for i in range(n):
        cv2.imwrite(osp.join(folder, name.format(i)),
                    rs.randint(0, 255, shape).astype(np.uint8))


# ------------------------------------------------------------ the writer


@pytest.mark.parametrize("case", ["db", "pseudotheta"])
def test_write_db_read_by_joblib_jax_and_port(tmp_path, case):
    """A plain pickle: joblib.load, the JAX `load_db` (joblib) and the
    port's `load_db` (`read_joblib`) give back what was written."""
    joblib = pytest.importorskip("joblib")
    rs = np.random.RandomState(3)
    obj = _db_case(rs) if case == "db" else rs.randn(9, 85).astype(
        np.float32)
    path = str(tmp_path / "x_db.pt")
    assert port_db.write_db(obj, path) == path
    assert os.listdir(tmp_path) == ["x_db.pt"]
    with open(path, "rb") as f:
        assert f.read(2) == b"\x80\x04"     # pickle protocol 4
    for read in (joblib.load, jax_load_db, port_db.load_db,
                 port_db.load_pseudotheta):
        _deep_equal(read(path), obj)


def test_save_db_names_the_file_as_the_tool(tmp_path, capsys):
    db = {"vid_name": np.array(["a", "b"]),
          "features": np.ones((2, 2048), np.float32)}
    path = port_db.save_db(db, "3dpw_test", str(tmp_path / "d"))
    assert path == str(tmp_path / "d" / "3dpw_test_db.pt")
    assert "features: (2, 2048)" in capsys.readouterr().out
    _deep_equal(port_db.load_db(path), db)


# ---------------------------------------------------------------- copies


def test_occlusion_is_a_copy():
    names = [n for n, f in inspect.getmembers(jax_occlusion,
                                              inspect.isfunction)
             if f.__module__ == jax_occlusion.__name__]
    assert len(names) == 8
    for n in names:
        assert inspect.getsource(getattr(port_occlusion, n)) == \
            inspect.getsource(getattr(jax_occlusion, n)), n
    rs = np.random.RandomState(0)
    occ = port_occlusion.synthetic_occluders(rs)
    img = rs.randint(0, 255, (96, 128, 3)).astype(np.uint8)
    np.testing.assert_array_equal(
        port_occlusion.occlude_with_objects(img, occ, random.Random(1)),
        jax_occlusion.occlude_with_objects(img, occ, random.Random(1)))


def _codec(path):
    """The TFRecord / SequenceExample codec's text: from its banner to the
    end of `_parse_example`."""
    src = open(path).read()
    end = "    return frames, kps\n"
    return src[src.index("# ---------------------------------------------"
                         "------------------------------\n# TFRecord"):
               src.index(end) + len(end)]


def test_insta_codec_is_a_byte_for_byte_copy(tmp_path):
    codec = _codec(inspect.getsourcefile(J_insta))
    assert len(codec) > 8000
    assert _codec(inspect.getsourcefile(P_insta)) == codec
    rs = np.random.RandomState(4)
    frames = [bytes(rs.randint(0, 255, 50).astype(np.uint8))
              for _ in range(3)]
    xys = rs.randn(3, 2, 25).astype(np.float32)
    vis = (rs.rand(3, 25) > 0.3).astype(np.int64)
    raw = _make_insta_example(P_insta, frames, xys, vis)
    assert raw == _make_insta_example(J_insta, frames, xys, vis)
    paths = [str(tmp_path / f"{n}.tfrecord") for n in ("port", "jax")]
    P_insta.write_tfrecord(paths[0], [raw, raw])
    J_insta.write_tfrecord(paths[1], [raw, raw])
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()
    assert list(P_insta.iter_tfrecord(paths[1])) == [raw, raw]
    f_p, k_p = P_insta._parse_example(raw)
    f_j, k_j = J_insta._parse_example(raw)
    assert f_p == f_j == frames
    np.testing.assert_array_equal(k_p, k_j)


# ------------------------------------------------------ feature extractor


def test_features_from_crops_ragged_last_batch(models):
    """19 crops at batch 8: two full batches and a ragged one of 3 (JAX
    pads it with zeros); batch 19 in one call gives the same."""
    rs = np.random.RandomState(5)
    crops = rs.randint(0, 256, (19, 3, CROP, CROP)).astype(np.uint8)
    want = models["jax_extractor"].features_from_crops(crops)
    got = {B: port_preprocess.FeatureExtractor(
        models["port"]["backbone"], batch_size=B,
        crop_size=CROP).features_from_crops(crops) for B in (8, 19)}
    bar = FEATURE_RTOL * np.abs(want).max()
    for B, g in got.items():
        assert g.shape == (19, 2048) and g.dtype == np.float32
        np.testing.assert_allclose(g, want, rtol=0, atol=bar, err_msg=B)


def test_missing_cv2_names_the_reader(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="imread"):
        port_preprocess.read_rgb("x.jpg")
    with pytest.raises(ImportError, match="decode"):
        P_insta.decode_rgb(b"\xff\xd8")


# ------------------------------------------------------------------ 3DPW


def _jax_3dpw(models, folder, split, occluders=None):
    with jax.default_matmul_precision("float32"):
        return J_3dpw.read_data(folder, split, occluders=occluders,
                                backbone=models["jax_backbone"],
                                smpl=models["jax_smpl"],
                                j_regressor=models["port"]["jreg"])


@pytest.mark.parametrize("split,occ,reader", [
    ("test", False, "memory"), ("train", False, "cv2"),
    ("validation", True, "memory")])
def test_threedpw_matches_jax(small_crops, tmp_path, split, occ, reader):
    """Rc @ R alignment, SMPL over each track, J14 (test/val) or joints49
    (train), smooth bboxes, the keypoint permutation, the detected interval
    and the MIN_KP filter (fabricate_3dpw's tracks start late, end early
    and hold a frame with five keypoints); `--occ` with synthetic
    occluders from one `random` seed on both sides; frames read by the
    port from memory or, like JAX, by cv2 from the files."""
    folder, frames = pg.fabricate_3dpw(str(tmp_path), SMALL_SPEC)
    if split != "test":
        os.rename(osp.join(folder, "sequenceFiles", "test"),
                  osp.join(folder, "sequenceFiles", split))
    pg.write_frame_files(frames)
    occluders = (port_occlusion.synthetic_occluders(
        np.random.RandomState(6)) if occ else None)
    random.seed(7)
    want = _jax_3dpw(small_crops, folder, split, occluders)
    random.seed(7)
    setup = small_crops["port"]
    got = P_3dpw.read_data(
        folder, split, occluders=occluders, backbone=setup["backbone"],
        smpl=setup["smpl"], j_regressor=setup["jreg"], device="cpu",
        imread=frames.__getitem__ if reader == "memory" else None)
    n = len(want["vid_name"])
    assert n == 2 * SMALL_SPEC["frames"] - 5   # 3 late, 1 early, 1 MIN_KP
    assert want["joints3D"].shape == (n, 14 if split != "train" else 49, 3)
    _same_db(got, want)


def test_pseudo_thetas_match_jax(models):
    """Videos of 13, 10 and 4 frames at batch 10: a full chunk and a tail
    (the tail re-reads the last 10 frames and keeps 3), an exact chunk, and
    a video shorter than a chunk."""
    vid, feats = pg.pseudo_inputs(SMALL_SPEC)
    setup = models["port"]
    got = P_pseudo.pseudo_thetas_for_features(
        vid, feats, setup["vibe"], setup["smpl"], SMALL_SPEC["vibe_batch"])
    vcfg = JaxVibeConfig(seqlen=16, n_layers=1, hidden_size=32,
                         add_linear=True)
    with jax.default_matmul_precision("float32"):
        want = J_pseudo.pseudo_thetas_for_features(
            vid, feats, models["jax_vibe"], models["jax_smpl"], vcfg,
            SMALL_SPEC["vibe_batch"])
    assert got.shape == want.shape == (27, 85) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=THETA_ATOL)
    # the tail of video 0 is frames 10-12 of VIBE over frames 3-12
    tail = P_pseudo.pseudo_thetas_for_features(
        vid[3:13], feats[3:13], setup["vibe"], setup["smpl"], 10)
    np.testing.assert_array_equal(got[10:13], tail[7:])


@pytest.mark.parametrize("db", ["joblib", "insta_h5"])
def test_pseudo_theta_cli_writes_what_jax_reads(models, tmp_path,
                                                monkeypatch, db):
    """`main` reads a DB written by `save_db` (or, as `--file_name
    insta_train`, an InstaVariety h5 written by h5py with the builder's
    settings) and writes the pseudo-thetas with `write_db`, on the CPU
    (--gpu cpu), with joblib and h5py blocked; joblib reads the file
    back."""
    joblib = pytest.importorskip("joblib")
    vid, feats = pg.pseudo_inputs(SMALL_SPEC)
    d = str(tmp_path)
    name = "x_test" if db == "joblib" else "insta_train"
    if db == "joblib":
        port_db.save_db({"vid_name": vid, "features": feats}, name, d)
    else:
        h5py = pytest.importorskip("h5py")
        with h5py.File(osp.join(d, "insta_train_db.h5"), "w") as f:
            for k, v in (("vid_name", vid.astype(bytes)),
                         ("features", feats)):
                f.create_dataset(k, data=v, maxshape=(None,) + v.shape[1:],
                                 chunks=True)
    setup = models["port"]
    monkeypatch.setattr(P_pseudo, "load_vibe",
                        lambda path, device: setup["vibe"])
    monkeypatch.setattr(P_pseudo, "load_smpl",
                        lambda device: setup["smpl"])
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "joblib", None)
        m.setitem(sys.modules, "h5py", None)
        P_pseudo.main(["--file_name", name, "--db_dir", d,
                       "--vibe_batch_size", "10", "--gpu", "cpu"])
    got = joblib.load(osp.join(d, f"{name}_pseudotheta.pt"))
    want = P_pseudo.pseudo_thetas_for_features(vid, feats, setup["vibe"],
                                               setup["smpl"], 10)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------- the other builders


def test_h36m_matches_jax(small_crops, tmp_path):
    import json

    rs = np.random.RandomState(8)
    root = tmp_path / "h36m"
    (root / "annotations").mkdir(parents=True)
    n = 12
    _jpg_frames(str(root / "images" / "s_01_act_02_subact_01_ca_01"), n,
                (100, 120, 3), rs, "img_{:06d}.jpg")
    cameras = {"1": {"R": np.eye(3).tolist(), "t": [0, 0, 4000],
                     "f": [1000, 1000], "c": [60, 50]}}
    joints = {"2": {"1": {str(i): (rs.randn(17, 3) * 200).tolist()
                          for i in range(n)}}}
    for name, obj in (("camera", cameras), ("joint_3d", joints)):
        with open(root / "annotations" / f"Human36M_subject1_{name}.json",
                  "w") as f:
            json.dump(obj, f)
    for variant in ("tight", "occ"):
        want = J_h36m.read_data(str(root), "train", variant,
                                backbone=small_crops["jax_backbone"])
        got = P_h36m.read_data(str(root), "train", variant,
                               backbone=small_crops["port"]["backbone"],
                               device="cpu")
        assert len(want["vid_name"]) == n // 2
        _same_db(got, want, device_keys=())


@pytest.mark.parametrize("annot", ["h5py", "matlab"])
def test_mpii3d_matches_jax(small_crops, tmp_path, monkeypatch, annot):
    """Train: annot.mat cells, one video split into two segments by an
    out-of-view frame, one too short to keep; test: annot_data.mat (HDF5)
    with `valid_i`, written here by h5py or the committed MATLAB v7.3-style
    file (`tools/make_torch_insta_golden.py::MPII3D_ANNOT`: a 512-byte
    MATLAB header, deflate-chunked); the port reads it with h5py
    blocked."""
    import h5py
    import scipy.io as sio

    rs = np.random.RandomState(9)
    seq = tmp_path / "mpii3d" / "S1" / "Seq1"
    annot2 = np.empty((9, 1), object)
    annot3 = np.empty((9, 1), object)
    for vid_i, T in enumerate((20, 6, 0, 0, 0, 0, 0, 0, 0)):
        xy = np.stack([60 + rs.randn(T, 28) * 15,
                       50 + rs.randn(T, 28) * 15], -1)
        if vid_i == 0:
            xy[9, 3, 0] = -5.0            # out of view: a new segment
        annot2[vid_i, 0] = xy.reshape(T, 56)
        annot3[vid_i, 0] = (rs.randn(T, 84) * 300).reshape(T, 84)
        if T:
            _jpg_frames(str(seq / f"video_{vid_i}"), T, (100, 120, 3), rs)
    sio.savemat(str(seq / "annot.mat"), {"annot2": annot2, "annot3": annot3})
    ts = tmp_path / "mpii3d" / "mpi_inf_3dhp_test_set" / "TS1"
    T = 9 if annot == "h5py" else ig.SPEC["mpii3d_frames"]
    _jpg_frames(str(ts / "imageSequence"), T, (100, 120, 3), rs,
                "img_{:06d}.jpg")
    os.rename(ts / "imageSequence" / "img_000000.jpg",
              ts / "imageSequence" / f"img_{T:06d}.jpg")
    a2 = np.stack([60 + rs.randn(T, 1, 17) * 15,
                   50 + rs.randn(T, 1, 17) * 15], -1)
    if annot == "h5py":
        with h5py.File(ts / "annot_data.mat", "w") as m:
            m["annot2"] = a2
            m["univ_annot3"] = rs.randn(T, 1, 17, 3) * 300
            m["valid_frame"] = (rs.rand(T) > 0.3).astype(np.float64)
    else:
        shutil.copyfile(ig.MPII3D_ANNOT, ts / "annot_data.mat")
    root = str(tmp_path / "mpii3d")
    readers = [(J_mpii3d.read_test_data, P_mpii3d.read_test_data, T)]
    if annot == "h5py":     # the train reader does not read annot_data
        readers.insert(0, (J_mpii3d.read_train_data,
                           P_mpii3d.read_train_data, 19))
    for jax_fn, port_fn, n in readers:
        want = jax_fn(root, backbone=small_crops["jax_backbone"])
        with monkeypatch.context() as m:
            m.setitem(sys.modules, "h5py", None)
            got = port_fn(root, backbone=small_crops["port"]["backbone"],
                          device="cpu")
        assert len(want["vid_name"]) == n
        _same_db(got, want, device_keys=())


def test_posetrack_matches_jax(small_crops, tmp_path):
    root = _write_posetrack(tmp_path, np.random.RandomState(10))
    want = J_posetrack.read_data(root, "train",
                                 backbone=small_crops["jax_backbone"])
    got = P_posetrack.read_data(root, "train",
                                backbone=small_crops["port"]["backbone"],
                                device="cpu")
    assert len(want["vid_name"]) == 12
    _same_db(got, want, device_keys=())


def test_pennaction_matches_jax(small_crops, tmp_path):
    import scipy.io as sio

    rs = np.random.RandomState(11)
    root = tmp_path / "penn"
    (root / "labels").mkdir(parents=True)
    n = 10
    _jpg_frames(str(root / "frames" / "0001"), n - 1, (90, 110, 3), rs)
    sio.savemat(str(root / "labels" / "0001.mat"), {
        "nframes": n, "x": 50 + rs.randn(n, 13) * 12,
        "y": 45 + rs.randn(n, 13) * 12,
        "visibility": (rs.rand(n, 13) > 0.2).astype(np.float64)})
    want = J_penn.read_data(str(root), backbone=small_crops["jax_backbone"])
    got = P_penn.read_data(str(root), backbone=small_crops["port"]["backbone"],
                           device="cpu")
    assert len(want["vid_name"]) == n - 1   # fewer images than labels
    _same_db(got, want, device_keys=())


def test_amass_matches_jax(tmp_path):
    rs = np.random.RandomState(12)
    for subj in ("s1", "s2"):
        d = tmp_path / "CMU" / subj
        d.mkdir(parents=True)
        np.savez(d / "walk.npz", poses=rs.randn(70, 156),
                 betas=rs.randn(16))
        np.savez(d / "short.npz", poses=rs.randn(20, 156),
                 betas=rs.randn(16))
        np.savez(d / "shape.npz", betas=rs.randn(16))
    want = J_amass.read_data(str(tmp_path), sequences=["CMU", "KIT"])
    got = P_amass.read_data(str(tmp_path), sequences=["CMU", "KIT"])
    assert want["theta"].shape == (140, 82)
    _same_db(got, want)


@pytest.mark.parametrize("reader", ["h5py", "port"])
def test_insta_matches_jax(small_crops, tmp_path, monkeypatch, reader):
    """Two shards: a kept video and one with too few frames; the port's
    builder writes its HDF5 with h5py blocked (`data.h5.H5Writer`); its
    datasets, read by h5py or by `data.h5.open_h5` (h5py blocked), equal
    those of the JAX builder's file."""
    import cv2
    import h5py

    rs = np.random.RandomState(13)
    rec_dir = tmp_path / "insta" / "train"
    rec_dir.mkdir(parents=True)
    for shard, T in enumerate((10, 6)):
        frames = [cv2.imencode(".jpg", rs.randint(0, 255, (80, 100, 3)).astype(
            np.uint8))[1].tobytes() for _ in range(T)]
        xys = np.stack([50 + rs.randn(T, 25) * 8,
                        40 + rs.randn(T, 25) * 12], 1).astype(np.float32)
        vis = (rs.rand(T, 25) > 0.1).astype(np.int64)
        J_insta.write_tfrecord(str(rec_dir / f"s{shard}.tfrecord"),
                               [_make_insta_example(J_insta, frames, xys,
                                                    vis)])
    paths = [str(tmp_path / f"{n}.h5") for n in ("jax", "port")]
    J_insta.read_data(str(tmp_path / "insta"), paths[0],
                      backbone=small_crops["jax_backbone"])
    with h5py.File(paths[0], "r") as w:
        want = {k: w[k][:] for k in w}
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "h5py", None)
        P_insta.read_data(str(tmp_path / "insta"), paths[1],
                          backbone=small_crops["port"]["backbone"],
                          device="cpu")
        if reader == "port":
            with open_h5(paths[1]) as g:
                got = {k: g[k][:] for k in g}
    if reader == "h5py":
        with h5py.File(paths[1], "r") as g:
            got = {k: g[k][:] for k in g}
    assert want["vid_name"].shape == (10,)
    assert sorted(os.listdir(tmp_path)) == ["insta", "jax.h5", "port.h5"]
    _same_db(got, want, device_keys=())


# ------------------------------------------------------------- the golden


def test_committed_golden_matches_port_on_cpu(tmp_path):
    """The golden phase 11 of chip_smoke.py holds the card to (full width:
    ResNet-50 at 224 x 224, SMPL with 6890 vertices, VIBE 2 x 1024 at batch
    450), reproduced by the port on the CPU within the card's bars; its
    spec, shapes and the weights' checksums."""
    assert os.path.getsize(pg.GOLDEN_PATH) < 1 << 20
    golden = pg.load_golden()
    assert golden["spec"] == pg.FULL_SPEC
    n = len(golden["vid_name"])
    assert n == 2 * pg.FULL_SPEC["frames"] - 5
    assert golden["features"].shape == (n, 2048)
    assert golden["joints3D"].shape == (n, 14, 3)
    assert golden["pseudo_theta"].shape == (
        sum(pg.FULL_SPEC["pseudo_lengths"]), 85)
    setup = pg.port_setup(pg.FULL_SPEC, "cpu")
    np.testing.assert_allclose(pg.weight_checksums(setup),
                               golden["weight_checksums"], rtol=1e-9, atol=0)
    folder, frames = pg.fabricate_3dpw(str(tmp_path), pg.FULL_SPEC)
    dev = pg.golden_deviation(pg.port_outputs(setup, folder, frames), golden)
    for k, (d, bar) in dev.items():
        assert d <= bar, (k, d, bar)
