"""Port parity of the training loop around the step: checkpoints that cross
between the packages, the copied host helpers (chunking, transforms,
datasets, loaders, db paths, logging, NaNGuard, the synthetic DB makers),
trainer validation against JAX, validation reading post-step weights, and
`run_train` end to end on the CPU at tiny width with a resume.

Small widths on the CPU in float32 (TePose 1 x 16 GRUs, the discriminator
at 2 / 2 scales, 48 vertices). Tolerances are stated in each test.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import train as jax_train
from tepose_tpu.config import get_cfg_defaults as jax_cfg_defaults
from tepose_tpu.data import chunking as JCH
from tepose_tpu.data import datasets as JD
from tepose_tpu.data import db as JDB
from tepose_tpu.data import loaders as JLD
from tepose_tpu.data import transforms as JTR
from tepose_tpu.models.smpl import synthetic_smpl_model as jax_smpl
from tepose_tpu.models.tepose import TePoseConfig as JCfg
from tepose_tpu.train import checkpoint as JCK
from tepose_tpu.train import fit as JFIT
from tepose_tpu.train import optim as JO
from tepose_tpu.train import validate as JV
from tepose_tpu.utils import logging as JLOG
from tepose_tpu.utils import profiling as JPROF
from tepose_tpu_torch import config as TCFG
from tepose_tpu_torch.data import chunking as TCH
from tepose_tpu_torch.data import datasets as TD
from tepose_tpu_torch.data import db as TDB
from tepose_tpu_torch.data import loaders as TLD
from tepose_tpu_torch.data import synthetic as TSYN
from tepose_tpu_torch.data import transforms as TTR
from tepose_tpu_torch.models.gcn import MotionDiscriminator
from tepose_tpu_torch.models.smpl import synthetic_smpl_model
from tepose_tpu_torch.models.tepose import TePose, TePoseConfig
from tepose_tpu_torch.train import checkpoint as TCK
from tepose_tpu_torch.train import optim as TO
from tepose_tpu_torch.train import run as TRUN
from tepose_tpu_torch.train import validate as TV
from tepose_tpu_torch.utils import logging as TLOG
from tepose_tpu_torch.utils import profiling as TPROF
from tepose_tpu_torch.weights import (
    disc_jax_trees_from_state_dict, flatten_tree, jax_tree_from_state_dict)

from test_datasets import synthetic_2d_db, synthetic_3d_db  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import make_torch_train_golden as golden_writer  # noqa: E402

S = 6


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs six workers on this host's
    cores, and these tests' small ops gain nothing from more."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _models(seed=0):
    gen = TePose(TePoseConfig(S, 1, 16, fast_encoder=True),
                 generator=torch.Generator().manual_seed(seed), device="cpu")
    disc = MotionDiscriminator(generator=torch.Generator().manual_seed(seed),
                               device="cpu", num_gcn_scales=2,
                               num_g3d_scales=2)
    return gen, disc


def _eq_trees(a, b, **tol):
    fa, fb = flatten_tree(a), flatten_tree(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        np.testing.assert_allclose(np.asarray(fa[k]), np.asarray(fb[k]),
                                   err_msg=k, **tol)


def _random_grads(module, rs):
    for p in module.parameters():
        p.grad = torch.from_numpy(rs.randn(*p.shape).astype(np.float32))


# ------------------------------------------------------------- checkpoints


def test_port_checkpoint_loads_and_resumes_in_jax(tmp_path):
    """A port checkpoint after two Adam steps (weight decay on) reads back
    through JAX's `load_checkpoint` as equal trees; its optimizer leaves
    rebuild optax states (`fit._tree_to_opt`) whose next update, with the
    same gradients, moves the parameters as the port's next step (1e-6)."""
    rs = np.random.RandomState(0)
    gen, disc = _models()
    opts = {"gen": TO.make_optimizer("adam", gen, 1e-3, 1e-4),
            "disc": TO.make_optimizer("sgd", disc, 1e-2, 1e-4)}
    for _ in range(2):
        for name, m in (("gen", gen), ("disc", disc)):
            _random_grads(m, rs)
            TO.take_step(opts[name])
    trees = TCK.training_trees(gen, disc, opts["gen"], opts["disc"])
    path = str(tmp_path / "checkpoint.npz")
    TCK.save_checkpoint(path, trees, {"epoch": 3, "performance": 1.5})
    jtrees, scalars = JCK.load_checkpoint(path)
    assert scalars == {"epoch": 3, "performance": 1.5}
    for k in ("gen", "disc", "disc_state"):
        _eq_trees(jtrees[k], trees[k], rtol=0, atol=0)

    for name, m, tx in (("gen", gen, JO.make_optimizer("adam", 1e-3, 1e-4)),
                        ("disc", disc, JO.make_optimizer("sgd", 1e-2, 1e-4))):
        params = jax.tree_util.tree_map(jnp.asarray, jtrees[name])
        state = JFIT._tree_to_opt(jtrees[f"{name}_opt"], tx.init(params))
        _random_grads(m, rs)
        g = jax_tree_from_state_dict(
            {n: p.grad for n, p in m.named_parameters()})
        upd, _ = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state,
                           params)
        want = optax.apply_updates(params, upd)
        TO.take_step(opts[name])
        got = jax_tree_from_state_dict(
            {n: p for n, p in m.named_parameters()})
        _eq_trees(got, jax.device_get(want), rtol=0, atol=1e-6)


def test_jax_checkpoint_resumes_in_port(tmp_path):
    """A JAX checkpoint (params after two optax Adam updates, saved by
    `fit.TrainLoop.save`'s layout) loads into fresh port modules: equal
    parameters and optimizer leaves in optax order, and the next step with
    equal gradients gives equal parameters (1e-6)."""
    rs = np.random.RandomState(1)
    gen0, disc0 = _models(seed=3)
    gp = jax.tree_util.tree_map(jnp.asarray,
                                jax_tree_from_state_dict(gen0.state_dict()))
    dp, ds = disc_jax_trees_from_state_dict(disc0.state_dict())
    dp = jax.tree_util.tree_map(jnp.asarray, dp)
    gtx = JO.make_optimizer("adam", 1e-3, 1e-4)
    dtx = JO.make_optimizer("adam", 1e-4, 1e-4)

    def two_updates(tx, params):
        state = tx.init(params)
        for _ in range(2):
            grads = jax.tree_util.tree_map(
                lambda x: jnp.asarray(rs.randn(*x.shape), jnp.float32),
                params)
            upd, state = tx.update(grads, state, params)
            params = optax.apply_updates(params, upd)
        return params, state

    gp, go = two_updates(gtx, gp)
    dp, do = two_updates(dtx, dp)
    path = str(tmp_path / "jax.npz")
    JCK.save_checkpoint(path, {"gen": gp, "disc": dp, "disc_state": ds,
                               "gen_opt": JFIT._opt_to_tree(go),
                               "disc_opt": JFIT._opt_to_tree(do)})
    gen, disc = _models(seed=9)
    gopt = TO.make_optimizer("adam", gen, 5.0, 0.0)
    dopt = TO.make_optimizer("adam", disc, 5.0, 0.0)
    trees, _ = TCK.load_checkpoint(path)
    TCK.load_training_trees(trees, gen, disc, gopt, dopt)
    _eq_trees(jax_tree_from_state_dict(gen.state_dict()),
              jax.device_get(gp), rtol=0, atol=0)
    for opt, st in ((gopt, go), (dopt, do)):
        leaves = jax.tree_util.tree_leaves(st)
        mine = TO.opt_state_leaves(opt)
        assert len(mine) == len(leaves)
        for a, b in zip(mine, leaves):
            np.testing.assert_array_equal(a, np.asarray(b))
    assert TO.get_lr(gopt) == pytest.approx(1e-3)
    _random_grads(gen, rs)
    g = jax_tree_from_state_dict({n: p.grad for n, p in gen.named_parameters()})
    upd, _ = gtx.update(jax.tree_util.tree_map(jnp.asarray, g), go, gp)
    want = optax.apply_updates(gp, upd)
    TO.take_step(gopt)
    _eq_trees(jax_tree_from_state_dict(dict(gen.named_parameters())),
              jax.device_get(want), rtol=0, atol=1e-6)


# ------------------------------------------------------------- copies


def test_chunking_and_transforms_copies_match(rng):
    names = np.array(sum(([f"v{i}"] * n for i, n in
                          enumerate([3, 9, 14, 6, 30, 7, 12])), []))
    for fn, args in ((TCH.split_into_videos, (S, 1, 16)),
                     (TCH.split_into_videos_val, (S, 1)),
                     (TCH.combine_into_chunks, (S, 20)),
                     (TCH.split_into_chunks, (S, S)),
                     (TCH.split_into_chunks, (S, 2, True, True)),
                     (TCH.split_into_chunks, (16, 3, False, True))):
        assert fn(names, *args) == getattr(JCH, fn.__name__)(names, *args)
    for lengths in ([8, 6, 8], [20], [7, 9, 11, 6]):
        a, b = TCH.pack_clip_channels(lengths, S, 30), \
            JCH.pack_clip_channels(lengths, S, 30)
        assert a[0] == b[0] and a[2] == b[2]
        np.testing.assert_array_equal(a[1], b[1])
    kp = rng.rand(4, 49, 2).astype(np.float32) * 224
    bbox = np.abs(rng.randn(4, 4)).astype(np.float32) * 100 + 20
    np.testing.assert_array_equal(TTR.transform_keypoints(kp, bbox),
                                  JTR.transform_keypoints(kp, bbox))
    np.testing.assert_array_equal(
        TTR.patch_affine(1.0, 2.0, 30.0, 40.0, rot=17.0),
        JTR.patch_affine(1.0, 2.0, 30.0, 40.0, rot=17.0))
    for inv in (False, True):
        np.testing.assert_array_equal(TTR.normalize_2d_kp(kp, inv=inv),
                                      JTR.normalize_2d_kp(kp, inv=inv))


def _eq_items(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _insta_h5(path, rng, clips=((14, 0), (9, 1), (30, 2), (6, 3))):
    """An InstaVariety DB as the builder writes it through h5py (one
    append a video into resizable chunked datasets: 25 insta joints,
    bboxes, float32 features), and its pseudo-theta sidecar."""
    h5py = pytest.importorskip("h5py")
    dsets = {}
    with h5py.File(path, "w") as f:
        for n, v in clips:
            rows = {"vid_name": np.array([f"insta_0000_{v:04d}".encode()] * n),
                    "frame_id": np.arange(n),
                    "joints2D": np.concatenate(
                        [rng.uniform(0, 224, (n, 25, 2)),
                         rng.rand(n, 25, 1) > 0.2], -1).astype(np.float32),
                    "bbox": np.concatenate(
                        [rng.uniform(80, 140, (n, 2)),
                         rng.uniform(60, 160, (n, 1)).repeat(2, 1)],
                        -1).astype(np.float32),
                    "features": rng.randn(n, 2048).astype(np.float32)}
            for k, a in rows.items():
                if k not in dsets:
                    dsets[k] = f.create_dataset(
                        k, data=a, maxshape=(None,) + a.shape[1:],
                        chunks=True)
                else:
                    d = dsets[k]
                    d.resize(d.shape[0] + n, axis=0)
                    d[-n:] = a
    total = sum(n for n, _ in clips)
    TDB.write_db(rng.randn(total, 85).astype(np.float32) * 0.2,
                 path[:-len("_db.h5")] + "_pseudotheta.pt")


@pytest.mark.parametrize("source", ["db", "insta_h5"])
def test_dataset_copies_match(rng, source, tmp_path, monkeypatch):
    """Every dataset copy against its JAX original on the same DB; with
    `insta_h5`, `Insta` reading an h5py-written InstaVariety file and its
    pseudo-theta sidecar with h5py and joblib blocked, against the JAX
    `Insta` reading them through h5py and joblib."""
    if source == "insta_h5":
        path = str(tmp_path / "insta_train_db.h5")
        _insta_h5(path, rng)
        b = JD.Insta("x", S, 20, h5_path=path)
        with monkeypatch.context() as m:
            for name in ("h5py", "joblib"):
                m.setitem(sys.modules, name, None)
            a = TD.Insta("x", S, 20, h5_path=path)
            assert type(a.db["features"]).__module__ == \
                "tepose_tpu_torch.data.h5"
            assert len(a) == len(b) == 3
            for i in range(len(a)):
                _eq_items(a[i], b[i])
        return
    db3, pse3 = synthetic_3d_db(rng)
    db3["valid_i"] = (rng.rand(len(db3["vid_name"]), 1) > 0.2).astype(
        np.float32)
    db2, pse2 = synthetic_2d_db(rng, clips=((8, "x"), (6, "y"), (8, "z"),
                                            (12, "w")))
    for name in ("3dpw", "mpii3d", "h36m"):
        for split in ("train", "val"):
            for title in ("repr_wopw_3dpw_model", "repr_wpw_3dpw_model"):
                a = TD.Dataset3D(title, split, S, 16, name, db=db3,
                                 psetheta=pse3)
                b = JD.Dataset3D(title, split, S, 16, name, db=db3,
                                 psetheta=pse3)
                assert len(a) == len(b)
                for i in range(len(a)):
                    _eq_items(a[i], b[i])
    for name in ("posetrack", "pennaction"):
        a = TD.Dataset2D("x", S, 20, name, db=db2, psetheta=pse2)
        b = JD.Dataset2D("x", S, 20, name, db=db2, psetheta=pse2)
        assert len(a) == len(b)
        for i in range(len(a)):
            _eq_items(a[i], b[i])
    amass = {"vid_name": np.array(["m0"] * 25 + ["m1"] * 15),
             "theta": rng.randn(40, 82).astype(np.float32)}
    a, b = TD.AMASS(S, db=amass), JD.AMASS(S, db=amass)
    assert len(a) == len(b)
    _eq_items(a[2], b[2])
    for title in ("repr_wpw_3dpw_model", "repr_wopw_h36m_model", "other"):
        for name in ("3dpw", "mpii3d", "h36m", "posetrack"):
            for split in ("train", "val"):
                assert TDB.train_db_paths(title, name, split) == \
                    JDB.train_db_paths(title, name, split)


def _tiny_cfg(cfg, tmp_path=None):
    cfg.TITLE = "repr_wopw_3dpw_model"
    cfg.DEBUG = False
    cfg.DATASET.SEQLEN = S
    cfg.DATASET.VIDLEN = 12
    cfg.TRAIN.BATCH_SIZE = 5
    cfg.TRAIN.DATA_2D_RATIO = 0.6
    cfg.TRAIN.DATASETS_2D = ["Insta", "PoseTrack"]
    cfg.TRAIN.DATASETS_3D = ["MPII3D", "Human36M"]
    cfg.TRAIN.DATASET_EVAL = "ThreeDPW"
    if tmp_path is not None:
        cfg.OUTPUT_DIR = str(tmp_path)
    return cfg


def test_loaders_and_synthetic_dbs_match(rng):
    """The synthetic DB makers and `get_data_loaders` over them give the
    JAX package's batches, item for item (same seeds)."""
    for a, b in ((TSYN.synthetic_3d_db(np.random.RandomState(4)),
                  synthetic_3d_db(np.random.RandomState(4))),
                 (TSYN.synthetic_2d_db(np.random.RandomState(4)),
                  synthetic_2d_db(np.random.RandomState(4)))):
        _eq_items(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    tl = TSYN.synthetic_loaders(_tiny_cfg(TCFG.get_cfg_defaults()))
    jl = jax_train.synthetic_loaders(_tiny_cfg(jax_cfg_defaults()))
    try:
        for a, b in zip(tl, jl):
            assert len(a) == len(b)
            ia, ib = iter(a), iter(b)
            for _ in range(2):
                _eq_items(next(ia), next(ib))
    finally:
        for ld in tl + jl:
            ld.close()

    class Boom:
        def __len__(self):
            return 8

        def __getitem__(self, i):
            raise IndexError("malformed DB row")

    loader = TLD.BatchLoader(Boom(), batch_size=2, seed=0)
    with pytest.raises(RuntimeError, match="producer"):
        next(iter(loader))
    loader.close()
    items = [{"a": np.full(2, i)} for i in range(3)]
    _eq_items(TLD.stack_items(items), JLD.stack_items(items))


def test_train_loop_reads_insta_h5_from_db_dir(rng, tmp_path, monkeypatch):
    """`build_train_loop` without --synthetic (`db_dir=`, `db_overrides=`,
    the synthetic SMPL through `smoke_verts`, no SMPL assets) reads
    InstaVariety's h5 DB and its pseudo-theta sidecar from `db_dir` with
    h5py and joblib blocked, the other datasets through `db_overrides`: a
    2D batch's rows are `Insta` items over the file's lazy features, and
    a segment of 2 windows gives finite losses."""
    from tepose_tpu_torch.data.h5 import H5Dataset

    _insta_h5(str(tmp_path / "insta_train_db.h5"), rng)
    cfg = _tiny_cfg(TCFG.update_cfg(os.path.join(
        REPO, "configs", "repr_wopw_3dpw_model.yaml")), tmp_path / "out")
    cfg.MODEL.TGRU.NUM_LAYERS = 1
    cfg.MODEL.TGRU.HIDDEN_SIZE = 16
    cfg.TRAIN.MOT_DISCR.GCN.num_gcn_scales = 2
    cfg.TRAIN.MOT_DISCR.GCN.num_g3d_scales = 2
    cfg.TRAIN.PRETRAINED_REGRESSOR = ""
    cfg.TRAIN.DATASETS_2D = ["Insta"]
    db3, pse3 = TSYN.synthetic_3d_db(np.random.RandomState(4))
    amass = {"vid_name": np.array(["m"] * 60),
             "theta": rng.randn(60, 82).astype(np.float32)}
    over = {"mpii3d": (db3, pse3), "human36m": (db3, pse3),
            "threedpw": (db3, pse3), "amass": (amass, None)}
    with monkeypatch.context() as m:
        for name in ("h5py", "joblib"):
            m.setitem(sys.modules, name, None)
        loop, _ = TRUN.build_train_loop(
            cfg, smoke_iters=2, smoke_verts=48, device="cpu",
            db_dir=str(tmp_path), db_overrides=over)
        try:
            ds = loop.train_2d.dataset.parts[0]
            assert isinstance(ds, TD.Insta)
            assert isinstance(ds.db["features"], H5Dataset)
            batch = next(iter(loop.train_2d))
            metrics = loop.train_epoch(0, 1)
        finally:
            TRUN.close_loaders(loop)
    items = [ds[i]["features"] for i in range(len(ds))]
    assert batch["features"].shape == (3, 2, 12, 2048)
    for row in batch["features"]:
        assert any(np.array_equal(row, it) for it in items)
    assert loop.smpl.num_verts == 48
    assert all(np.isfinite(v) for v in metrics.values())


def test_logging_and_nan_guard_copies_match(tmp_path):
    for mod, sub in ((TLOG, "port"), (JLOG, "jax")):
        cfg = TCFG.get_cfg_defaults()
        cfg.OUTPUT_DIR = str(tmp_path / sub)
        logdir = mod.prepare_output_dir(cfg)
        assert cfg.LOGDIR == logdir
        w = mod.MetricWriter(logdir)
        w.add_scalars({"a": 1.5, "b": 2}, 3, prefix="x/")
        w.close()
        meter = mod.AverageMeter()
        for v, n in ((1.0, 1), (4.0, 3)):
            meter.update(v, n)
        lines = [json.loads(s) for s in
                 open(os.path.join(logdir, "metrics.jsonl"))]
        with open(os.path.join(logdir, "config.yaml")) as f:
            snap = f.read().replace(logdir, "<logdir>").replace(
                cfg.OUTPUT_DIR, "<out>")
        res = (meter.avg, meter.count, snap,
               [{k: v for k, v in d.items() if k != "time"} for d in lines])
        if sub == "port":
            port_res = res
        logger = mod.create_logger(logdir)
        logger.info("hello")
        assert os.path.isfile(os.path.join(logdir, "train_log.txt"))
    assert port_res == res
    guards = (TPROF.NaNGuard(2), JPROF.NaNGuard(2))
    for i, v in enumerate([1.0, float("nan"), 2.0, float("nan"),
                           float("inf"), float("nan")]):
        a, b = (g.check(v, i) for g in guards)
        assert a == b
        assert vars(guards[0]) == vars(guards[1])
        assert guards[0].should_rollback == guards[1].should_rollback


# ------------------------------------------------------------- validation


def _valid_batches(rng, n_videos=3):
    db3, pse3 = synthetic_3d_db(
        rng, videos=tuple((14 + 3 * i, f"v{i}") for i in range(n_videos)))
    ds = TD.Dataset3D("repr_wopw_3dpw_model", "val", S, 16, "3dpw",
                      db=db3, psetheta=pse3)
    return [TLD.stack_items([ds[i] for i in range(len(ds))])]


def test_validate_epoch_matches_jax(rng):
    """Trainer validation on shared weights: every metric within 1e-4
    relative (mm) of JAX `validate_epoch`."""
    V = 48
    gen, _ = _models()
    batches = _valid_batches(rng)
    jreg = (np.random.RandomState(7).rand(17, V) ** 8).astype(np.float32)
    jreg /= jreg.sum(1, keepdims=True)
    got = TV.validate_epoch(gen, synthetic_smpl_model(0, V), batches, jreg, S)
    with jax.default_matmul_precision("float32"):
        want = JV.validate_epoch(
            jax.tree_util.tree_map(jnp.asarray, jax_tree_from_state_dict(
                gen.state_dict())), jax_smpl(0, V),
            JCfg(S, 1, 16, fast_encoder=True), batches, jreg, S)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


def test_validation_reads_post_step_weights(rng):
    """The eval pack of the fast encoder is cached: after a training
    segment, validation must see the stepped weights, equal to a fresh
    model loaded with them, and differ from before the step."""
    spec = dict(golden_writer.FULL_SPEC, n_layers=1, hidden_size=16,
                num_verts=48, n_2d=3, n_3d=4, num_gcn_scales=2,
                num_g3d_scales=2)
    setup = golden_writer.port_setup(spec, "cpu")
    gen, smpl = setup["gen"], setup["smpl"]
    batches = _valid_batches(rng, n_videos=2)
    b = batches[0]
    args = [torch.from_numpy(np.asarray(x, np.float32)) for x in
            (b["features"], b["theta_pseu"][:, :S - 1], b["theta"])]
    jreg = torch.from_numpy(np.full((17, 48), 1 / 48, np.float32))
    W = args[0].shape[1] - S + 1
    gen.eval()
    before = TV.validate_scan(gen, smpl, *args, jreg, W)["pred_j3d"]
    golden_writer.port_segment(setup, 1)
    gen.eval()
    after = TV.validate_scan(gen, smpl, *args, jreg, W)["pred_j3d"]
    fresh = TePose(gen.cfg, generator=torch.Generator().manual_seed(5),
                   device="cpu")
    fresh.load_state_dict(gen.state_dict())
    want = TV.validate_scan(fresh.eval(), smpl, *args, jreg, W)["pred_j3d"]
    assert torch.equal(after, want)
    assert not torch.allclose(before, after)


# ------------------------------------------------------------- run_train


def test_run_train_cpu_epoch_checkpoint_and_resume(tmp_path):
    """One epoch at tiny width on the CPU through the entry point: finite
    segment losses and metrics, a checkpoint, and a fresh loop resumed from
    it holds bit-equal parameters, buffers and optimizer state."""
    cfg = _tiny_cfg(TCFG.update_cfg(os.path.join(
        REPO, "configs", "repr_wopw_3dpw_model.yaml")), tmp_path)
    cfg.MODEL.TGRU.NUM_LAYERS = 1
    cfg.MODEL.TGRU.HIDDEN_SIZE = 16
    cfg.TRAIN.MOT_DISCR.GCN.num_gcn_scales = 2
    cfg.TRAIN.MOT_DISCR.GCN.num_g3d_scales = 2
    cfg.TRAIN.END_EPOCH = 1
    cfg.TRAIN.PRETRAINED_REGRESSOR = ""
    kw = dict(synthetic=True, smoke_iters=2, smoke_verts=48, device="cpu")
    loop = TRUN.run_train(cfg, **kw)
    lines = [json.loads(s) for s in
             open(os.path.join(loop.logdir, "metrics.jsonl"))]
    tags = {d["tag"] for d in lines}
    assert {"train_loss/gen_loss", "train_loss/dis_loss",
            "error/pa-mpjpe", "lr/gen_lr"} <= tags
    assert all(np.isfinite(d["value"]) for d in lines)
    assert loop.gen_opt.param_groups[0]["count"] == 2
    path = os.path.join(loop.logdir, "checkpoint.npz")
    assert os.path.isfile(path)
    assert os.path.isfile(os.path.join(loop.logdir, "model_best.npz"))

    cfg2 = cfg.clone()
    cfg2.TRAIN.RESUME = path
    fresh, _ = TRUN.build_train_loop(cfg2, **kw)
    TRUN.close_loaders(fresh)
    assert fresh.start_epoch == 1
    assert fresh.best_performance == loop.best_performance
    for a, b in ((loop.gen, fresh.gen), (loop.disc, fresh.disc)):
        sa, sb = a.state_dict(), b.state_dict()
        assert sa.keys() == sb.keys()
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
    for a, b in ((loop.gen_opt, fresh.gen_opt),
                 (loop.disc_opt, fresh.disc_opt)):
        for x, y in zip(TO.opt_state_leaves(a), TO.opt_state_leaves(b)):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("argv,match", [
    # --devices is ported: more CUDA devices than are visible exit, naming
    # the count
    (["--devices", "64"], "only [0-9]+ CUDA devices are visible"),
    # --profile is ported (utils.profiling.trace): parsed, then --devices
    # is checked against the visible count
    (["--profile", "x", "--devices", "64"],
     "only [0-9]+ CUDA devices are visible"),
    # --precision bf16 is ported (bf16 compute): parsed, then --devices is
    # checked; values JAX's train.py rejects exit with its message
    (["--precision", "bf16", "--devices", "64"],
     "only [0-9]+ CUDA devices are visible"),
    (["--precision", "fp8"], r"unknown --precision 'fp8' \(choose bf16"),
])
def test_main_rejects_unported_options(monkeypatch, argv, match):
    monkeypatch.setattr(sys, "argv", ["train", "--synthetic"] + argv)
    with pytest.raises(SystemExit, match=match):
        TRUN.main()


def test_debug_visualization_raises_not_ported(tmp_path):
    """cfg.DEBUG raised "not ported" until utils/vis.py came to the port;
    now a loop builds with it, holding the synthetic model's triangle-soup
    faces as train.py builds them."""
    cfg = _tiny_cfg(TCFG.get_cfg_defaults(), tmp_path)
    cfg.DEBUG = True
    loop, _ = TRUN.build_train_loop(cfg, synthetic=True, smoke_verts=48,
                                    device="cpu")
    TRUN.close_loaders(loop)
    idx = np.arange(46)
    np.testing.assert_array_equal(
        loop.faces, np.stack([idx, idx + 1, idx + 2], 1)[::7])


def test_debug_visualization_writes_mp4(tmp_path):
    """A 2-window segment with DEBUG on writes the prediction-overlay video
    (one per segment at DEBUG_FREQ 1) with the frames of the JAX loop's
    grid: min(8, VIDLEN - seqlen + 1) windows, 224 rows, 224 columns per
    sample shown (at most 4)."""
    cv2 = pytest.importorskip("cv2")
    cfg = _tiny_cfg(TCFG.update_cfg(os.path.join(
        REPO, "configs", "repr_wopw_3dpw_model.yaml")), tmp_path)
    cfg.MODEL.TGRU.NUM_LAYERS = 1
    cfg.MODEL.TGRU.HIDDEN_SIZE = 16
    cfg.TRAIN.MOT_DISCR.GCN.num_gcn_scales = 2
    cfg.TRAIN.MOT_DISCR.GCN.num_g3d_scales = 2
    cfg.TRAIN.PRETRAINED_REGRESSOR = ""
    cfg.DEBUG = True
    cfg.DEBUG_FREQ = 1
    loop, _ = TRUN.build_train_loop(cfg, synthetic=True, smoke_iters=2,
                                    smoke_verts=48, device="cpu")
    loop.train_epoch(0, 1)
    TRUN.close_loaders(loop)
    videos = sorted(f for f in os.listdir(loop.logdir)
                    if f.startswith("debug_epoch000_") and f.endswith(".mp4"))
    assert videos == ["debug_epoch000_step000000.mp4"]
    cap = cv2.VideoCapture(os.path.join(loop.logdir, videos[0]))
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f)
    cap.release()
    n = min(4, cfg.TRAIN.BATCH_SIZE - int(cfg.TRAIN.BATCH_SIZE
                                          * cfg.TRAIN.DATA_2D_RATIO))
    assert len(frames) == min(8, cfg.DATASET.VIDLEN - S + 1)
    assert frames[0].shape == (224, 224 * n, 3)
    assert max(f.max() for f in frames) > 0      # something was drawn
