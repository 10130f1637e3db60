"""Port parity of the eval slice: the theta-feedback rollout against JAX
`make_eval_scan`, the host metrics and aggregation, the copied host helpers
(config, kp_utils, db, synthetic data) against their originals, the CLI
entry point, the golden writer, and that the port never imports JAX (nor
needs cv2, matplotlib or joblib to import).

Small widths (hidden 32, 2 layers, 300 vertices) on the CPU in float32.
Tolerances: 1e-4 m for per-frame joints and MPVPE and 1e-4 for theta over
17 feedback windows, 1e-6 relative for the metric summaries.
"""

import argparse
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import evaluate as jax_evaluate
from tepose_tpu import config as JCFG
from tepose_tpu.data import db as JDB
from tepose_tpu.data import kp_utils as JKP
from tepose_tpu.eval import evaluator as JE
from tepose_tpu.eval import metrics as JM
from tepose_tpu.models.smpl import synthetic_smpl_model as jax_smpl
from tepose_tpu.models.tepose import (
    TePoseConfig as JaxTePoseConfig, VibeConfig as JaxVibeConfig,
    tepose_init, vibe_init)
from tepose_tpu_torch import config as TCFG
from tepose_tpu_torch import evaluate as port_evaluate
from tepose_tpu_torch.data import db as TDB
from tepose_tpu_torch.data import kp_utils as TKP
from tepose_tpu_torch.eval import evaluator as TE
from tepose_tpu_torch.eval import metrics as TM
from tepose_tpu_torch.models.smpl import synthetic_smpl_model
from tepose_tpu_torch.models.tepose import TePose, TePoseConfig, Vibe, VibeConfig
from tepose_tpu_torch.ops import lbs_skinning as LS
from tepose_tpu_torch.weights import state_dict_from_jax_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import make_torch_port_golden as golden_writer  # noqa: E402

V = 300
S = 6


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs six workers on this host's
    cores, and these tests' small ops gain nothing from more."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def rollout_setup():
    jcfg = JaxTePoseConfig(seqlen=S, n_layers=2, hidden_size=32)
    jvcfg = JaxVibeConfig(seqlen=S, n_layers=2, hidden_size=32,
                          add_linear=True)
    jgen = jax.device_get(tepose_init(jax.random.PRNGKey(0), jcfg))
    jvibe = jax.device_get(vibe_init(jax.random.PRNGKey(1), jvcfg))
    gen = TePose(TePoseConfig(S, 2, 32),
                 generator=torch.Generator().manual_seed(0), device="cpu")
    vibe = Vibe(VibeConfig(S, 2, 32),
                generator=torch.Generator().manual_seed(0), device="cpu")
    gen.load_state_dict(state_dict_from_jax_tree(jgen))
    vibe.load_state_dict(state_dict_from_jax_tree(jvibe))
    data = port_evaluate.synthetic_eval_data(num_videos=3, min_len=15,
                                             max_len=23, seed=2)
    names = sorted(data)
    T = max(len(data[n]["features"]) for n in names)
    batch = port_evaluate.make_eval_batch(data, names, S, T, 4)
    return dict(jcfg=jcfg, jvcfg=jvcfg, jgen=jgen, jvibe=jvibe,
                gen=gen.eval(), vibe=vibe.eval(), data=data, names=names,
                batch=batch, T=T, jreg=port_evaluate.synthetic_j_regressor(V))


def _accumulate(acc, data, names, pred_j3d, mpvpe):
    for b, n in enumerate(names):
        L = len(data[n]["features"])
        tgt = TKP.convert_kps(data[n]["joints3D"][:L], "spin", "common")
        acc.add_video(pred_j3d[b, :L], tgt, mpvpe=mpvpe[b, :L])
    return acc.summarize()


@pytest.mark.parametrize("use_jreg", [True, False])
def test_eval_rollout_matches_jax(rollout_setup, use_jreg):
    s = rollout_setup
    W = s["T"] - S + 1
    assert W >= 15
    b = s["batch"]
    fn = JE.make_eval_scan(jax_smpl(0, V), s["jcfg"], s["jvcfg"], W,
                           use_j_regressor=use_jreg)
    with jax.default_matmul_precision("float32"):
        want = {k: np.asarray(v) for k, v in fn(
            s["jgen"], s["jvibe"], b["feats"], b["theta_pseu"],
            b["theta_gt"], s["jreg"]).items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    got = TE.eval_rollout(
        s["gen"], s["vibe"], synthetic_smpl_model(0, V), tb["feats"],
        tb["theta_pseu"], tb["theta_gt"],
        torch.from_numpy(s["jreg"]) if use_jreg else None, W)
    got = {k: v.numpy() for k, v in got.items()}
    for key in ("pred_j3d", "mpvpe", "pred_theta"):
        assert got[key].shape == want[key].shape
        np.testing.assert_allclose(got[key], want[key], atol=1e-4, rtol=0,
                                   err_msg=key)
    if use_jreg:
        summ = _accumulate(TE.EvalAccumulator(), s["data"], s["names"],
                           got["pred_j3d"], got["mpvpe"])
        want_summ = _accumulate(JE.EvalAccumulator(), s["data"], s["names"],
                                want["pred_j3d"], want["mpvpe"])
        assert summ.keys() == want_summ.keys() == {
            "mpjpe", "pa_mpjpe", "mpvpe", "accel_err"}
        for k in summ:
            np.testing.assert_allclose(summ[k], want_summ[k], rtol=1e-6)


def test_eval_rollout_window_guard(rollout_setup):
    s = rollout_setup
    tb = {k: torch.from_numpy(v) for k, v in s["batch"].items()}
    args = (s["gen"], s["vibe"], synthetic_smpl_model(0, V), tb["feats"],
            tb["theta_pseu"], tb["theta_gt"], None)
    for bad in (s["T"] - S + 2, 0):
        with pytest.raises(ValueError, match="num_windows"):
            TE.eval_rollout(*args, bad)


def _fake_videos(rng, n_videos=3, K=14):
    vids = []
    for i in range(n_videos):
        T = 12 + 3 * i
        pred = rng.randn(T, K, 3).astype(np.float32) * 0.3
        tgt = (pred + rng.randn(T, K, 3).astype(np.float32) * 0.05)
        vids.append((pred, tgt, rng.rand(T).astype(np.float32) * 0.1))
    return vids


@pytest.mark.parametrize("dataset", ["3dpw", "mpii3d"])
def test_eval_accumulator_matches_jax(rng, dataset):
    K = 17 if dataset == "mpii3d" else 14
    port, ref = TE.EvalAccumulator(dataset), JE.EvalAccumulator(dataset)
    for i, (pred, tgt, mpv) in enumerate(_fake_videos(rng, K=K)):
        valid = None
        if dataset == "mpii3d":
            valid = np.delete(np.arange(len(pred)), [0, 4, 5] if i else [3])
        for acc in (port, ref):
            acc.add_video(pred, tgt, mpvpe=mpv, valid_map=valid)
    got, want = port.summarize(), ref.summarize()
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6)


def test_metrics_match_jax(rng):
    pred = rng.randn(20, 14, 3).astype(np.float32)
    tgt = pred + 0.1 * rng.randn(20, 14, 3).astype(np.float32)
    for got, want in zip(TM.host_joint_errors(pred, tgt),
                         JM.host_joint_errors(pred, tgt)):
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        TM.mpjpe(torch.from_numpy(pred), torch.from_numpy(tgt)).numpy(),
        np.asarray(JM.mpjpe(jnp.asarray(pred), jnp.asarray(tgt))), atol=1e-6)
    vis = rng.rand(20) > 0.2
    for v in (None, vis):
        np.testing.assert_array_equal(TM.accel_error_eval(pred, tgt, v),
                                      JM.accel_error_eval(pred, tgt, v))


def test_spin49_to_eval_format_matches_jax(rng):
    x = rng.randn(4, 49, 3).astype(np.float32)
    for dataset in ("3dpw", "h36m", "mpii3d"):
        np.testing.assert_array_equal(TE.spin49_to_eval_format(x, dataset),
                                      JE.spin49_to_eval_format(x, dataset))


def test_kp_utils_copy_matches(rng):
    formats = sorted(TKP._REGISTRY)
    assert formats == sorted(JKP._REGISTRY)
    for src in formats:
        assert TKP.joint_names(src) == JKP.joint_names(src)
        x = rng.randn(2, len(TKP.joint_names(src)), 3).astype(np.float32)
        for dst in formats:
            assert TKP.perm_idxs(src, dst) == JKP.perm_idxs(src, dst)
            np.testing.assert_array_equal(TKP.convert_kps(x, src, dst),
                                          JKP.convert_kps(x, src, dst))


def test_config_copy_matches():
    assert TCFG.get_cfg_defaults() == JCFG.get_cfg_defaults()
    for name in sorted(os.listdir(os.path.join(REPO, "configs"))):
        path = os.path.join(REPO, "configs", name)
        assert TCFG.update_cfg(path) == JCFG.update_cfg(path), name
    argv = ["--cfg", os.path.join(REPO, "configs", "repr_wopw_3dpw_model.yaml"),
            "--dataset", "mpii3d", "--seq", "x", "--eval_batch", "4",
            "--eval_bucket", "64", "--gpu", "cpu", "--frame", "3"]
    for a in (argv, argv[:4], []):
        got, want = TCFG.parse_args(a), JCFG.parse_args(a)
        assert got[0] == want[0] and got[1] == want[1]
        assert vars(got[2]) == vars(want[2])
    for name in ("TePose_DB_DIR", "BASE_DATA_DIR", "THREEDPW_DIR"):
        assert getattr(TCFG, name) == getattr(JCFG, name)


def test_db_copy_matches(rng, tmp_path):
    for dataset in ("3dpw", "h36m", "mpii3d"):
        for title in ("repr_wpw_h36m_mpii3d_model", "repr_wopw_h36m_model"):
            for render in (False, True):
                assert TDB.eval_db_paths(dataset, title, render) == \
                    JDB.eval_db_paths(dataset, title, render)
    with pytest.raises(ValueError):
        TDB.eval_db_paths("nope", "")
    n = 12
    db = {"vid_name": np.array(["a"] * 5 + ["b"] * 7),
          "features": rng.randn(n, 4), "joints3D": rng.randn(n, 49, 3),
          "img_name": np.array([f"f{i}" for i in range(n)]),
          "bbox": rng.randn(n, 4), "pose": rng.randn(n, 72),
          "shape": rng.randn(n, 10), "valid": rng.rand(n) > 0.3,
          "valid_i": rng.rand(n, 1) > 0.5}
    pse = rng.randn(n, 85)
    for kw in ({}, {"target_action": "b"}, {"is_mpii3d": True}):
        got = TDB.key_eval_db_by_video(db, pse, **kw)
        want = JDB.key_eval_db_by_video(db, pse, **kw)
        assert got.keys() == want.keys()
        for vid in got:
            assert got[vid].keys() == want[vid].keys()
            for k in got[vid]:
                np.testing.assert_array_equal(got[vid][k], want[vid][k])
    import joblib

    path = str(tmp_path / "x_db.pt")
    joblib.dump(db, path)
    np.testing.assert_array_equal(TDB.load_db(path)["pose"], db["pose"])
    for fn in (TDB.load_db, TDB.load_pseudotheta):
        with pytest.raises(FileNotFoundError):
            fn(str(tmp_path / "missing.pt"))


@pytest.mark.parametrize("kw", [{}, dict(num_videos=2, min_len=40,
                                         max_len=44, seed=5)])
def test_synthetic_eval_data_matches_jax(kw):
    got = port_evaluate.synthetic_eval_data(**kw)
    want = jax_evaluate.synthetic_eval_data(**kw)
    assert got.keys() == want.keys()
    for vid in got:
        assert got[vid].keys() == want[vid].keys()
        for k in got[vid]:
            assert got[vid][k].dtype == want[vid][k].dtype
            np.testing.assert_array_equal(got[vid][k], want[vid][k])


def test_build_models_synthetic_assets_match_jax():
    cfg = TCFG.update_cfg(os.path.join(REPO, "configs",
                                       "repr_wopw_3dpw_model.yaml"))
    cfg.MODEL.TGRU.HIDDEN_SIZE = 32
    jsmpl, _, _, _, _, jreg = jax_evaluate.build_models(cfg, synthetic=True)
    smpl, gen, vibe, treg = port_evaluate.build_models(cfg, True, "cpu")
    np.testing.assert_array_equal(treg.numpy(), jreg)
    np.testing.assert_array_equal(smpl.posedirs.numpy(),
                                  np.asarray(jsmpl.posedirs))
    assert smpl.vertex_joint_ids == jsmpl.vertex_joint_ids
    assert (gen.cfg.seqlen, gen.cfg.n_layers, gen.cfg.hidden_size) == (6, 2, 32)
    assert (vibe.cfg.n_layers, vibe.cfg.hidden_size) == (2, 1024)
    assert not gen.training and not vibe.training


def _args(**kw):
    ns = argparse.Namespace(dataset="3dpw", seq="", render=False,
                            render_plain=False, filter=False, plot=False,
                            frame=0, eval_batch=None, eval_bucket=None)
    for k, v in kw.items():
        setattr(ns, k, v)
    return ns


def test_run_eval_cpu_synthetic():
    """The entry point end to end on the CPU, plain skinning path."""
    cfg = TCFG.update_cfg(os.path.join(REPO, "configs",
                                       "repr_wopw_3dpw_model.yaml"))
    cfg.MODEL.TGRU.HIDDEN_SIZE = 32
    before = LS.LAUNCHES
    res = port_evaluate.run_eval(cfg, _args(), synthetic=True, device="cpu")
    assert LS.LAUNCHES == before
    assert res["frames"] == sum(
        len(d["features"]) for d in port_evaluate.synthetic_eval_data().values())
    for k in ("mpjpe", "pa_mpjpe", "mpvpe", "accel_err", "seconds"):
        assert np.isfinite(res[k]) and res[k] > 0, k


class _ReachedModels(Exception):
    pass


@pytest.mark.parametrize("flag", ["filter", "render", "render_plain", "plot"])
def test_run_eval_rejects_later_slice_flags(flag, monkeypatch):
    """These flags were refused as "not ported" until the demo slice; now
    run_eval takes each one through to building the models (their outputs
    are held to the JAX CLI in tests/test_torch_eval_extras.py)."""
    def reached(*a, **kw):
        raise _ReachedModels

    monkeypatch.setattr(port_evaluate, "build_models", reached)
    with pytest.raises(_ReachedModels):
        port_evaluate.run_eval(None, _args(**{flag: True}), synthetic=True,
                               device="cpu")


@pytest.mark.parametrize("argv,match", [
    # --devices is ported: more CUDA devices than are visible exit, naming
    # the count
    (["--devices", "64"], "only [0-9]+ are visible"),
    # --precision takes the JAX CLI's tiers (tests/test_torch_bf16.py runs
    # them); unknown values and a missing value exit
    (["--precision", "fp8"], "unknown --precision 'fp8': choose float32"),
    (["--precision"], "--precision needs a value"),
])
def test_main_rejects_unported_options(monkeypatch, argv, match):
    monkeypatch.setattr(sys, "argv", ["evaluate", "--synthetic"] + argv)
    with pytest.raises(SystemExit, match=match):
        port_evaluate.main()


def test_never_imports_jax():
    """Every port module and chip_smoke import without JAX, with the demo's
    and the DB builders' optional host libraries present and with them, JAX
    and the JAX package blocked (the GPU host has no JAX, joblib or h5py,
    and cv2 and matplotlib are not assumed)."""
    code = (
        "import sys\n"
        "for name in sys.argv[1:]:\n"
        "    sys.modules[name] = None\n"
        "import pkgutil, importlib, tepose_tpu_torch\n"
        "for m in pkgutil.walk_packages(tepose_tpu_torch.__path__,"
        " 'tepose_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if (m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib', 'tepose_tpu.')) or m == 'tepose_tpu')"
        " and sys.modules[m] is not None)\n"
        "assert not bad, bad\n"
        "for m in ('evaluate', 'demo', 'native', 'streaming.tracker',\n"
        "          'utils.vis', 'models.smplify', 'convert_checkpoint',\n"
        "          'convert_smpl', 'verify_release', 'utils.flops',\n"
        "          'utils.profiling', 'preprocess.threedpw',\n"
        "          'preprocess.pseudo_theta', 'preprocess.insta',\n"
        "          'data.preprocess', 'data.h5', 'parallel.distributed',\n"
        "          'parallel.mesh', 'parallel.dp', 'parallel.mp_dryrun',\n"
        "          'tune_eval_batching', 'precision_sweep'):\n"
        "    assert 'tepose_tpu_torch.' + m in sys.modules, m\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    for blocked in ([], ["cv2", "matplotlib", "joblib", "h5py", "jax",
                         "jaxlib", "tepose_tpu"]):
        proc = subprocess.run([sys.executable, "-c", code, *blocked],
                              cwd=REPO, env=env, capture_output=True,
                              text=True, timeout=120)
        assert proc.returncode == 0, (blocked, proc.stderr)


SMALL_SPEC = dict(golden_writer.FULL_SPEC, hidden_size=32, vibe_hidden_size=32,
                  num_verts=700, min_len=22, max_len=24)


def test_golden_writer_matches_port_small():
    """The writer's function at small width against the port on the CPU."""
    golden = golden_writer.make_golden(SMALL_SPEC)
    setup = golden_writer.port_setup(SMALL_SPEC, "cpu")
    np.testing.assert_array_equal(golden_writer.weight_checksums(setup),
                                  golden["weight_checksums"])
    got = golden_writer.port_rollout(setup)
    for key in ("pred_j3d", "mpvpe", "pred_theta"):
        np.testing.assert_allclose(got[key], golden[key], atol=1e-4, rtol=0)


def test_committed_golden_matches_port_on_cpu():
    """The committed full-width golden, which the GPU run is held to, is
    reproduced by the port on the CPU: 0.1 mm joints and MPVPE, 1e-3 theta,
    as chip_smoke.py holds the card."""
    path = golden_writer.GOLDEN_PATH
    assert os.path.getsize(path) < 1 << 20
    golden = golden_writer.load_golden(path)
    assert golden["spec"] == golden_writer.FULL_SPEC
    setup = golden_writer.port_setup(golden["spec"], "cpu")
    np.testing.assert_allclose(golden_writer.weight_checksums(setup),
                               golden["weight_checksums"], rtol=1e-9, atol=0)
    got = golden_writer.port_rollout(setup)
    B, T = golden["pred_theta"].shape[:2]
    assert (B, T) == (2, setup["num_windows"] + golden["spec"]["seqlen"] - 1)
    for key, atol in (("pred_j3d", 1e-4), ("mpvpe", 1e-4),
                      ("pred_theta", 1e-3)):
        assert np.isfinite(golden[key]).all()
        np.testing.assert_allclose(got[key], golden[key], atol=atol, rtol=0)
