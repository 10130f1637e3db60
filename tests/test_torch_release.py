"""The port's release tools against the JAX tools, on fabricated assets.

- `tepose_tpu_torch.convert_checkpoint` against `tools/convert_checkpoint.py`
  on reference-layout state dicts drawn from a seed (a TePose generator with
  `module.` prefixes, `regressor.smpl.*` buffers and attention weights, the
  reference's GCN discriminator module, a VIBE generator, a SPIN
  `{'model': ...}` with its ResNet-50): every array of the two npz files
  equal, and the scalars; `--reverse` with and without `--like` equal to
  the JAX tool's and to the fabricated tensors; the CLI with `jax`,
  `tepose_tpu` and `joblib` blocked.
- `tepose_tpu_torch.convert_smpl` against `tools/convert_smpl.py`.
- `data.db.read_joblib` against `joblib.load`.
- `tepose_tpu_torch.verify_release`: the gate and tables against the JAX
  tool's, the self-test on the CPU (the 3DPW run at full size; the GPU
  smoke run takes all three), and its metrics against the JAX tool's
  `verify` on the same fabricated 3DPW release within 1e-3 mm.
- `utils.profiling.trace` and the CLIs' `--profile`.
"""

import json
import os
import pickle
import shutil
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from test_disc_converter import TorchMotionDisc
from test_torch_backbone import _hmr_state_dict
from tepose_tpu_torch import convert_checkpoint as PCC
from tepose_tpu_torch import convert_smpl as PCS
from tepose_tpu_torch import verify_release as PVR
from tepose_tpu_torch.data import db as PDB
from tepose_tpu_torch.models.tepose import (
    TePose, TePoseConfig, Vibe, VibeConfig)
from tepose_tpu_torch.train.checkpoint import export_torch_generator
from tepose_tpu_torch.weights import jax_tree_from_state_dict
from tools import convert_checkpoint as JCC
from tools import convert_smpl as JCS
from tools import verify_release as JVR

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRIC_ATOL_MM = 1e-3


def _torch_sd(module, prefix=""):
    return {prefix + k: torch.from_numpy(np.array(v)) for k, v in
            export_torch_generator(jax_tree_from_state_dict(
                module.state_dict())).items()}


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """Reference-layout checkpoints and both tools' forward conversions."""
    root = tmp_path_factory.mktemp("ckpts")
    rs = np.random.RandomState(5)
    gen = TePose(TePoseConfig(6, 2, 32),
                 generator=torch.Generator().manual_seed(3), device="cpu")
    gen_sd = _torch_sd(gen, "module.")
    extras = {"module.regressor.smpl.v_template": torch.randn(30, 3),
              "module.regressor.smpl.faces_tensor": torch.arange(12),
              "module.encoder.attention.fc.weight": torch.randn(4, 8)}
    torch.manual_seed(4)
    disc = TorchMotionDisc()
    with torch.no_grad():
        for name, t in disc.named_buffers():   # trained BN statistics
            if name.endswith(("running_mean", "running_var")):
                t.copy_(torch.rand(t.shape) + 0.5)
    disc_sd = {"module." + k: v.clone() for k, v in disc.state_dict().items()}
    tepose = {"gen_state_dict": {**gen_sd, **extras},
              "disc_motion_state_dict": disc_sd, "performance": 52.3,
              "epoch": 30, "gen_optimizer": {"state": {}, "lr": 5e-5}}
    vibe = Vibe(VibeConfig(6, 1, 16, add_linear=True),
                generator=torch.Generator().manual_seed(6), device="cpu")
    sd = {k: torch.from_numpy(v) for k, v in _hmr_state_dict(7).items()}
    for name, shape in (("fc1.weight", (1024, 2205)), ("fc1.bias", (1024,)),
                        ("fc2.weight", (1024, 1024)), ("fc2.bias", (1024,)),
                        ("decpose.weight", (144, 1024)),
                        ("decpose.bias", (144,)),
                        ("decshape.weight", (10, 1024)),
                        ("decshape.bias", (10,)),
                        ("deccam.weight", (3, 1024)), ("deccam.bias", (3,)),
                        ("init_pose", (1, 144)), ("init_shape", (1, 10)),
                        ("init_cam", (1, 3))):
        sd[name] = torch.from_numpy(rs.randn(*shape).astype(np.float32))
    spin = {"model": {"module." + k: v for k, v in sd.items()}}
    out = {"root": root, "src": {}, "jax": {}, "port": {},
           "tepose": tepose, "gen_sd": gen_sd, "disc_sd": disc_sd}
    for kind, ckpt in (("tepose", tepose),
                       ("vibe", {"gen_state_dict": _torch_sd(vibe),
                                 "performance": 56.5}),
                       ("spin", spin)):
        src = str(root / f"{kind}.pth.tar")
        torch.save(ckpt, src)
        out["src"][kind] = src
        for tool, conv in (("jax", JCC), ("port", PCC)):
            dst = str(root / f"{kind}_{tool}.npz")
            conv.convert_forward(src, dst, kind=kind)
            out[tool][kind] = dst
    return out


def _npz(path):
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    with open(os.path.splitext(path)[0] + ".json") as f:
        return arrays, json.load(f)


@pytest.mark.parametrize("kind", ["tepose", "vibe", "spin"])
def test_convert_forward_matches_jax_tool(ckpts, kind):
    got, got_scalars = _npz(ckpts["port"][kind])
    want, want_scalars = _npz(ckpts["jax"][kind])
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got_scalars == want_scalars
    if kind == "tepose":
        assert {k.split("/")[0] for k in got} == {"gen", "disc", "disc_state"}
        assert got_scalars == {"performance": 52.3, "epoch": 30.0}
    if kind == "spin":
        assert {k.split("/")[0] for k in got} == {"gen", "backbone"}


def _reverse(ckpts, tool, like):
    dst = str(ckpts["root"] / f"rev_{tool}_{bool(like)}.pth.tar")
    conv = JCC if tool == "jax" else PCC
    conv.convert_reverse(ckpts["port"]["tepose"], dst,
                         ckpts["src"]["tepose"] if like else "")
    return torch.load(dst, map_location="cpu", weights_only=False)


def _same_tensors(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("like", [False, True])
def test_convert_reverse_matches_jax_tool_and_source(ckpts, like):
    got, want = _reverse(ckpts, "port", like), _reverse(ckpts, "jax", like)
    assert sorted(got) == sorted(want)
    for k in ("gen_state_dict", "disc_motion_state_dict"):
        _same_tensors(got[k], want[k])
    assert got["performance"] == want["performance"] == 52.3
    assert got["epoch"] == want["epoch"] == 30
    # the learned tensors come back exactly, 'module.' stripped
    gen = got["gen_state_dict"]
    for k, v in ckpts["gen_sd"].items():
        assert torch.equal(gen[k[len("module."):]], v), k
    disc = got["disc_motion_state_dict"]
    src = {k[len("module."):]: v for k, v in ckpts["disc_sd"].items()}
    adjacency = {k for k in src if k.endswith(("A_powers", "A_scales"))}
    assert set(src) - set(disc) == adjacency
    for k in set(src) - adjacency:
        assert torch.equal(disc[k].to(src[k].dtype), src[k]), k
    if like:   # the template's other entries ride along
        assert got["gen_optimizer"] == ckpts["tepose"]["gen_optimizer"]
        extras = {k for k in ckpts["tepose"]["gen_state_dict"]
                  if ".smpl." in k or ".attention." in k}
        assert extras <= set(gen)
    else:
        assert sorted(got) == ["disc_motion_state_dict", "epoch",
                               "gen_state_dict", "performance"]
        assert len(gen) == len(ckpts["gen_sd"])


def test_convert_checkpoint_cli_runs_without_jax(ckpts, tmp_path):
    """`python -m tepose_tpu_torch.convert_checkpoint`, forward and
    reverse, in a process where jax, tepose_tpu and joblib cannot be
    imported; the outputs equal the in-process ones."""
    fwd, rev = str(tmp_path / "cli.npz"), str(tmp_path / "cli.pth.tar")
    code = (
        "import runpy, sys\n"
        "for name in ('jax', 'jaxlib', 'tepose_tpu', 'joblib'):\n"
        "    sys.modules[name] = None\n"
        "for argv in ([{src!r}, {fwd!r}, '--kind', 'tepose'],\n"
        "             [{fwd!r}, {rev!r}, '--reverse']):\n"
        "    sys.argv = ['convert_checkpoint'] + argv\n"
        "    runpy.run_module('tepose_tpu_torch.convert_checkpoint',\n"
        "                     run_name='__main__')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'tepose_tpu', 'joblib')\n"
        "             and sys.modules[m] is not None)\n"
        "assert not bad, bad\n").format(src=ckpts["src"]["tepose"], fwd=fwd,
                                        rev=rev)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    got, want = _npz(fwd), _npz(ckpts["port"]["tepose"])
    assert got[1] == want[1] and sorted(got[0]) == sorted(want[0])
    for k in want[0]:
        np.testing.assert_array_equal(got[0][k], want[0][k], err_msg=k)
    _same_tensors(
        torch.load(rev, weights_only=False)["gen_state_dict"],
        _reverse(ckpts, "port", False)["gen_state_dict"])


def test_convert_smpl_matches_jax_tool(tmp_path):
    """One fabricated 6890-vertex official-layout pkl through both
    converters: equal npz contents, with and without the extra
    regressor."""
    pkl, jre, _ = PVR._fabricate_smpl_pkl(str(tmp_path))
    for extra in (jre, ""):
        outs = []
        for tool, conv in (("jax", JCS), ("port", PCS)):
            dst = str(tmp_path / f"{tool}_{bool(extra)}.npz")
            conv.convert(pkl, dst, extra)
            with np.load(dst) as z:
                outs.append({k: z[k] for k in z.files})
        got, want = outs[1], outs[0]
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with pytest.raises(FileNotFoundError, match="j-regressor-extra"):
        PCS.convert(pkl, str(tmp_path / "x.npz"), str(tmp_path / "no.npy"))


# ------------------------------------------------------- joblib-free reader


def _db_case(rs):
    return {
        "vid_name": np.array(["downtown_walking_00", "office_01", "x"]),
        "features": rs.randn(7, 2048).astype(np.float32),
        "frame_id": np.arange(21, dtype=np.int64).reshape(7, 3),
        "joints3D_F": np.asfortranarray(rs.randn(7, 49, 3).astype(np.float32)),
        "valid_F": np.asfortranarray(rs.randint(0, 2, (5, 4)).astype(np.int64)),
        "scalar": np.array(3.25),
        "empty": np.zeros((0, 85), np.float32),
        "img_name": np.array(["a.jpg", rs.randn(2), None], dtype=object),
        "nested": {"bbox": rs.rand(3, 4).astype(np.float32),
                   "meta": [1, "two", 3.0]},
    }


def _deep_equal(a, b, path="db"):
    assert type(a) is type(b), path
    if isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            _deep_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _deep_equal(x, y, f"{path}/{i}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.flags.c_contiguous == b.flags.c_contiguous, path
        assert a.flags.f_contiguous == b.flags.f_contiguous, path
        if a.dtype.hasobject:
            for i, (x, y) in enumerate(zip(a.ravel(), b.ravel())):
                _deep_equal(x, y, f"{path}[{i}]")
        else:
            np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


@pytest.mark.parametrize("protocol", [None, 2, 5])
@pytest.mark.parametrize("case", ["db", "pseudotheta"])
def test_read_joblib_equals_joblib_load(tmp_path, case, protocol):
    joblib = pytest.importorskip("joblib")
    rs = np.random.RandomState(0)
    obj = (_db_case(rs) if case == "db"
           else rs.randn(40, 85).astype(np.float32))
    path = str(tmp_path / f"{case}.pt")
    joblib.dump(obj, path, protocol=protocol)
    _deep_equal(PDB.read_joblib(path), joblib.load(path))


def test_read_joblib_plain_pickle_and_compressed(tmp_path):
    joblib = pytest.importorskip("joblib")
    rs = np.random.RandomState(1)
    obj = _db_case(rs)
    path = str(tmp_path / "plain.pt")
    with open(path, "wb") as f:
        pickle.dump(obj, f)
    _deep_equal(PDB.read_joblib(path), joblib.load(path))
    _deep_equal(PDB.read_joblib(path), obj)
    for compress in (3, ("gzip", 3)):
        zpath = str(tmp_path / "z.pt")
        joblib.dump(obj, zpath, compress=compress)
        with pytest.raises(ValueError, match=f"{zpath} is a .*compressed"):
            PDB.read_joblib(zpath)


def test_load_db_without_joblib(tmp_path, monkeypatch):
    joblib = pytest.importorskip("joblib")
    rs = np.random.RandomState(2)
    db, pse = _db_case(rs), rs.randn(7, 85).astype(np.float32)
    joblib.dump(db, str(tmp_path / "x_db.pt"))
    joblib.dump(pse, str(tmp_path / "x_pseudotheta.pt"))
    want = (joblib.load(str(tmp_path / "x_db.pt")),
            joblib.load(str(tmp_path / "x_pseudotheta.pt")))
    monkeypatch.setitem(sys.modules, "joblib", None)
    _deep_equal(PDB.load_db(str(tmp_path / "x_db.pt")), want[0])
    _deep_equal(PDB.load_pseudotheta(str(tmp_path / "x_pseudotheta.pt")),
                want[1])


# ------------------------------------------------------ release verification


def test_runs_table_and_gate_are_the_jax_tools():
    assert PVR.RUNS == JVR.RUNS
    assert PVR.SELFTEST_KEYS == JVR.SELFTEST_KEYS
    for r in PVR.RUNS:
        assert PVR._run_key(r) == JVR._run_key(r)
        assert PVR._ckpt_npz_name(r["title"]) == \
            JVR._ckpt_npz_name(r["title"])
    run = {"dataset": "3dpw", "title": "t",
           "expected": {"pa_mpjpe": 52.3, "mpjpe": 84.6}}
    for res in ({"pa_mpjpe": 52.35, "mpjpe": 90.0},
                {"pa_mpjpe": 52.45, "mpjpe": 84.6}, {"mpjpe": 84.6}):
        assert PVR.check_run(run, res, 0.1, 0.15) == \
            JVR.check_run(run, res, 0.1, 0.15)


def test_check_run_gates_on_pa_only():
    run = {"dataset": "3dpw", "title": "t",
           "expected": {"pa_mpjpe": 52.3, "mpjpe": 84.6}}
    ok, rows = PVR.check_run(run, {"pa_mpjpe": 52.35, "mpjpe": 90.0},
                             tol_pa=0.1, tol_other=0.15)
    assert ok and not rows["mpjpe"]["within"]
    ok, _ = PVR.check_run(run, {"pa_mpjpe": 52.45, "mpjpe": 84.6}, 0.1, 0.15)
    assert not ok
    ok, _ = PVR.check_run(run, {"mpjpe": 84.6}, 0.1, 0.15)
    assert not ok   # a missing PA metric cannot pass


def test_ckpt_names_follow_configs():
    assert PVR._ckpt_npz_name("repr_wpw_3dpw_model") == \
        "tepose_wpw_3dpw_test.npz"
    assert PVR._ckpt_npz_name("repr_wpw_h36m_mpii3d_model").endswith(".npz")
    with pytest.raises(ValueError, match="unknown runs"):
        PVR.select_runs(["3dpw:nope"])


@pytest.fixture(scope="module")
def self_test(tmp_path_factory):
    """The port's self-test at full size (6890-vertex SMPL, full-width
    generators) on the CPU, on the 3DPW run alone: all three of the CLI's
    runs take ~20 s alone but over 700 s beside the suite's other workers,
    writing and reading ~3 GB of checkpoints. Two threads, as six workers
    share the host's cores."""
    import tepose_tpu_torch.config as C

    workdir = str(tmp_path_factory.mktemp("selftest"))
    before = (C.BASE_DATA_DIR, C.TePose_DB_DIR, PDB.TePose_DB_DIR)
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    try:
        report = PVR.self_test("cpu", PVR.SELFTEST_KEYS[:1], workdir=workdir)
    finally:
        torch.set_num_threads(threads)
    assert (C.BASE_DATA_DIR, C.TePose_DB_DIR, PDB.TePose_DB_DIR) == before
    yield workdir, report
    shutil.rmtree(workdir)   # ~0.8 GB of full-width checkpoints


def test_self_test_on_cpu(self_test):
    workdir, report = self_test
    assert report["self_test"] == "ok" and not report["pass"]
    assert set(report["runs"]) == {PVR.SELFTEST_KEYS[0]}
    for key, rr in report["runs"].items():
        want = {"pa_mpjpe", "mpjpe", "accel_err"} | (
            {"mpvpe"} if key.startswith("3dpw") else set())
        assert set(rr["metrics"]) == want, key
        assert all(np.isfinite(r["measured"]) for r in rr["metrics"].values())
        assert rr["raw"]["frames"] > 0
    fab = os.path.join(workdir, "fabricated", "preprocessed_data")
    with open(os.path.join(fab, "3dpw_test_db.pt"), "rb") as f:
        assert f.read(1) == b"\x80"   # plain pickle, no joblib needed


def test_verify_matches_jax_tool_on_the_same_release(self_test, tmp_path,
                                                     monkeypatch):
    """JAX's `verify` on the self-test's fabricated 3DPW release (its own
    converters, `evaluate.run_eval` on the CPU) against the port's report:
    every measured metric within 1e-3 mm."""
    import tepose_tpu.config as JC
    import tepose_tpu.data.db as JDB

    workdir, report = self_test
    # the JAX tool rebinds these for good; put them back afterwards
    for mod, name in ((JC, "BASE_DATA_DIR"), (JC, "TePose_DB_DIR"),
                      (JDB, "TePose_DB_DIR")):
        monkeypatch.setattr(mod, name, getattr(mod, name))
    for var in ("TEPOSE_BASE_DATA_DIR", "TEPOSE_DB_DIR"):
        monkeypatch.setenv(var, os.environ.get(var, ""))
    fab = os.path.join(workdir, "fabricated")
    key = PVR.SELFTEST_KEYS[0]
    args = SimpleNamespace(
        ckpt_dir=fab, vibe=os.path.join(fab, "vibe_model_wo_3dpw.pth.tar"),
        smpl=os.path.join(fab, "SMPL_NEUTRAL.pkl"),
        j_regressor_extra=os.path.join(fab, "J_regressor_extra.npy"),
        j_regressor_h36m=os.path.join(fab, "J_regressor_h36m.npy"),
        db_dir=os.path.join(fab, "preprocessed_data"),
        workdir=str(tmp_path / "jax"), tol_pa=0.1, tol_other=0.15,
        eval_batch=4, eval_bucket=32)
    jax_report = JVR.verify(args, [r for r in JVR.RUNS
                                   if JVR._run_key(r) == key])
    shutil.rmtree(args.workdir)
    got = report["runs"][key]["raw"]
    want = jax_report["runs"][key]["raw"]
    gaps = {k: abs(got[k] - want[k])
            for k in ("pa_mpjpe", "mpjpe", "mpvpe", "accel_err")}
    print(f"port vs JAX verify on {key}: |gap| mm {gaps}")
    assert all(g <= METRIC_ATOL_MM for g in gaps.values()), gaps


# ------------------------------------------------------------- profiling


def test_trace_writes_chrome_json_with_aten_ops(tmp_path):
    """trace() around three windows of the port's eval rollout at small
    width on the CPU writes a Chrome trace naming aten:: ops."""
    from tepose_tpu_torch.eval.evaluator import eval_rollout
    from tepose_tpu_torch.models.smpl import synthetic_smpl_model
    from tepose_tpu_torch.utils.profiling import trace

    g = torch.Generator().manual_seed(0)
    gen = TePose(TePoseConfig(6, 1, 16), generator=g, device="cpu").eval()
    vibe = Vibe(VibeConfig(6, 1, 16, add_linear=True), generator=g,
                device="cpu").eval()
    smpl = synthetic_smpl_model(0, 64)
    rs = np.random.RandomState(0)
    feats = torch.from_numpy(rs.randn(2, 8, 2048).astype(np.float32))
    pseu = torch.zeros(2, 5, 85)
    pseu[..., 0] = 1.0
    gt = torch.zeros(2, 8, 85)
    with trace(str(tmp_path / "prof"), "cpu") as t:
        with torch.no_grad():
            eval_rollout(gen, vibe, smpl, feats, pseu, gt, None, 3)
    assert os.path.dirname(t.path) == str(tmp_path / "prof")
    assert t.path.endswith(".pt.trace.json")
    with open(t.path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names)
    assert any(n in ("aten::mm", "aten::addmm", "aten::bmm") for n in names)


def test_train_cli_accepts_profile(monkeypatch, tmp_path):
    """`python -m tepose_tpu_torch.train --profile DIR` reaches run_train
    with the directory."""
    from tepose_tpu_torch.train import run as TRUN

    seen = {}
    monkeypatch.setattr(TRUN, "run_train",
                        lambda cfg, **kw: seen.update(kw))
    monkeypatch.setattr(sys, "argv", [
        "train", "--synthetic", "--gpu", "cpu", "--cfg",
        os.path.join(REPO, "configs", "repr_wopw_3dpw_model.yaml"),
        "--profile", str(tmp_path)])
    TRUN.main()
    assert seen["profile"] == str(tmp_path) and seen["device"] == "cpu"


def test_demo_cli_profile_writes_a_trace(monkeypatch, tmp_path):
    """`demo --profile DIR` runs the demo under trace(), which writes its
    file when the run returns."""
    from tepose_tpu_torch import demo as port_demo

    monkeypatch.setattr(port_demo, "_main",
                        lambda args: torch.ones(8, 8) @ torch.ones(8, 8))
    port_demo.main(["--synthetic", "--gpu", "cpu", "--profile",
                    str(tmp_path / "p")])
    files = os.listdir(tmp_path / "p")
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
