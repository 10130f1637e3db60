"""One-command release verification on the port: released torch assets in,
pass/fail out.

The port's counterpart of `tools/verify_release.py`, which needs JAX. Given
the reference release's assets (the TePose checkpoints
`tepose_*_test.pth.tar`, the VIBE bootstrap checkpoint, the licensed SMPL
neutral pkl with SPIN's J_regressor_extra.npy and J_regressor_h36m.npy, and
the preprocessed eval DBs), it converts everything once
(`convert_checkpoint`, `convert_smpl`), runs the BASELINE.md reproduction
evaluations through `evaluate.run_eval` in strict float32, and checks the
measured metrics against the paper's tables. The gate is PA-MPJPE within
`--tol-pa` (default 0.1 mm, BASELINE.md) on every run; the other table
metrics carry their own within-tolerance flags but do not gate.

  python -m tepose_tpu_torch.verify_release \\
      --ckpt-dir   ~/tepose_release/pretrained_models \\
      --vibe       ~/tepose_release/vibe_model_wo_3dpw.pth.tar \\
      --smpl       ~/smpl/SMPL_NEUTRAL.pkl \\
      --j-regressor-extra ~/spin_data/J_regressor_extra.npy \\
      --j-regressor-h36m  ~/spin_data/J_regressor_h36m.npy \\
      --db-dir     ~/tepose_release/preprocessed_data \\
      [--workdir W] [--only 3dpw:repr_wpw_3dpw_model] [--tol-pa 0.1] \\
      [--report report.json] [--gpu 0|cpu]

Exit code 0 iff every selected run passes the PA-MPJPE gate.

`--self-test` needs no real assets: it fabricates a reference-layout
release (a 6890-vertex SMPL pkl, full-width .pth.tar checkpoints from the
port's seeded modules, eval DBs written with plain pickle, which joblib
also reads) and runs the same convert -> evaluate -> gate flow on one run
of each eval dataset.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import os.path as osp
import pickle
import shutil
import sys
import time
from types import SimpleNamespace
from typing import Iterator, Sequence

import numpy as np
import torch

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))

# The six reproduction runs (BASELINE.md "Reproduction commands") with the
# expected metrics transcribed from the reference README's result tables
# (BASELINE.md Tables 1-2; all mm, lower is better).
RUNS = [
    {"dataset": "3dpw", "title": "repr_wpw_3dpw_model",
     "expected": {"pa_mpjpe": 52.3, "mpjpe": 84.6, "mpvpe": 100.3,
                  "accel_err": 11.4}},
    {"dataset": "3dpw", "title": "repr_wopw_3dpw_model",
     "expected": {"pa_mpjpe": 56.1, "mpjpe": 93.9, "mpvpe": 115.9,
                  "accel_err": 11.7}},
    {"dataset": "h36m", "title": "repr_wpw_h36m_mpii3d_model",
     "expected": {"pa_mpjpe": 47.1, "mpjpe": 68.6, "accel_err": 12.1}},
    {"dataset": "h36m", "title": "repr_wopw_h36m_model",
     "expected": {"pa_mpjpe": 41.2, "mpjpe": 61.6, "accel_err": 12.0}},
    {"dataset": "mpii3d", "title": "repr_wpw_h36m_mpii3d_model",
     "expected": {"pa_mpjpe": 63.1, "mpjpe": 96.2, "accel_err": 16.7}},
    {"dataset": "mpii3d", "title": "repr_wopw_mpii3d_model",
     "expected": {"pa_mpjpe": 62.9, "mpjpe": 99.5, "accel_err": 17.2}},
]

# one run per eval-dataset branch (3dpw's MPVPE, h36m's J14 regression,
# mpii3d's validity mask); the other three runs take the same code paths
SELFTEST_KEYS = ("3dpw:repr_wpw_3dpw_model", "h36m:repr_wopw_h36m_model",
                 "mpii3d:repr_wopw_mpii3d_model")


def _run_key(run) -> str:
    return f"{run['dataset']}:{run['title']}"


def select_runs(keys: Sequence[str]) -> list:
    bad = set(keys) - {_run_key(r) for r in RUNS}
    if bad:
        raise ValueError(f"unknown runs {sorted(bad)}")
    return [r for r in RUNS if _run_key(r) in set(keys)]


@contextlib.contextmanager
def _point_data_dirs(base_data: str, db_dir: str) -> Iterator[None]:
    """Point the port's data directories at the workdir: the environment
    (read by `config` at import, so by subprocesses) and the module
    constants already imported (`config` and `data.db`); all are restored
    on exit."""
    import tepose_tpu_torch.config as C
    import tepose_tpu_torch.data.db as db_mod

    env = {k: os.environ.get(k) for k in ("TEPOSE_BASE_DATA_DIR",
                                          "TEPOSE_DB_DIR")}
    saved = (C.BASE_DATA_DIR, C.TePose_DB_DIR, db_mod.TePose_DB_DIR)
    os.environ["TEPOSE_BASE_DATA_DIR"] = base_data
    os.environ["TEPOSE_DB_DIR"] = db_dir
    C.BASE_DATA_DIR, C.TePose_DB_DIR, db_mod.TePose_DB_DIR = (
        base_data, db_dir, db_dir)
    try:
        yield
    finally:
        C.BASE_DATA_DIR, C.TePose_DB_DIR, db_mod.TePose_DB_DIR = saved
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _config(title: str):
    from tepose_tpu_torch.config import update_cfg

    return update_cfg(osp.join(REPO, "configs", f"{title}.yaml"))


def _ckpt_npz_name(title: str) -> str:
    """The converted checkpoint's file name a config expects, from the
    config itself (configs/*.yaml TRAIN.PRETRAINED)."""
    return osp.basename(_config(title).TRAIN.PRETRAINED)


def convert_assets(args, workdir: str, titles) -> dict:
    """Convert the release's torch and pkl assets into the workdir layout
    evaluate reads (base_data/ and pretrained_models/). Returns title ->
    converted checkpoint path."""
    from tepose_tpu_torch.convert_checkpoint import convert_forward
    from tepose_tpu_torch.convert_smpl import convert as convert_smpl

    base = osp.join(workdir, "base_data")
    pret = osp.join(workdir, "pretrained_models")
    os.makedirs(base, exist_ok=True)
    os.makedirs(pret, exist_ok=True)

    print("== converting assets ==")
    convert_smpl(args.smpl, osp.join(base, "smpl_neutral.npz"),
                 args.j_regressor_extra)
    shutil.copyfile(args.j_regressor_h36m,
                    osp.join(base, "J_regressor_h36m.npy"))
    convert_forward(args.vibe, osp.join(base, "vibe_wo_3dpw.npz"),
                    kind="vibe")
    out = {}
    for title in titles:
        npz_name = _ckpt_npz_name(title)
        src = osp.join(args.ckpt_dir, npz_name.replace(".npz", ".pth.tar"))
        if not osp.isfile(src):
            raise FileNotFoundError(
                f"{src} not found — expected the released checkpoint for "
                f"{title} under --ckpt-dir (named after the config's "
                f"TRAIN.PRETRAINED with a .pth.tar suffix)")
        dst = osp.join(pret, npz_name)
        convert_forward(src, dst, kind="tepose")
        out[title] = dst
    return out


def evaluate_run(run, ckpt_path: str, device, eval_batch=None,
                 eval_bucket=None) -> dict:
    """One BASELINE.md reproduction evaluation through `evaluate.run_eval`
    (strict float32); returns its metrics (mm)."""
    from tepose_tpu_torch.evaluate import run_eval

    cfg = _config(run["title"])
    cfg.TRAIN.PRETRAINED = ckpt_path
    ns = SimpleNamespace(dataset=run["dataset"], seq="", render=False,
                         render_plain=False, filter=False, plot=False,
                         frame=0, eval_batch=eval_batch,
                         eval_bucket=eval_bucket)
    return run_eval(cfg, ns, synthetic=False, device=device)


def check_run(run, res: dict, tol_pa: float, tol_other: float):
    """Gate a run's measured metrics against its expected table row.
    Pass/fail rides on PA-MPJPE alone; the other metrics carry
    informational within-tolerance flags."""
    rows = {}
    ok = True
    for k, exp in run["expected"].items():
        got = res.get(k)
        tol = tol_pa if k == "pa_mpjpe" else tol_other
        within = got is not None and abs(got - exp) <= tol
        rows[k] = {"expected": exp, "measured": got, "tol": tol,
                   "within": bool(within)}
        if k == "pa_mpjpe" and not within:
            ok = False
    return ok, rows


def verify(args, runs, device) -> dict:
    """Convert the assets named in `args` and gate each run on `device`."""
    workdir = args.workdir or osp.join(REPO, "verify_release_work")
    os.makedirs(workdir, exist_ok=True)
    report = {"runs": {}, "tol_pa": args.tol_pa, "tol_other": args.tol_other,
              "workdir": workdir, "device": str(device), "time": time.time()}
    all_ok = True
    with _point_data_dirs(osp.join(workdir, "base_data"), args.db_dir):
        ckpts = convert_assets(args, workdir,
                               sorted({r["title"] for r in runs}))
        for run in runs:
            key = _run_key(run)
            print(f"\n== evaluate {key} ==")
            res = evaluate_run(run, ckpts[run["title"]], device,
                               eval_batch=args.eval_batch,
                               eval_bucket=args.eval_bucket)
            ok, rows = check_run(run, res, args.tol_pa, args.tol_other)
            all_ok &= ok
            report["runs"][key] = {"pass": ok, "metrics": rows,
                                   "raw": {k: float(v)
                                           for k, v in res.items()}}
            pa = rows["pa_mpjpe"]
            print(f"{'PASS' if ok else 'FAIL'} {key}: PA-MPJPE "
                  f"{pa['measured']:.4f} vs {pa['expected']} (tol "
                  f"{pa['tol']} mm)")
            for k, row in rows.items():
                if k != "pa_mpjpe" and not row["within"]:
                    print(f"  note: {k} {row['measured']:.4f} vs "
                          f"{row['expected']} outside ±{row['tol']} mm "
                          "(informational)")
    report["pass"] = bool(all_ok)
    return report


# ---------------------------------------------------------------------------
# Self-test: a fabricated reference-layout release through the same flow
# ---------------------------------------------------------------------------


def _fabricate_smpl_pkl(dirpath: str):
    """A full-size (6890-vertex) SMPL pickle in the official layout, the
    port's synthetic model in numbers, and SPIN's two extra regressors."""
    from tepose_tpu_torch.models.smpl import synthetic_smpl_model

    m = synthetic_smpl_model(seed=0)
    V = m.num_verts
    posedirs = m.posedirs.numpy()                 # ours: (207, V*3)
    parents = np.asarray(m.parents, np.int64)
    kintree = np.stack([parents, np.arange(24, dtype=np.int64)])
    kintree[0, 0] = 2 ** 32 - 1                   # official root marker
    idx = np.arange(V - 2)
    faces = np.stack([idx, idx + 1, idx + 2], 1)[::7].astype(np.int32)
    data = {
        "v_template": m.v_template.numpy(),
        "shapedirs": m.shapedirs.numpy(),
        "posedirs": posedirs.T.reshape(V, 3, 207),
        "J_regressor": m.j_regressor.numpy(),
        "weights": m.lbs_weights.numpy(),
        "kintree_table": kintree,
        "f": faces,
    }
    pkl = osp.join(dirpath, "SMPL_NEUTRAL.pkl")
    with open(pkl, "wb") as f:
        pickle.dump(data, f)
    jre = osp.join(dirpath, "J_regressor_extra.npy")
    np.save(jre, m.j_regressor_extra.numpy())
    rs = np.random.RandomState(7)
    jh = (rs.rand(17, V) ** 8).astype(np.float32)
    jh /= jh.sum(1, keepdims=True)
    jh36m = osp.join(dirpath, "J_regressor_h36m.npy")
    np.save(jh36m, jh)
    return pkl, jre, jh36m


def _save_reference_ckpt(module: torch.nn.Module, path: str,
                         performance: float) -> None:
    """A generator's weights as the reference trainer saves them."""
    from tepose_tpu_torch.train.checkpoint import export_torch_generator
    from tepose_tpu_torch.weights import jax_tree_from_state_dict

    sd = {k: torch.from_numpy(np.array(v)) for k, v in export_torch_generator(
        jax_tree_from_state_dict(module.state_dict())).items()}
    torch.save({"gen_state_dict": sd, "performance": performance,
                "epoch": 30}, path)


def _fabricate_checkpoints(dirpath: str, titles) -> str:
    """Reference-layout .pth.tar checkpoints of the configs' full widths,
    from the port's modules drawn from seeded generators; returns the VIBE
    checkpoint's path."""
    from tepose_tpu_torch.models.tepose import (
        TePose, TePoseConfig, Vibe, VibeConfig)

    for i, title in enumerate(titles):
        cfg = _config(title)
        mcfg = TePoseConfig(seqlen=cfg.DATASET.SEQLEN,
                            n_layers=cfg.MODEL.TGRU.NUM_LAYERS,
                            hidden_size=cfg.MODEL.TGRU.HIDDEN_SIZE)
        gen = TePose(mcfg, generator=torch.Generator().manual_seed(10 + i),
                     device="cpu")
        _save_reference_ckpt(gen, osp.join(dirpath, _ckpt_npz_name(
            title).replace(".npz", ".pth.tar")), performance=52.3)
    vibe = Vibe(VibeConfig(seqlen=16, n_layers=2, hidden_size=1024,
                           add_linear=True),
                generator=torch.Generator().manual_seed(99), device="cpu")
    vibe_path = osp.join(dirpath, "vibe_model_wo_3dpw.pth.tar")
    _save_reference_ckpt(vibe, vibe_path, performance=56.5)
    return vibe_path


def _fabricate_eval_dbs(db_dir: str, runs) -> None:
    """Eval DBs in the reference's preprocessed layout (flat frame-major
    arrays and a per-frame vid_name) for every DB the runs read, written
    by `data.db.write_db` (plain pickles)."""
    from tepose_tpu_torch.data.db import eval_db_paths, write_db

    os.makedirs(db_dir, exist_ok=True)
    made = set()
    for run in runs:
        db_file, pse_file = eval_db_paths(run["dataset"], run["title"],
                                          db_dir=db_dir)
        if db_file in made:
            continue
        made.add(db_file)
        rs = np.random.RandomState(len(made))
        names = []
        for v in range(3):
            names += [f"fab_{run['dataset']}_vid{v}"] * int(rs.randint(36, 60))
        N = len(names)
        db = {
            "vid_name": np.array(names),
            "features": (rs.randn(N, 2048) * 0.1).astype(np.float32),
            "joints3D": (rs.randn(N, 49, 3) * 0.2).astype(np.float32),
            "bbox": np.tile([120.0, 120, 80, 80], (N, 1)).astype(np.float32),
        }
        if run["dataset"] == "mpii3d":
            valid_i = np.ones((N, 1), np.int64)
            valid_i[5:8] = 0  # exercise the validity mask
            db["valid_i"] = valid_i
        else:
            db["pose"] = (rs.randn(N, 72) * 0.2).astype(np.float32)
            db["shape"] = (rs.randn(N, 10) * 0.2).astype(np.float32)
        pse = np.concatenate([np.tile([1.0, 0, 0], (N, 1)),
                              rs.randn(N, 82) * 0.1], axis=1).astype(np.float32)
        write_db(db, db_file)
        write_db(pse, pse_file)


def fabricate_release(dirpath: str, runs, tol_pa: float = 0.1,
                      tol_other: float = 0.15) -> SimpleNamespace:
    """A complete reference-layout release for `runs` under `dirpath`;
    returns the arguments `verify` takes for it, with the small eval
    buckets of the fabricated videos (under 60 frames each)."""
    os.makedirs(dirpath, exist_ok=True)
    print("== fabricating reference-layout release assets ==")
    smpl_pkl, jre, jh36m = _fabricate_smpl_pkl(dirpath)
    vibe = _fabricate_checkpoints(dirpath, sorted({r["title"] for r in runs}))
    db_dir = osp.join(dirpath, "preprocessed_data")
    _fabricate_eval_dbs(db_dir, runs)
    return SimpleNamespace(
        ckpt_dir=dirpath, vibe=vibe, smpl=smpl_pkl, j_regressor_extra=jre,
        j_regressor_h36m=jh36m, db_dir=db_dir, workdir="", tol_pa=tol_pa,
        tol_other=tol_other, eval_batch=4, eval_bucket=32)


def self_test(device, keys: Sequence[str] = SELFTEST_KEYS,
              workdir: str = "", tol_pa: float = 0.1,
              tol_other: float = 0.15) -> dict:
    """Fabricate a release, run the convert -> evaluate -> gate flow on
    `device` for the runs `keys`, then check the gate both ways. Random
    weights cannot reproduce the paper's tables, so every measured metric
    must be finite and every run must fail its table gate; the gate must
    pass the measured numbers themselves and fail them shifted by 1 mm."""
    workdir = workdir or osp.join(REPO, "verify_release_selftest")
    shutil.rmtree(workdir, ignore_errors=True)
    runs = select_runs(keys)
    args = fabricate_release(osp.join(workdir, "fabricated"), runs, tol_pa,
                             tol_other)
    args.workdir = workdir
    report = verify(args, runs, device)

    for key, rr in report["runs"].items():
        for k, row in rr["metrics"].items():
            if row["measured"] is None or not np.isfinite(row["measured"]):
                raise RuntimeError(f"{key}: {k} is not finite: {row}")
        if rr["pass"]:
            raise RuntimeError(f"{key} passed the paper's gate with random "
                               "weights")
    run0 = dict(runs[0])
    measured = {k: report["runs"][_run_key(run0)]["metrics"][k]["measured"]
                for k in run0["expected"]}
    run0["expected"] = measured
    if not check_run(run0, measured, tol_pa, tol_other)[0]:
        raise RuntimeError("the gate rejected exact-match metrics")
    shifted = dict(measured, pa_mpjpe=measured["pa_mpjpe"] + 1.0)
    if check_run(run0, shifted, tol_pa, tol_other)[0]:
        raise RuntimeError("the gate accepted a 1 mm PA-MPJPE deviation")
    report["self_test"] = "ok"
    print(f"\nself-test OK: convert→evaluate→gate flow ran end to end on "
          f"{len(runs)} fabricated runs on {device}; gating verified both "
          "directions")
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ckpt-dir", help="dir of released tepose_*_test.pth.tar")
    ap.add_argument("--vibe", help="released VIBE checkpoint "
                                   "(vibe_model_wo_3dpw.pth.tar)")
    ap.add_argument("--smpl", help="licensed SMPL neutral .pkl")
    ap.add_argument("--j-regressor-extra", help="SPIN J_regressor_extra.npy")
    ap.add_argument("--j-regressor-h36m", help="SPIN J_regressor_h36m.npy")
    ap.add_argument("--db-dir", help="preprocessed eval DB dir "
                                     "(*_db.pt / *_pseudotheta.pt)")
    ap.add_argument("--workdir", default="",
                    help="where converted assets land (reused across runs)")
    ap.add_argument("--only", action="append", default=[],
                    help="restrict to dataset:title runs (repeatable); "
                         f"choices: {[_run_key(r) for r in RUNS]}")
    ap.add_argument("--tol-pa", type=float, default=0.1,
                    help="PA-MPJPE pass gate in mm (BASELINE.md north star)")
    ap.add_argument("--tol-other", type=float, default=0.15,
                    help="informational tolerance for the other table "
                         "metrics (the tables round to 0.1 mm)")
    ap.add_argument("--eval-batch", type=int, default=None)
    ap.add_argument("--eval-bucket", type=int, default=None)
    ap.add_argument("--gpu", default="0",
                    help="CUDA device index to run on, or 'cpu'")
    ap.add_argument("--report", default="", help="write the JSON report here")
    ap.add_argument("--self-test", action="store_true",
                    help="fabricate reference-layout assets and verify the "
                         "whole flow without real data")
    args = ap.parse_args(argv)
    from tepose_tpu_torch.config import gpu_device

    device = gpu_device(args.gpu)

    if args.self_test:
        report = self_test(device, args.only or SELFTEST_KEYS, args.workdir,
                           args.tol_pa, args.tol_other)
    else:
        missing = [f for f in ("ckpt_dir", "vibe", "smpl",
                               "j_regressor_extra", "j_regressor_h36m",
                               "db_dir") if not getattr(args, f)]
        if missing:
            ap.error("missing required inputs: "
                     + ", ".join("--" + m.replace("_", "-") for m in missing)
                     + " (or run --self-test)")
        try:
            runs = select_runs(args.only) if args.only else RUNS
        except ValueError as e:
            ap.error(str(e))
        report = verify(args, runs, device)

    if args.report:
        with open(args.report, "w") as f:
            json.dump(report, f, indent=2)
        print(f"report written to {args.report}")
    if not args.self_test:
        print("\n== RELEASE VERIFICATION "
              + ("PASSED" if report["pass"] else "FAILED") + " ==")
    return 0 if (args.self_test or report["pass"]) else 1


if __name__ == "__main__":
    sys.exit(main())
