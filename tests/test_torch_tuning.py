"""The eval tuning tools of the port and evaluate's batching plan.

`evaluate.plan_eval_batches` with a bucket against the JAX CLI's chunking,
written out below from `evaluate.py:164-214` (recording what the JAX
`run_eval` hands `make_packed_eval_scan` would compile JAX programs): the
same chunks and lengths, each with its own rows where the JAX CLI pads to
a power of two; without a bucket, chunks of the length-sorted videos padded
to their longest; `run_eval`'s per-video joints and MPVPE across three
plans (within 1e-6 m: rows are independent); `python -m tepose_tpu_torch.tune_eval_batching`
and `python -m tepose_tpu_torch.precision_sweep` on the CPU at tiny width
(TePose and VIBE 1 x 16, 64 vertices) writing their JSON schemas, the
float32 tier within 0.1 mm of float64; and `evaluate.EVAL_BATCHING`
against the best rows of the committed sweep. No JAX program is built.
"""

import argparse
import json
import os

import numpy as np
import pytest
import torch

from tepose_tpu_torch import evaluate as E
from tepose_tpu_torch import precision_sweep as PS
from tepose_tpu_torch import tune_eval_batching as TB
from tepose_tpu_torch.models.smpl import synthetic_smpl_model
from tepose_tpu_torch.models.tepose import (
    TePose, TePoseConfig, Vibe, VibeConfig)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S = 6


@pytest.fixture(autouse=True)
def two_threads():
    """Two intra-op threads: the suite runs six workers on this host's
    cores, and these tests' small ops gain nothing from more."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def jax_cli_chunks(lengths, S, bsz, MAX_B, devices=1):
    """The JAX CLI's bucketing and chunking (evaluate.py:164-214) as it
    stands there, yielding what each scan call gets: (T_pad, chunk, B)."""
    names = [n for n in lengths if lengths[n] >= S]
    bucket = lambda n: -(-lengths[n] // bsz) * bsz  # noqa: E731
    buckets = {}
    for n in names:
        buckets.setdefault(bucket(n), []).append(n)
    out = []
    for T_pad, vids in sorted(buckets.items()):
        for i in range(0, len(vids), MAX_B):
            chunk = vids[i:i + MAX_B]
            B = 1 << max(len(chunk) - 1, 0).bit_length()
            if devices > 1:
                B = max(B, -(-B // devices) * devices)
            out.append((T_pad, chunk, B))
    return out


def _length_sets():
    synth = {n: len(d["features"]) for n, d in E.synthetic_eval_data().items()}
    edges = {f"e{i}": n for i, n in enumerate(
        [3, 6, 7, 127, 128, 129, 256, 5, 128, 130, 255, 257, 1])}
    tdpw = dict(enumerate(int(x) for x in TB.video_lengths("3dpw", 1.0)))
    h36m = dict(enumerate(int(x) for x in TB.video_lengths("h36m", 0.5)))
    return {"synthetic": synth, "edges": edges, "3dpw": tdpw, "h36m": h36m}


@pytest.mark.parametrize("case,bsz,max_b,devices", [
    ("synthetic", 128, 32, 1), ("synthetic", 32, 2, 3),
    ("edges", 128, 2, 1), ("edges", 64, 3, 4),
    ("3dpw", 128, 32, 1), ("3dpw", 1024, 64, 2),
    ("h36m", 256, 8, 1), ("h36m", 512, 16, 8)])
def test_plan_with_bucket_reproduces_jax_cli(case, bsz, max_b, devices):
    lengths = _length_sets()[case]
    want = jax_cli_chunks(lengths, S, bsz, max_b, devices)
    got = E.plan_eval_batches(lengths, S, max_b, bsz, devices)
    # the same chunks and lengths; each chunk's own rows (a multiple of
    # devices) where the JAX CLI pads to the next power of two
    assert [(T, c) for T, c, _ in got] == [(T, c) for T, c, _ in want]
    for (_, c, B), (_, _, Bp) in zip(got, want):
        assert B == -(-len(c) // devices) * devices and B <= Bp


@pytest.mark.parametrize("case,max_b,devices", [
    ("synthetic", 2, 1), ("edges", 3, 4), ("edges", 100, 1),
    ("3dpw", 16, 1), ("h36m", 8, 2)])
def test_plan_pads_each_chunk_to_its_longest(case, max_b, devices):
    lengths = _length_sets()[case]
    plan = E.plan_eval_batches(lengths, S, max_b, n_devices=devices)
    names = [n for _, c, _ in plan for n in c]
    assert sorted(names, key=str) == sorted(
        (n for n, L in lengths.items() if L >= S), key=str)
    assert [lengths[n] for n in names] == sorted(lengths[n] for n in names)
    for T, c, B in plan:
        assert T == max(lengths[n] for n in c) and 0 < len(c) <= max_b
        assert B == -(-len(c) // devices) * devices
    # never more window steps than any bucket plan of the same MAX_B
    for bsz in (1, 16, 128, 1024):
        bucketed = E.plan_eval_batches(lengths, S, max_b, bsz, devices)
        assert (sum(T - S + 1 for T, _, _ in plan)
                <= sum(T - S + 1 for T, _, _ in bucketed))


def test_window_steps_of_the_plans():
    """The step counts on the tool's length models (seed 0), as worked out
    from the plans alone: the JAX defaults' buckets, and the chunks of the
    sorted videos at the same MAX_B."""
    for ds, (max_b, bsz), steps, sorted_steps in (
            ("3dpw", (32, 128), 18096, 2948), ("h36m", (8, 256), 51080,
                                               29051)):
        lengths = dict(enumerate(int(x) for x in TB.video_lengths(ds, 1.0)))
        for bucket, want in ((bsz, steps), (None, sorted_steps)):
            plan = E.plan_eval_batches(lengths, S, max_b, bucket)
            assert sum(T - S + 1 for T, _, _ in plan) == want


@pytest.fixture
def tiny_models(monkeypatch):
    """TePose and VIBE 1 x 16 with 64 vertices, for the CLIs and run_eval."""
    def models(device, smpl_seed=0):
        smpl = synthetic_smpl_model(smpl_seed, 64, device=device)
        gen = TePose(TePoseConfig(S, 1, 16),
                     generator=torch.Generator().manual_seed(0),
                     device=device).eval()
        vibe = Vibe(VibeConfig(16, 1, 16),
                    generator=torch.Generator().manual_seed(1),
                    device=device).eval()
        jreg = torch.as_tensor(E.synthetic_j_regressor(64), device=device)
        return smpl, gen, vibe, jreg

    monkeypatch.setattr(TB, "sweep_models", models)
    monkeypatch.setattr(E, "build_models",
                        lambda cfg, synthetic, device: models(device))
    return models


def test_run_eval_per_video_independent_of_plan(tiny_models, monkeypatch):
    from tepose_tpu_torch import config as TCFG

    synthetic_eval_data = E.synthetic_eval_data
    monkeypatch.setattr(
        E, "synthetic_eval_data",
        lambda: synthetic_eval_data(num_videos=3, min_len=14, max_len=30))
    cfg = TCFG.update_cfg(os.path.join(REPO, "configs",
                                       "repr_wopw_3dpw_model.yaml"))
    runs = []
    for batch, bucket in ((None, None), (2, 16), (1, 48)):
        args = argparse.Namespace(dataset="3dpw", seq="", render=False,
                                  render_plain=False, filter=False,
                                  plot=False, frame=0, eval_batch=batch,
                                  eval_bucket=bucket)
        videos = {}
        res = E.run_eval(cfg, args, synthetic=True, device="cpu",
                         per_video=videos)
        runs.append((res, videos))
    base, base_videos = runs[0]
    assert sorted(base_videos) == sorted(E.synthetic_eval_data())
    for res, videos in runs[1:]:
        for n, v in base_videos.items():
            for k in ("pred_j3d", "mpvpe"):
                assert videos[n][k].shape == v[k].shape
                np.testing.assert_allclose(videos[n][k], v[k], rtol=0,
                                           atol=1e-6, err_msg=(n, k))
        for k in ("mpjpe", "pa_mpjpe", "mpvpe", "accel_err"):
            assert res[k] == pytest.approx(base[k], abs=1e-3), k


def test_tuner_cli_on_cpu(tiny_models, tmp_path):
    out = tmp_path / "sweep.json"
    argv = ["--gpu", "cpu", "--scale", "0.05", "--max_len", "20",
            "--out", str(out)]
    # three videos: MAX_B 3 and 8 walk one shared plan (one chunk), and
    # bucket 24 pads them to 24 frames
    entry = TB.main(argv + ["--dataset", "3dpw", "--batches", "1", "3", "8",
                            "--bucket_sizes", "0", "24"])
    TB.main(argv + ["--dataset", "h36m", "--points", "B8_bucket24"])
    data = json.loads(out.read_text())
    assert set(data) == {"3dpw", "h36m", "_note"}
    assert data["3dpw"] == json.loads(json.dumps(entry))
    rows = data["3dpw"]["results"]
    assert data["3dpw"]["grid"] == ["B1", "B3", "B8", "B1_bucket24",
                                    "B3_bucket24", "B8_bucket24"]
    assert set(rows) == set(data["3dpw"]["grid"])
    assert data["3dpw"]["device"] == "cpu"
    assert data["3dpw"]["best"] == TB.best_row(rows)
    lengths = {f"vid_{i:03d}": int(n) for i, n in
               enumerate(TB.video_lengths("3dpw", 0.05, max_len=20))}
    for name, r in rows.items():
        plan = E.plan_eval_batches(lengths, S, r["max_batch"], r["bucket"])
        assert name == TB.point_name(r["max_batch"], r["bucket"])
        assert r["window_steps"] == sum(T - S + 1 for T, _, _ in plan)
        assert r["chunks"] == len(plan) and 0 < r["frame_fill"] <= 1
        assert len(r["useful_fps_by_pass"]) == 2 and r["useful_fps"] > 0
        assert r["steady_s"] >= 0 and r["peak_memory_gb"] is None
        assert r["lbs_launches"] == 0            # the plain CPU path
        if "same_plan_as" in r:
            assert rows[r["same_plan_as"]]["useful_fps"] == r["useful_fps"]
    assert rows["B8"]["same_plan_as"] == "B3"
    assert rows["B3"]["bucket"] is None and rows["B3"]["chunks"] == 1
    assert (rows["B3"]["frame_fill"] * max(lengths.values())
            == pytest.approx(rows["B3_bucket24"]["frame_fill"] * 24))
    assert list(data["h36m"]["results"]) == ["B8_bucket24"]
    with pytest.raises(SystemExit, match="not B<MAX_B>"):
        TB.main(["--gpu", "cpu", "--points", "B2_bucket64_pow2"])


def test_best_row_breaks_ties_on_memory():
    def row(fps, mem, b=8, bucket=128):
        return {"useful_fps": float(np.mean(fps)), "useful_fps_by_pass": fps,
                "peak_memory_gb": mem, "max_batch": b, "bucket": bucket}
    rows = {"fast": row([100, 90], 4.0), "tied": row([91, 80], 2.0),
            "slow": row([89, 85], 1.0)}
    assert TB.best_row(rows) == "tied"
    rows["tied"]["useful_fps_by_pass"] = [89, 80]
    assert TB.best_row(rows) == "fast"


def test_precision_sweep_cli_on_cpu(tiny_models, tmp_path, monkeypatch):
    monkeypatch.setattr(E, "EVAL_BATCHING", {"3dpw": 2, "long": 2})
    monkeypatch.setattr(PS, "SPEED_FRAMES", 16)
    monkeypatch.setattr(PS, "SCAN_SHAPE", (3, 12))
    monkeypatch.setattr(PS, "FULL_VIDLEN", 30)
    out = tmp_path / "precision.json"
    res = PS.main(["--gpu", "cpu", "--out", str(out), "--full-vidlen"])
    data = json.loads(out.read_text())
    assert data == json.loads(json.dumps(res))
    assert data["device"] == "cpu" and data["north_star_bar_mm"] == 0.1
    assert data["accuracy_shapes"] == {"S": 6, "F": 66, "B": 2,
                                       "windows": 61}
    full = data["full_vidlen_drift"]
    assert full["shapes"] == {"S": 6, "F": 30, "B": 1, "windows": 25}
    for acc in (data["accuracy_vs_f64_oracle"],
                full["accuracy_vs_f64_oracle"]):
        assert set(acc) == set(PS.TIERS)
        assert acc["float32"]["max_joint_dev_mm"] < 0.1
        assert acc["float32"]["max_mpvpe_dev_mm"] < 0.1
        assert all(np.isfinite(v) for d in acc.values() for v in d.values())
    assert set(data["eval_rollout_windows_per_sec"]) == set(PS.TIERS)
    assert data["eval_rollout_shape"] == {"B": 2, "T_pad": 16, "windows": 11}
    assert set(data["fast_scan_windows_per_sec"]) == set(PS.SCAN_TIERS)
    assert data["conclusion"].startswith("float32 meets the 0.1 mm bar")


def test_run_eval_defaults_equal_the_committed_sweep():
    """evaluate.EVAL_BATCHING holds each dataset's best row of the committed
    card sweep; both JSONs come from an H100 and name its power limit."""
    with open(TB.SWEEP_JSON) as f:
        sweep = json.load(f)
    for ds, key in (("3dpw", "3dpw"), ("h36m", "long")):
        entry = sweep[ds]
        assert "H100" in entry["device"] and " W" in entry["device"]
        assert entry["scale"] == 1.0
        best = TB.best_row(entry["results"])
        assert entry["best"] == best
        r = entry["results"][best]
        assert r["bucket"] is None and E.EVAL_BATCHING[key] == r["max_batch"]
        assert set(entry["results"]) == set(entry["grid"])
    with open(PS.OUT_JSON) as f:
        prec = json.load(f)
    assert "H100" in prec["device"]
    assert "full_vidlen_drift" in prec
    assert prec["eval_rollout_shape"]["B"] == E.EVAL_BATCHING["3dpw"]
    assert prec["conclusion"].endswith("evaluate's default: float32")
