"""The port's benchmark commands, `python -m tepose_tpu_torch.bench` and
`python -m tepose_tpu_torch.bench_notes`, at a tiny width on the CPU.

The bench's scans against JAX's `fast_stream_scan` on the same weights and
features; one whole tiny bench run through `bench.main` (its one strict
JSON line, every key of `bench.py`'s extra kept or in the rename table);
the MFU arithmetic over the H100's peaks on fixed times; a failing tier or
a non-finite figure raising before any line; `bench_notes` stages on the
CPU. TePose 1 x 16 GRUs, VIBE 1 x 16, 64 vertices, B = 2, T = 12, 64 x 64
crops; the discriminator keeps its full widths.
"""

import ast
import contextlib
import copy
import io
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tepose_tpu.models.smpl import synthetic_smpl_model as jax_smpl
from tepose_tpu.models.tepose import TePoseConfig as JaxTePoseConfig
from tepose_tpu.models.tepose import tepose_init
from tepose_tpu.streaming.fast_scan import fast_stream_scan as jax_scan
from tepose_tpu_torch import bench, bench_notes
from tepose_tpu_torch.models.smpl import synthetic_smpl_model
from tepose_tpu_torch.models.tepose import TePose, TePoseConfig, VibeConfig
from tepose_tpu_torch.weights import state_dict_from_jax_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H100 = "NVIDIA H100 80GB HBM3"
FAST_ATOL = 1e-5   # test_torch_fast_encoder.py: the fast scan against JAX's
SCAN_ATOL = 5e-4   # and the plain loop against the fast scan

TINY_MODEL = bench.BenchModel(TePoseConfig(6, 1, 16),
                              VibeConfig(n_layers=1, hidden_size=16), 64)
TINY_SHAPES = bench.BenchShapes(
    streams=2, frames=12, e2e_streams=2, e2e_frames=12, crop_size=64,
    train_vidlen=12, train_tiers=(
        bench.TrainTier("f32", 2, 2, 2, None),
        bench.TrainTier("bf16", 2, 2, 2, "bfloat16"),
        bench.TrainTier("fast", 2, 3, 2, "bfloat16")))
TINY_REPS = bench.Reps(scan=2, e2e=1, e2e_device=1, train=1, burn=1,
                       train_burn=0)
TINY = dict(model=TINY_MODEL, shapes=TINY_SHAPES, reps=TINY_REPS)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs six workers on this host's
    cores, and these tests' small ops gain nothing from more."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def tiny_run():
    """One `bench.main(["--gpu", "cpu"])` at tiny width: its stdout and the
    raw measurements it summarised."""
    raws = []
    real = bench.measure

    def keep(*args, **kwargs):
        raws.append(real(*args, **kwargs))
        return raws[-1]

    mp = pytest.MonkeyPatch()
    mp.setattr(bench, "measure", keep)
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            bench.main(["--gpu", "cpu"], **TINY)
    finally:
        mp.undo()
    return out.getvalue(), raws[0]


def _strict_json(line: str):
    def refuse(token):
        raise ValueError(f"non-strict JSON token {token}")
    return json.loads(line, parse_constant=refuse)


def test_scan_thetas_match_jax():
    """The bench's fast and plain scans, on JAX's weights, against JAX's
    fast_stream_scan over the same features and ring."""
    jcfg = JaxTePoseConfig(seqlen=6, n_layers=1, hidden_size=16)
    jgen = jax.device_get(tepose_init(jax.random.PRNGKey(0), jcfg))
    gen = TePose(TINY_MODEL.tepose, generator=torch.Generator().manual_seed(0),
                 device="cpu")
    gen.load_state_dict(state_dict_from_jax_tree(jgen), strict=True)
    smpl = synthetic_smpl_model(0, 64)
    got = bench.measure_window_scans(gen.eval(), smpl, TINY_SHAPES,
                                     TINY_REPS, "cpu")
    feats, theta0 = bench.scan_inputs(2, 12, 6, "cpu")
    W = got["windows"]
    assert W == 12 - 6 + 1
    want = np.asarray(jax_scan(jgen, jax_smpl(0, 64), jnp.asarray(
        feats.numpy()), jnp.asarray(theta0.numpy()), jcfg, W,
        outputs=("theta",))["theta"])
    assert want.shape == (2, W, 85)
    np.testing.assert_allclose(got["theta"]["fast"].numpy(), want,
                               atol=FAST_ATOL, rtol=0)
    np.testing.assert_allclose(got["theta"]["plain"].numpy(), want,
                               atol=SCAN_ATOL, rtol=0)
    assert set(got["seconds"]) == {f"{s}_{t}" for s in ("plain", "fast")
                                   for t in bench.SCAN_TIERS}
    assert all(len(v) == TINY_REPS.scan for v in got["seconds"].values())


def test_main_prints_one_strict_json_line(tiny_run):
    out, _ = tiny_run
    lines = out.strip().splitlines()
    line = _strict_json(lines[-1])
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "extra"}
    assert line["metric"] == "streaming_fps_per_chip"
    extra = line["extra"]
    assert line["value"] == max(extra["windows_scan_plain_fps"],
                                extra["windows_scan_fast_fps"]) > 0
    assert line["vs_baseline"] == round(
        line["value"] / bench.BASELINE_TARGET_FPS, 2)
    assert extra["card"] == "cpu" and extra["device"] == "cpu"
    bench.check_finite(line, allow_none=True)
    # on the CPU only what needs the card is null
    nulls = {k for k, v in extra.items() if v is None}
    assert nulls == {"sm_clock_mhz_start", "sm_clock_mhz_end",
                     "e2e_device_mfu", "windows_scan_mfu", "train_mfu",
                     "train_bf16_mfu", "train_fast_mfu",
                     "host_to_device_MB_per_sec"}
    assert set(extra["lbs_launches"]) == {"bench_scan_plain",
                                          "bench_scan_fast", "bench_e2e"}


def _jax_bench_extra_keys():
    """The keys of `bench.py`'s `extra` dict, read with ast (importing
    bench.py would turn on JAX's persistent compile cache)."""
    tree = ast.parse(open(os.path.join(REPO, "bench.py")).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            for k, v in zip(node.keys, node.values):
                if isinstance(k, ast.Constant) and k.value == "extra":
                    return [kk.value for kk in v.keys]
    raise AssertionError("no extra dict in bench.py")


def test_every_jax_extra_key_is_kept_or_renamed(tiny_run):
    extra = _strict_json(tiny_run[0].strip().splitlines()[-1])["extra"]
    keys = _jax_bench_extra_keys()
    assert len(keys) == 35
    for key in keys:
        if key in bench.RENAMED_EXTRA:
            new = bench.RENAMED_EXTRA[key]
            assert new is None or new in extra, key
            assert key in bench.__doc__, key
        else:
            assert key in extra, key
    assert set(bench.RENAMED_EXTRA) <= set(keys)


def test_every_jax_stage_is_ported():
    tree = ast.parse(open(os.path.join(REPO, "tools", "bench_notes.py"))
                     .read())
    stages = default = None
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign)
                and getattr(node.targets[0], "id", None) == "STAGES"):
            stages = ast.literal_eval(node.value)
        if (isinstance(node, ast.Call) and node.args
                and isinstance(node.args[0], ast.Constant)
                and node.args[0].value == "--stages"):
            default = next(k.value.value for k in node.keywords
                           if k.arg == "default")
    assert stages == bench_notes.STAGES
    assert default == bench_notes.DEFAULT_STAGES


def test_mfu_over_the_h100_peaks(tiny_run):
    """MFU = the port's FLOPs over the H100 SXM's dense peak of the tier
    timed, on fixed times."""
    from tepose_tpu_torch.utils.flops import peak_flops_for

    raw = copy.deepcopy(tiny_run[1])
    raw["card"]["kind"] = H100
    sc, e2e, tr = raw["scans"], raw["e2e"], raw["train"]
    for k in sc["seconds"]:
        sc["seconds"][k] = [1e-5, 2e-5, 1e-5]
    e2e["seconds"]["device"] = [2e-5]
    for name, t in (("f32", 1e-3), ("bf16", 4e-5), ("fast", 5e-5)):
        tr[name]["seconds"] = [t]
    extra = bench.summarize(TINY_MODEL, TINY_SHAPES, raw)["extra"]
    f32, bf16 = (peak_flops_for(H100, d) for d in ("float32", "bfloat16"))
    assert (f32, bf16) == (67e12, 989.5e12)
    assert extra["peak_flops_assumed"] == {
        "float32": f32, "tf32": 494.5e12, "bfloat16": bf16}
    fps = TINY_SHAPES.streams * sc["windows"] / 1e-5
    assert extra["windows_scan_fast_fps"] == pytest.approx(fps, abs=0.05)
    assert extra["windows_scan_fast_fps_spread"] == pytest.approx(
        [fps / 2, fps], abs=0.05)
    assert extra["windows_scan_mfu"] == pytest.approx(
        fps * bench.scan_window_flops(TINY_MODEL) / f32, abs=5e-5)
    frame_flops = bench.FL.streaming_flops_per_call(
        2, 12, 6, 1, 16, 64, 64) / e2e["frames"]
    assert extra["e2e_device_mfu"] == pytest.approx(
        e2e["frames"] / 2e-5 * frame_flops / f32, abs=5e-5)
    for key, name, t, peak in (("train_mfu", "f32", 1e-3, f32),
                               ("train_bf16_mfu", "bf16", 4e-5, bf16),
                               ("train_fast_mfu", "fast", 5e-5, bf16)):
        want = tr[name]["iter_flops"] * tr[name]["iters"] / t / peak
        assert 0.01 < want < 10
        assert extra[key] == pytest.approx(want, abs=5e-5), key


def test_failing_tier_raises_before_any_line(tiny_run, monkeypatch, capsys):
    """No tier's failure is caught: main raises (a non-zero exit) and
    prints nothing."""
    raw = tiny_run[1]
    monkeypatch.setattr(bench, "measure_window_scans",
                        lambda *a, **k: raw["scans"])
    monkeypatch.setattr(bench, "measure_end_to_end",
                        lambda *a, **k: raw["e2e"])
    real = bench.train_segment

    def segment(*args, **kwargs):
        if args[5].compute_dtype == "bfloat16":
            raise RuntimeError("bf16 tier failed")
        return real(*args, **kwargs)

    monkeypatch.setattr(bench, "train_segment", segment)
    with pytest.raises(RuntimeError, match="bf16 tier failed"):
        bench.main(["--gpu", "cpu"], **TINY)
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("where", ["figure", "training_metrics",
                                   "scan_thetas"])
def test_non_finite_raises_before_any_line(tiny_run, monkeypatch, capsys,
                                           where):
    raw = copy.deepcopy(tiny_run[1])
    if where == "figure":
        raw["scans"]["seconds"]["fast_float32"] = [float("nan")]
        monkeypatch.setattr(bench, "measure", lambda *a, **k: raw)
        with pytest.raises(ValueError, match="windows_scan_fast_fps"):
            bench.main(["--gpu", "cpu"], **TINY)
    elif where == "training_metrics":
        real = bench.train_segment

        def segment(*args, **kwargs):
            out = real(*args, **kwargs)
            return dict(out, gen_loss=float("inf"))

        monkeypatch.setattr(bench, "train_segment", segment)
        with pytest.raises(RuntimeError, match="non-finite training"):
            bench.measure_training_tiers(TINY_MODEL, TINY_SHAPES, TINY_REPS,
                                         "cpu")
    else:
        gen, smpl = bench.setup(TINY_MODEL, "cpu")
        with torch.no_grad():
            gen.regressor.init_cam.fill_(float("nan"))
        with pytest.raises(RuntimeError, match="non-finite"):
            bench.measure_window_scans(gen, smpl, TINY_SHAPES, TINY_REPS,
                                       "cpu")
    assert capsys.readouterr().out == ""


def test_check_finite_rejects_nulls_on_the_card():
    bench.check_finite({"a": [1.0, None]}, allow_none=True)
    with pytest.raises(ValueError, match=r"\.a\[1\] is null"):
        bench.check_finite({"a": [1.0, None]}, allow_none=False)
    with pytest.raises(ValueError, match="inf"):
        bench.check_finite({"b": {"c": math.inf}}, allow_none=True)


def test_bench_modules_import_only_torch_numpy_and_the_port():
    """Nothing of JAX, the JAX package or tools/ (test_never_imports_jax
    imports them with JAX blocked)."""
    allowed = {"__future__", "argparse", "contextlib", "dataclasses", "json",
               "math", "subprocess", "time", "typing", "numpy", "torch",
               "tepose_tpu_torch"}
    for mod in (bench, bench_notes):
        tree = ast.parse(open(mod.__file__).read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module] if isinstance(node, ast.ImportFrom)
                     else [])
            for name in names:
                assert name.split(".")[0] in allowed, (mod.__name__, name)


@pytest.mark.parametrize("profile", [False, True])
def test_bench_notes_render_on_cpu(capsys, tmp_path, profile):
    flags = ["--profile", str(tmp_path)] if profile else []
    out = bench_notes.main(["--stages", "render", "--gpu", "cpu"] + flags)
    text = capsys.readouterr().out
    printed = _strict_json(text[text.index("\n{") + 1 if profile else 0:])
    assert printed == json.loads(json.dumps(out))
    if profile:   # utils.profiling.trace wrote the run's trace
        (trace,) = tmp_path.glob("*.pt.trace.json")
        assert trace.stat().st_size > 0
    r = printed["render_benchmark"]
    assert r["mesh"] == "6889 verts / 13612 faces, 1080p"
    for label in ("small_person", "typical_person", "frame_filling_person",
                  "typical_2people", "typical_4people"):
        assert r[f"native_{label}_ms"] > 0
        assert r[f"native_{label}_fps"] == pytest.approx(
            1e3 / r[f"native_{label}_ms"])
    assert printed["card"]["card"] == "cpu"


def test_bench_notes_sphere_matches_the_jax_tool():
    """The vectorised mesh equals the JAX tool's loop."""
    verts, faces = bench_notes.sphere_mesh(5, 7)
    want = []
    for i in range(4):
        for j in range(7):
            a, b = i * 7 + j, i * 7 + (j + 1) % 7
            c, d = (i + 1) * 7 + j, (i + 1) * 7 + (j + 1) % 7
            want += [[a, b, c], [b, d, c]]
    np.testing.assert_array_equal(faces, want)
    assert verts.shape == (35, 3) and verts.dtype == np.float32


def test_bench_notes_device_stages_on_cpu_tiny():
    """The stage, chunk and training breakdown stages run end to end at
    tiny width (their device figures are null without a card)."""
    st = bench_notes.stage_breakdown(TINY_MODEL, n_streams=2, frames=12,
                                     crop_size=64, reps=1, device="cpu")
    assert st["backbone_24_crops_s"] > 0 and st["scan_theta_only_s"] > 0
    assert st["scan_full_outputs_idle_share"] is None
    ch = bench_notes.backbone_chunk_sweep((4, 8), n_crops=8, crop_size=64,
                                          reps=1, model=TINY_MODEL,
                                          device="cpu")
    assert set(ch) == {"chunk4", "chunk8"} and min(ch.values()) > 0
    br = bench_notes.train_time_breakdown(
        bench_notes._hp(2, 2), with_disc_ablation=True, num_iters=2,
        vidlen=12, reps=1, burn=0, model=TINY_MODEL, device="cpu")
    assert br["full_ms_per_iter"] > 0
    assert set(br["wps"]) == {"forward", "grad", "full", "forward_nodisc",
                              "grad_nodisc"}
    bench.check_finite([st, ch, br], allow_none=True)


def test_bench_notes_rejects_unknown_stages():
    with pytest.raises(SystemExit):
        bench_notes.main(["--stages", "render,nope", "--gpu", "cpu"])
