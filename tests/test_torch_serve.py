"""Port parity of the serving path: `StreamingEngine`, `LiveSession`,
`StageTimer` and the serving golden.

The JAX engine and live session (tepose_tpu/streaming) and the port run on
the same JAX params, loaded into the port's modules with `strict=True`, and
the same numpy inputs, at the small size of tests/test_engine.py and
tests/test_live.py: TePose and VIBE 1 x 16, 64 vertices, 64 x 64 crops,
fp32 on the CPU. Bars: 1e-5 on the features path; rtol/atol 1e-4 where
crops go through the random He-init ResNet-50, whose features are in the
hundreds (kp_2d in the hundreds follows); live against the engine at
rtol 2e-4, atol 2e-5, the bar of tests/test_live.py.
"""

import copy
import inspect
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tepose_tpu.models.backbone import resnet50_init as jax_resnet50_init
from tepose_tpu.models.smpl import synthetic_smpl_model as jax_smpl
from tepose_tpu.models.tepose import (
    TePoseConfig as JaxTePoseConfig, VibeConfig as JaxVibeConfig,
    tepose_init, vibe_init)
from tepose_tpu.streaming.engine import StreamingEngine as JaxEngine
from tepose_tpu.streaming.live import LiveSession as JaxLive
from tepose_tpu.utils import profiling as jax_profiling
from tepose_tpu_torch.models.backbone import (
    IMAGENET_MEAN, IMAGENET_STD, ResNet50)
from tepose_tpu_torch.models.smpl import synthetic_smpl_model
from tepose_tpu_torch.models.tepose import (
    TePose, TePoseConfig, Vibe, VibeConfig)
from tepose_tpu_torch.streaming import engine as PE
from tepose_tpu_torch.streaming.engine import StreamingEngine
from tepose_tpu_torch.streaming.live import LiveSession
from tepose_tpu_torch.utils.profiling import StageTimer
from tepose_tpu_torch.weights import state_dict_from_jax_tree

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
import make_torch_serve_golden as golden_writer  # noqa: E402

pytestmark = pytest.mark.heavy

KEYS = ("theta", "verts", "kp_3d", "kp_2d")
LIVE_TOL = dict(rtol=2e-4, atol=2e-5)
CROPS_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def m():
    """JAX params and the port's modules holding them, plus inputs."""
    jcfg = JaxTePoseConfig(seqlen=6, n_layers=1, hidden_size=16)
    jvcfg = JaxVibeConfig(seqlen=6, n_layers=1, hidden_size=16,
                          add_linear=True)
    jgen = jax.device_get(tepose_init(jax.random.PRNGKey(0), jcfg))
    jvibe = jax.device_get(vibe_init(jax.random.PRNGKey(1), jvcfg))
    jbb = jax.device_get(jax_resnet50_init(jax.random.PRNGKey(2)))
    g = torch.Generator().manual_seed(0)
    gen = TePose(TePoseConfig(6, 1, 16), generator=g, device="cpu")
    vibe = Vibe(VibeConfig(6, 1, 16), generator=g, device="cpu")
    bb = ResNet50(device="cpu")
    gen.load_state_dict(state_dict_from_jax_tree(jgen), strict=True)
    vibe.load_state_dict(state_dict_from_jax_tree(jvibe), strict=True)
    bb.load_state_dict(state_dict_from_jax_tree(jbb), strict=True)
    rs = np.random.RandomState(11)

    def u8(n):
        return (rs.rand(n, 3, 64, 64) * 255).astype(np.uint8)

    return dict(
        jcfg=jcfg, jvcfg=jvcfg, jgen=jgen, jvibe=jvibe, jbb=jbb,
        jsmpl=jax_smpl(0, 64), smpl=synthetic_smpl_model(0, 64),
        gen=gen.eval(), vibe=vibe.eval(), bb=bb.eval(),
        feats=[rs.randn(n, 2048).astype(np.float32) * 0.1
               for n in (14, 14, 30)],
        pseu=rs.randn(5, 85).astype(np.float32) * 0.1,
        crops=[u8(8), u8(10)], long=[u8(8), u8(44), u8(20)],
        small=[u8(3), u8(5)])


def _jax(m, **kw):
    kw.setdefault("window_bucket", 16)
    return JaxEngine(m["jsmpl"], m["jgen"], m["jvibe"], m["jbb"], m["jcfg"],
                     m["jvcfg"], **kw)


def _port(m, **kw):
    kw.setdefault("window_bucket", 16)
    return StreamingEngine(m["smpl"], m["gen"], m["vibe"], m["bb"], **kw)


def _normalised(crops):
    mean = IMAGENET_MEAN.reshape(1, 3, 1, 1)
    std = IMAGENET_STD.reshape(1, 3, 1, 1)
    return [((c.astype(np.float32) / 255.0 - mean) / std).astype(np.float32)
            for c in crops]


def _same(got, want, keys=KEYS, **tol):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(keys), set(g)
        for k in keys:
            assert g[k].shape == w[k].shape and g[k].dtype == w[k].dtype, k
            np.testing.assert_allclose(g[k], w[k], err_msg=f"{i}/{k}", **tol)


# ------------------------------------------------------------- the engine


def test_run_tracklets_matches_jax(m):
    """Several buckets (16 and 32), a pseudo-theta on one tracklet."""
    pseu = [None, m["pseu"], None]
    want = _jax(m).run_tracklets(m["feats"], pseu)
    eng = _port(m)
    got = eng.run_tracklets(m["feats"], pseu)
    _same(got, want, atol=1e-5, rtol=0)
    assert [g["theta"].shape[0] for g in got] == [14, 14, 30]
    single = eng.run_tracklet(m["feats"][1], m["pseu"])
    for k in KEYS:
        np.testing.assert_allclose(single[k], got[1][k], atol=1e-5, rtol=0)
    assert set(eng.timings) == {"stream"}


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_run_tracklets_from_crops_matches_jax(m, dtype):
    crops = m["crops"] if dtype == "uint8" else _normalised(m["crops"])
    want = _jax(m, crop_batch=4).run_tracklets_from_crops(crops)
    eng = _port(m, crop_batch=4)
    got = eng.run_tracklets_from_crops(crops)
    _same(got, want, **CROPS_TOL)
    # the fused path equals the two-stage one on the port
    staged = eng.run_tracklets(eng.extract_features_multi(crops))
    _same(got, staged, **CROPS_TOL)
    assert {"fused", "features", "stream"} <= set(eng.timings)


def test_long_bucket_fallback_matches_jax(m):
    """A 48-frame bucket over max_frames_per_call takes the two-stage path
    between two fused buckets of the depth-2 pipeline."""
    want = _jax(m, max_frames_per_call=40).run_tracklets_from_crops(m["long"])
    eng = _port(m, max_frames_per_call=40)
    got = eng.run_tracklets_from_crops(m["long"])
    assert [g["theta"].shape[0] for g in got] == [8, 44, 20]
    _same(got, want, **CROPS_TOL)
    assert eng.timers.counts["stream"] == 1      # the fallback's scan
    for i, c in enumerate(m["long"]):
        lone = eng.run_tracklets_from_crops([c])[0]
        for k in KEYS:
            np.testing.assert_allclose(got[i][k], lone[k], **CROPS_TOL)


def test_extract_features_multi_chunk_boundaries(m):
    """crop_batch 2 and max_frames_per_call 6 cut chunks and super-chunks
    across the tracklets' boundaries."""
    je = _jax(m)
    je.crop_batch, je.max_frames_per_call = 2, 6
    want = je.extract_features_multi(m["small"])
    eng = _port(m, crop_batch=2, max_frames_per_call=6)
    got = eng.extract_features_multi(m["small"])
    assert [f.shape for f in got] == [(3, 2048), (5, 2048)]
    scale = max(np.abs(w).max() for w in want)
    # 1e-5 of the features' scale: the CPU convolutions sum in another
    # order for another batch size
    for g, w, c in zip(got, want, m["small"]):
        np.testing.assert_allclose(g, w, atol=1e-5 * scale, rtol=0)
        np.testing.assert_allclose(eng.extract_features(c), g,
                                   atol=1e-5 * scale, rtol=0)
    assert eng.extract_features_multi([]) == []


def test_output_dtype_matches_jax(m):
    feats = [m["feats"][0]]
    want = _jax(m, output_dtype=jnp.float16).run_tracklets(feats)
    got = _port(m, output_dtype=torch.float16).run_tracklets(feats)
    assert got[0]["verts"].dtype == np.float16
    assert got[0]["theta"].dtype == np.float32   # the feedback stays f32
    _same(got, want, atol=1e-3, rtol=1e-3)       # f16 rounding


def test_presets(m):
    assert PE.ENGINE_PRESETS == ("parity", "serving", "serving-joints")
    assert PE.ENGINE_OUTPUTS == ("theta", "verts", "kp_3d", "kp_2d")
    serving = _port(m, preset="serving")
    assert (serving.backbone_dtype, serving.output_dtype) == (
        torch.bfloat16, torch.float16)
    assert serving.backbone.dtype == torch.bfloat16
    assert serving.backbone.memory_format == torch.channels_last
    assert _port(m).backbone is m["bb"]
    assert m["bb"].dtype == torch.float32       # the caller's is untouched
    explicit = _port(m, backbone_dtype=torch.bfloat16,
                     output_dtype=torch.float16)
    bf16_f32out = _port(m, backbone_dtype=torch.bfloat16)
    a = serving.run_tracklets_from_crops(m["crops"])
    b = explicit.run_tracklets_from_crops(m["crops"])
    c = bf16_f32out.run_tracklets_from_crops(m["crops"])
    for k in KEYS:
        np.testing.assert_array_equal(a[0][k], b[0][k], err_msg=k)
    # the output knob adds only float16 rounding to the bf16 tier (verts in
    # metres: 1 mm), as tests/test_engine.py holds the JAX presets
    verts_dev = np.abs(c[0]["verts"] - a[0]["verts"].astype(np.float32))
    assert verts_dev.max() < 1e-3
    np.testing.assert_allclose(c[0]["theta"], a[0]["theta"], atol=1e-5)
    joints = _port(m, preset="serving-joints")
    assert joints.outputs == ("theta", "kp_3d")
    assert set(joints.run_tracklet(m["feats"][0])) == {"theta", "kp_3d"}
    override = _port(m, preset="serving", output_dtype=torch.float32)
    assert override.output_dtype == torch.float32
    assert PE.apply_engine_preset(None, None, None, ("theta", "verts")) == (
        None, None, ("theta", "verts"))


def test_engine_rejections(m):
    with pytest.raises(ValueError, match="unknown outputs"):
        _port(m, outputs=("theta", "bogus"))
    with pytest.raises(ValueError, match="non-empty"):
        _port(m, outputs=())
    with pytest.raises(ValueError, match="preset"):
        _port(m, preset="turbo")
    with pytest.raises(NotImplementedError, match="not ported"):
        _port(m, mesh=object())
    eng = _port(m)
    with pytest.raises(ValueError, match="mixed crop dtypes"):
        eng.run_tracklets_from_crops(
            [m["crops"][0], _normalised(m["crops"])[1]])
    with pytest.raises(ValueError, match="mixed crop dtypes"):
        eng.extract_features_multi([m["small"][0],
                                    _normalised(m["small"])[1]])
    with pytest.raises(ValueError, match="too short"):
        eng.run_tracklets_from_crops([m["small"][1]])
    with pytest.raises(ValueError, match="too short"):
        eng.run_tracklets([m["feats"][0][:5]])


def test_engine_runs_strict_f32_and_restores_flags(m, monkeypatch):
    seen = []
    eng = _port(m)
    real = eng._boot_and_scan

    def spy(*a):
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32,
                     torch.is_inference_mode_enabled()))
        return real(*a)

    monkeypatch.setattr(eng, "_boot_and_scan", spy)
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        eng.run_tracklets([m["feats"][0]])
        assert seen == [(False, False, True)]
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def test_pad_batch_powers_of_two():
    assert [StreamingEngine._pad_batch(b) for b in (1, 2, 3, 5, 8, 9)] == [
        1, 2, 4, 8, 8, 16]


# ---------------------------------------------------------- the live session


def _live(m, **kw):
    return LiveSession(m["smpl"], m["gen"], m["vibe"], **kw)


def test_live_matches_port_engine(m):
    feats = m["feats"][2][:20]
    offline = _port(m).run_tracklet(feats)
    live = _live(m, outputs=("theta", "verts", "kp_3d", "kp_2d"))
    for t in range(len(feats)):
        out = live.push(feats[t:t + 1])
        assert out["valid"][0] == (t >= 5), t
        for k in KEYS:
            assert out[k].shape == (1,) + offline[k].shape[1:]
            np.testing.assert_allclose(out[k][0], offline[k][t],
                                       err_msg=f"frame {t} {k}", **LIVE_TOL)


def test_live_matches_jax_live_with_reset(m):
    """Two streams, slot 1 re-seeded at frame 5, against JAX LiveSession."""
    outputs = ("theta", "kp_2d", "kp_3d", "verts")
    jl = JaxLive(m["jsmpl"], m["jgen"], m["jvibe"], m["jcfg"], m["jvcfg"],
                 n_streams=2, outputs=outputs, theta_pseu=m["pseu"])
    pl = _live(m, n_streams=2, outputs=outputs, theta_pseu=m["pseu"])
    x = np.stack([m["feats"][0][:12], m["feats"][2][:12]], axis=1)
    for t in range(12):
        reset = np.array([False, t == 5])
        a, b = jl.push(x[t], reset=reset), pl.push(x[t], reset=reset)
        np.testing.assert_array_equal(b["valid"], a["valid"], err_msg=t)
        for k in outputs:
            np.testing.assert_allclose(b[k], a[k], atol=1e-5, rtol=1e-5,
                                       err_msg=f"t={t} {k}")
    assert b["valid"].tolist() == [True, True]


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_live_crops_multi_stream_matches_engine(m, dtype):
    crops = m["crops"] if dtype == "uint8" else _normalised(m["crops"])
    offline = _port(m, crop_batch=8).run_tracklets_from_crops(crops)
    live = _live(m, n_streams=2, backbone=m["bb"], outputs=("theta", "kp_3d"))
    for t in range(8):
        out = live.push(np.stack([crops[0][t], crops[1][t]]))
        for b in range(2):
            for k in ("theta", "kp_3d"):
                np.testing.assert_allclose(
                    out[k][b], offline[b][k][t],
                    err_msg=f"frame {t} stream {b} {k}", **LIVE_TOL)


def test_live_per_stream_reset(m):
    """push(reset=mask) re-seeds exactly the masked slot: from the reset
    frame on it equals a fresh session fed only the new tracklet, and the
    other slot goes on with its own rollout."""
    rs = np.random.RandomState(5)
    T = 14
    a = rs.randn(T, 2048).astype(np.float32) * 0.1
    b1 = rs.randn(6, 2048).astype(np.float32) * 0.1
    b2 = rs.randn(T - 6, 2048).astype(np.float32) * 0.1
    live = _live(m, n_streams=2, outputs=("theta",))
    got_a, got_b2, valid_b = [], [], []
    for t in range(T):
        xb = b1[t] if t < 6 else b2[t - 6]
        out = live.push(np.stack([a[t], xb]),
                        reset=np.array([False, t == 6]))
        got_a.append(out["theta"][0])
        valid_b.append(bool(out["valid"][1]))
        if t >= 6:
            got_b2.append(out["theta"][1])
    assert valid_b[6:11] == [False] * 5 and all(valid_b[11:])
    solo, fresh = _live(m, outputs=("theta",)), _live(m, outputs=("theta",))
    for t in range(T):
        np.testing.assert_allclose(got_a[t], solo.push(a[t:t + 1])["theta"][0],
                                   err_msg=f"t={t}", **LIVE_TOL)
    for i in range(T - 6):
        np.testing.assert_allclose(got_b2[i],
                                   fresh.push(b2[i:i + 1])["theta"][0],
                                   err_msg=f"reset frame {i}", **LIVE_TOL)


def test_live_survives_interrupted_step(m):
    live = _live(m, n_streams=2)
    x = np.random.RandomState(2).randn(2, 2048).astype(np.float32) * 0.1
    for _ in range(6):
        out = live.push(x)
    assert out["valid"].all()
    orig = live._step

    def boom(*a, **k):
        raise KeyboardInterrupt

    live._step = boom
    with pytest.raises(KeyboardInterrupt):
        live.push(x)
    live._step = orig
    out = live.push(x)
    assert not out["valid"].any()      # every stream was re-seeded
    assert np.isfinite(out["theta"]).all()
    for _ in range(6):
        out = live.push(x)
    assert out["valid"].all()


def test_live_bf16_backbone_close(m):
    """tests/test_live.py's envelope for the bf16 backbone, on its crops.

    The He-init backbone has zero biases and no BN, so it is positively
    homogeneous: its stem scaled by 1e-3 scales every feature by 1e-3, from
    the hundreds to the ~0.5 of real SPIN features. At the full scale bf16
    rounding (0.55 % of the features, in the JAX engine as in the port)
    moves some theta entries by up to ~6, in either package, depending on
    the crops."""
    bb = copy.deepcopy(m["bb"])
    with torch.no_grad():
        bb.stem.w.mul_(1e-3)
    crops = (np.random.RandomState(0).rand(2, 8, 3, 64, 64) * 255).astype(
        np.uint8)
    f32 = _live(m, n_streams=2, backbone=bb, outputs=("theta",))
    b16 = _live(m, n_streams=2, backbone=bb, outputs=("theta",),
                preset="serving")
    assert b16.backbone.dtype == torch.bfloat16
    for t in range(8):
        a, b = f32.push(crops[:, t])["theta"], b16.push(crops[:, t])["theta"]
        assert np.isfinite(b).all()
        np.testing.assert_allclose(a, b, rtol=0.1, atol=0.15,
                                   err_msg=f"frame {t}")


def test_live_rejections(m):
    with pytest.raises(ValueError, match="unknown outputs"):
        _live(m, outputs=("bogus",))
    with pytest.raises(ValueError, match="non-empty"):
        _live(m, outputs=())
    with pytest.raises(ValueError, match="preset"):
        _live(m, preset="turbo")
    with pytest.raises(NotImplementedError, match="not ported"):
        _live(m, mesh=object())
    bidir = Vibe(VibeConfig(6, 1, 16, bidirectional=True),
                 generator=torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="causal"):
        LiveSession(m["smpl"], m["gen"], bidir)
    live = _live(m, n_streams=2)
    with pytest.raises(ValueError, match="streams"):
        live.push(np.zeros((1, 2048), np.float32))
    with pytest.raises(ValueError, match="backbone"):
        live.push(m["crops"][0][:2])


# ------------------------------------------------------- timer and golden


def test_stage_timer_is_the_jax_copy(monkeypatch):
    assert inspect.getsource(StageTimer) == inspect.getsource(
        jax_profiling.StageTimer)
    import tepose_tpu_torch.utils.profiling as P

    clock = iter([1.0, 1.5, 2.0, 4.0, 5.0, 5.25])
    monkeypatch.setattr(P.time, "perf_counter", lambda: next(clock))
    t = StageTimer()
    with t.stage("a"):
        pass
    with t.stage("b"):
        pass
    with pytest.raises(RuntimeError):
        with t.stage("a"):
            raise RuntimeError
    assert t.totals == {"a": 0.75, "b": 2.0}
    assert t.counts == {"a": 2, "b": 1}
    assert t.summary()["a"] == {"total_s": 0.75, "count": 2, "mean_ms": 375.0}
    assert t.report() == "a: 0.75s (375.0ms x 2) | b: 2.00s (2000.0ms x 1)"


SMALL_SPEC = dict(golden_writer.FULL_SPEC, hidden_size=32,
                  vibe_hidden_size=32, num_verts=700, crop_size=64,
                  vert_stride=7)


def test_serve_golden_writer_matches_port_small():
    """The writer's JAX function at small width against the port on the
    CPU, through both engine paths."""
    golden = golden_writer.make_golden(SMALL_SPEC)
    setup = golden_writer.port_setup(SMALL_SPEC, "cpu")
    np.testing.assert_array_equal(golden_writer.weight_checksums(setup),
                                  golden["weight_checksums"])
    assert golden["verts_1"].shape == (12, 100, 3)
    for path in ("crops", "features"):
        got = golden_writer.port_serve(setup, path)
        assert set(got) == set(golden) - {"spec", "weight_checksums"}
        for k in got:
            np.testing.assert_allclose(got[k], golden[k], err_msg=k,
                                       **CROPS_TOL)


def test_committed_serve_golden_matches_port_on_cpu():
    """The committed full-width golden, which the GPU run is held to, is
    reproduced by the port on the CPU at chip_smoke.py's bars."""
    path = golden_writer.GOLDEN_PATH
    assert os.path.getsize(path) < 200 << 10
    golden = golden_writer.load_golden(path)
    assert golden["spec"] == golden_writer.FULL_SPEC
    setup = golden_writer.port_setup(golden["spec"], "cpu")
    np.testing.assert_allclose(golden_writer.weight_checksums(setup),
                               golden["weight_checksums"], rtol=1e-9, atol=0)
    got = golden_writer.port_serve(setup)
    dev = golden_writer.golden_deviation(got, golden)
    assert golden["verts_0"].shape == (7, 138, 3)
    for k, (d, bar) in dev.items():
        assert d <= bar, (k, d, bar)
