"""Port parity of the one-process scale-out paths: the distributed helpers
in one process, `parallel.mesh`'s placement, and the sharded eval rollout,
`StreamingEngine(mesh=)`, `LiveSession(mesh=)` and
`FeatureExtractor(mesh=)` on a 4-entry CPU mesh (`["cpu"] * 4`) against
their JAX mesh counterparts over `make_mesh(4)` on the suite's virtual CPU
devices, on shared weights.

Small widths in float32: TePose and VIBE 1 x 16 (eval 1 x 32), 64
vertices, 64 x 64 crops, seqlen 6. The bars are those of the JAX mesh
tests: eval 1e-5 (tests/test_evaluator.py), the engine 1e-5 on features and
rtol/atol 1e-4 through the ResNet-50 (tests/test_engine.py), live
rtol 2e-4, atol 2e-5 (tests/test_live.py), the extractor rtol 1e-4, atol
1e-3 (tests/test_preprocess.py).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from tepose_tpu.data.preprocess import FeatureExtractor as JaxExtractor
from tepose_tpu.eval.evaluator import make_sharded_eval_scan
from tepose_tpu.models.backbone import resnet50_init as jax_resnet50_init
from tepose_tpu.models.smpl import synthetic_smpl_model as jax_smpl
from tepose_tpu.models.tepose import (
    TePoseConfig as JaxTePoseConfig, VibeConfig as JaxVibeConfig,
    tepose_init, vibe_init)
from tepose_tpu.parallel.mesh import make_mesh as jax_make_mesh
from tepose_tpu.streaming.engine import StreamingEngine as JaxEngine
from tepose_tpu.streaming.live import LiveSession as JaxLive
from tepose_tpu_torch import config as TCFG
from tepose_tpu_torch import evaluate as port_evaluate
from tepose_tpu_torch.data.preprocess import FeatureExtractor
from tepose_tpu_torch.eval.evaluator import (
    eval_rollout, make_sharded_eval_rollout)
from tepose_tpu_torch.models.backbone import ResNet50
from tepose_tpu_torch.models.smpl import synthetic_smpl_model
from tepose_tpu_torch.models.tepose import (
    TePose, TePoseConfig, Vibe, VibeConfig)
from tepose_tpu_torch.parallel import distributed, dp
from tepose_tpu_torch.parallel.mesh import (
    Mesh, gather_rows, make_mesh, replicate, row_blocks, shard_batch,
    split_rows)
from tepose_tpu_torch.streaming.engine import StreamingEngine
from tepose_tpu_torch.streaming.live import LiveSession
from tepose_tpu_torch.train.run import rank_count
from tepose_tpu_torch.train.trainer import TrainHyper
from tepose_tpu_torch.weights import state_dict_from_jax_tree

CPU4 = ["cpu"] * 4
V, S = 64, 6
LIVE_TOL = dict(rtol=2e-4, atol=2e-5)
CROPS_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs six workers on this host's
    cores, and these tests' small ops gain nothing from more."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


# --------------------------------------------------------- the helpers


def test_distributed_helpers_single_process():
    """The counterpart of tests/test_multiprocess.py's single-process
    test: every helper is the identity or a no-op without a group."""
    assert not distributed.initialized()
    assert distributed.process_count() == 1
    assert distributed.process_index() == 0 and distributed.is_primary()
    assert distributed.host_local_rows(8) == slice(0, 8)
    assert distributed.broadcast_str("abc") == "abc"
    assert distributed.broadcast_object({"a": 1}) == {"a": 1}
    distributed.barrier("noop")
    distributed.service_barrier("noop")
    tree = {"a": np.arange(8.0), "s": np.float32(3.0), "l": [np.ones(8)]}
    sliced = distributed.host_slice_tree(tree)
    np.testing.assert_array_equal(sliced["a"], tree["a"])
    assert sliced["s"] == 3.0 and sliced["l"][0].shape == (8,)
    x = distributed.put_global(np.arange(16.0).reshape(8, 2), "cpu")
    assert isinstance(x, torch.Tensor)
    np.testing.assert_array_equal(distributed.fetch_global(x),
                                  np.arange(16.0).reshape(8, 2))
    t = torch.ones(3, requires_grad=True)
    with distributed.reducing():
        assert distributed.reducing_world() == 1
        assert distributed.sum_across(t) is t
        assert distributed.sum_across_with_grad(t) is t
    assert distributed.maybe_initialize() is False


def test_distributed_helpers_in_a_world_one_group():
    """The same helpers through a real one-process gloo group (the world-1
    NCCL run on the card takes these code paths): collectives are the
    identity, the store barrier passes, the summed gradient is the
    gradient."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    assert distributed.maybe_initialize(f"localhost:{port}", 1, 0,
                                        backend="gloo", timeout_s=30)
    try:
        assert distributed.initialized() and distributed.process_count() == 1
        assert distributed.broadcast_str("abc") == "abc"
        distributed.service_barrier("world1")
        distributed.service_barrier("world1")
        distributed.barrier("world1")
        np.testing.assert_array_equal(
            distributed.fetch_global(np.arange(6.0).reshape(3, 2)),
            np.arange(6.0).reshape(3, 2))
        t = torch.arange(3.0, requires_grad=True)
        with distributed.reducing():
            y = distributed.sum_across_with_grad(t * 2)
            (y * torch.tensor([1.0, 2.0, 3.0])).sum().backward()
            np.testing.assert_array_equal(
                distributed.sum_across(torch.ones(2)).numpy(), [1, 1])
        np.testing.assert_array_equal(y.detach().numpy(), [0, 2, 4])
        np.testing.assert_array_equal(t.grad.numpy(), [2, 4, 6])
        m = nn.Linear(3, 2)
        before = {k: v.clone() for k, v in m.state_dict().items()}
        dp.replicate_from_primary(m)
        assert all(torch.equal(before[k], v)
                   for k, v in m.state_dict().items())
    finally:
        distributed.shutdown()
    assert not distributed.initialized()


def test_shard_batch_and_replicate_round_trip():
    mesh = make_mesh(devices=CPU4)
    assert isinstance(mesh, Mesh) and mesh.size == 4
    assert mesh.axis_name == "data"
    tree = {"x": np.arange(24.0).reshape(8, 3),
            "t": torch.arange(8), "s": np.float32(2.0)}
    shards = shard_batch(tree, mesh)
    assert len(shards) == 4
    assert all(sh["x"].shape == (2, 3) and sh["s"] == 2.0 for sh in shards)
    np.testing.assert_array_equal(
        gather_rows([sh["x"] for sh in shards]).numpy(), tree["x"])
    np.testing.assert_array_equal(
        gather_rows([sh["t"] for sh in shards]).numpy(), np.arange(8))
    assert row_blocks(8, mesh)[1] == slice(2, 4)
    # a ragged batch (the extractor's last one): contiguous, sizes within
    # one, empty blocks when there are fewer rows than devices
    for n, parts in ((7, 4), (3, 4), (0, 2), (300, 2)):
        blocks = split_rows(n, parts)
        sizes = [b.stop - b.start for b in blocks]
        assert len(blocks) == parts and sum(sizes) == n
        assert max(sizes) - min(sizes) <= 1
        assert all(a.stop == b.start for a, b in zip(blocks, blocks[1:]))
    with pytest.raises(ValueError, match="does not divide"):
        shard_batch({"x": np.zeros((6, 2))}, mesh)

    gen = TePose(TePoseConfig(S, 1, 16),
                 generator=torch.Generator().manual_seed(0), device="cpu")
    gen.fast_pack()
    reps = replicate({"gen": gen, "w": np.ones(3)}, mesh)
    assert len(reps) == 4
    for r in reps:
        assert r["gen"] is not gen and r["gen"]._fast is None
        assert torch.is_tensor(r["w"])
        sa, sb = gen.state_dict(), r["gen"].state_dict()
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
        assert all(a.data_ptr() != b.data_ptr() for a, b in
                   zip(gen.parameters(), r["gen"].parameters()))
    with pytest.raises(ValueError, match="CUDA devices are visible"):
        make_mesh(devices=["cuda:63"])


def test_make_mesh_and_devices_beyond_the_visible_count():
    """Asking for more CUDA devices than are visible raises, naming the
    count, in make_mesh, run_eval and both CLIs' --devices."""
    visible = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"only {visible} are visible"):
        make_mesh(visible + 2)
    with pytest.raises(ValueError, match=f"only {visible} are visible"):
        port_evaluate.eval_mesh(visible + 2, "cuda")
    with pytest.raises(SystemExit, match=f"only {visible} CUDA devices"):
        rank_count(str(visible + 2), "cuda:0")
    assert port_evaluate.eval_mesh(1, "cpu") is None
    assert port_evaluate.eval_mesh("auto", "cpu") is None
    assert port_evaluate.eval_mesh(3, "cpu").devices == (
        torch.device("cpu"),) * 3
    assert rank_count("3", "cpu") == 3 and rank_count("auto", "cpu") == 1


def test_check_divisible():
    """n_2d and n_3d must each divide by the device count (the config's
    32 splits 19 + 13, which no world of 2 divides)."""
    with pytest.raises(ValueError, match="n_2d=19 is not divisible"):
        dp.check_divisible(TrainHyper(n_2d=19, n_3d=13), 2)
    with pytest.raises(ValueError, match="n_3d=13 is not divisible"):
        dp.check_divisible(TrainHyper(n_2d=20, n_3d=13), 2)
    dp.check_divisible(TrainHyper(n_2d=24, n_3d=16), 2)
    dp.check_divisible(TrainHyper(n_2d=19, n_3d=13), 1)
    shard = dp.RowShard(1, 2, 4, 6)
    np.testing.assert_array_equal(shard.rows(), [2, 3, 7, 8, 9])
    assert shard.amass_rows() == slice(5, 10)


# ------------------------------------------------------------------ eval


def test_sharded_eval_matches_jax_sharded_scan():
    """make_sharded_eval_rollout on 4 CPU replicas against JAX
    make_sharded_eval_scan over make_mesh(4), 1e-5; and against the
    port's single-device rollout."""
    rs = np.random.RandomState(0)
    jcfg = JaxTePoseConfig(seqlen=S, n_layers=1, hidden_size=32)
    jvcfg = JaxVibeConfig(seqlen=S, n_layers=1, hidden_size=32,
                          add_linear=True)
    jgen = jax.device_get(tepose_init(jax.random.PRNGKey(0), jcfg))
    jvibe = jax.device_get(vibe_init(jax.random.PRNGKey(1), jvcfg))
    gen = TePose(TePoseConfig(S, 1, 32),
                 generator=torch.Generator().manual_seed(0), device="cpu")
    vibe = Vibe(VibeConfig(S, 1, 32),
                generator=torch.Generator().manual_seed(0), device="cpu")
    gen.load_state_dict(state_dict_from_jax_tree(jgen))
    vibe.load_state_dict(state_dict_from_jax_tree(jvibe))
    gen.eval(), vibe.eval()
    B, T = 8, 14
    W = T - S + 1
    feats = rs.randn(B, T, 2048).astype(np.float32) * 0.1
    pseu = rs.randn(B, S - 1, 85).astype(np.float32) * 0.1
    theta_gt = rs.randn(B, T, 85).astype(np.float32) * 0.1
    jreg = rs.rand(17, V).astype(np.float32)

    fn, place_w, place_d = make_sharded_eval_scan(
        jax_smpl(0, V), jcfg, jvcfg, W, use_j_regressor=True,
        mesh=jax_make_mesh(4))
    data = place_d({"feats": feats, "theta_pseu": pseu,
                    "theta_gt": theta_gt})
    with jax.default_matmul_precision("float32"):
        want = [np.asarray(x) for x in fn(
            place_w(jgen), place_w(jvibe), data["feats"],
            data["theta_pseu"], data["theta_gt"],
            place_w(jnp.asarray(jreg)))]

    smpl = synthetic_smpl_model(0, V)
    sharded = make_sharded_eval_rollout(gen, vibe, smpl,
                                        torch.from_numpy(jreg),
                                        make_mesh(devices=CPU4))
    got = sharded(feats, pseu, theta_gt, W)
    single = eval_rollout(gen, vibe, smpl, torch.from_numpy(feats),
                          torch.from_numpy(pseu), torch.from_numpy(theta_gt),
                          torch.from_numpy(jreg), W)
    for key, w in zip(("pred_j3d", "pred_theta", "mpvpe"), want):
        assert got[key].device.type == "cpu" and got[key].shape == w.shape
        np.testing.assert_allclose(got[key].numpy(), w, atol=1e-5,
                                   err_msg=key)
        np.testing.assert_allclose(got[key].numpy(), single[key].numpy(),
                                   atol=1e-5, err_msg=key)


def test_run_eval_devices_matches_one_device(monkeypatch):
    """run_eval(devices=3) on the CPU: the batch of 3 videos pads to 4 rows
    and then to 6, two a replica; the metrics equal one device's."""
    def small_models(cfg, synthetic, device):
        smpl = synthetic_smpl_model(0, V, device=device)
        g = torch.Generator().manual_seed(0)
        gen = TePose(TePoseConfig(S, 1, 16), generator=g,
                     device=device).eval()
        vibe = Vibe(VibeConfig(16, 1, 16), generator=g, device=device).eval()
        jreg = port_evaluate.synthetic_j_regressor(V)
        return smpl, gen, vibe, torch.as_tensor(jreg, device=device)

    synthetic_eval_data = port_evaluate.synthetic_eval_data
    monkeypatch.setattr(port_evaluate, "build_models", small_models)
    monkeypatch.setattr(
        port_evaluate, "synthetic_eval_data",
        lambda: synthetic_eval_data(num_videos=3, min_len=14, max_len=20))
    cfg, _, args = TCFG.parse_args(["--cfg", os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "configs", "repr_wopw_3dpw_model.yaml"), "--dataset", "3dpw"])
    args.eval_bucket = 32           # one bucket of 32 frames, 27 windows
    one = port_evaluate.run_eval(cfg, args, synthetic=True, device="cpu")
    three = port_evaluate.run_eval(cfg, args, synthetic=True, device="cpu",
                                   devices=3)
    assert one["frames"] == three["frames"] > 0
    for k in ("mpjpe", "pa_mpjpe", "mpvpe", "accel_err"):
        np.testing.assert_allclose(three[k], one[k], rtol=1e-6, err_msg=k)


# ---------------------------------------------------------- serving paths


@pytest.fixture(scope="module")
def m():
    """JAX params, the port's modules holding them, and inputs (the
    weights of tests/test_torch_serve.py)."""
    jcfg = JaxTePoseConfig(seqlen=S, n_layers=1, hidden_size=16)
    jvcfg = JaxVibeConfig(seqlen=S, n_layers=1, hidden_size=16,
                          add_linear=True)
    jgen = jax.device_get(tepose_init(jax.random.PRNGKey(0), jcfg))
    jvibe = jax.device_get(vibe_init(jax.random.PRNGKey(1), jvcfg))
    jbb = jax.device_get(jax_resnet50_init(jax.random.PRNGKey(2)))
    g = torch.Generator().manual_seed(0)
    gen = TePose(TePoseConfig(S, 1, 16), generator=g, device="cpu")
    vibe = Vibe(VibeConfig(S, 1, 16), generator=g, device="cpu")
    bb = ResNet50(device="cpu")
    gen.load_state_dict(state_dict_from_jax_tree(jgen), strict=True)
    vibe.load_state_dict(state_dict_from_jax_tree(jvibe), strict=True)
    bb.load_state_dict(state_dict_from_jax_tree(jbb), strict=True)
    return dict(jcfg=jcfg, jvcfg=jvcfg, jgen=jgen, jvibe=jvibe, jbb=jbb,
                jsmpl=jax_smpl(0, V), smpl=synthetic_smpl_model(0, V),
                gen=gen.eval(), vibe=vibe.eval(), bb=bb.eval(),
                rs=np.random.RandomState(11))


def _same(got, want, **tol):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w)
        for k in w:
            assert g[k].shape == w[k].shape, k
            np.testing.assert_allclose(g[k], w[k], err_msg=f"{i}/{k}", **tol)


def test_engine_mesh_matches_jax_mesh(m):
    """StreamingEngine on 4 CPU replicas against the JAX engine over
    make_mesh(4) (tests/test_engine.py's mesh test): features at 1e-5,
    crops through the fused path at 1e-4; the long-video fallback and a
    bucket whose last replica holds only pad rows against the port's one
    device at 1e-4."""
    rs = m["rs"]
    mesh = make_mesh(devices=CPU4)
    jax_eng = JaxEngine(m["jsmpl"], m["jgen"], m["jvibe"], m["jbb"],
                        m["jcfg"], m["jvcfg"], window_bucket=16,
                        mesh=jax_make_mesh(4))
    eng = StreamingEngine(m["smpl"], m["gen"], m["vibe"], m["bb"],
                          window_bucket=16, mesh=mesh)
    single = StreamingEngine(m["smpl"], m["gen"], m["vibe"], m["bb"],
                             window_bucket=16)
    feats = [rs.randn(n, 2048).astype(np.float32) * 0.1 for n in (14, 14, 30)]
    got = eng.run_tracklets(feats)
    _same(got, jax_eng.run_tracklets(feats), atol=1e-5, rtol=0)
    _same(got, single.run_tracklets(feats), atol=1e-6, rtol=0)

    crops = [(rs.rand(8, 3, 64, 64) * 255).astype(np.uint8)]
    got = eng.run_tracklets_from_crops(crops)
    _same(got, jax_eng.run_tracklets_from_crops(crops), **CROPS_TOL)
    _same(got, single.run_tracklets_from_crops(crops), **CROPS_TOL)

    eng.max_frames_per_call = single.max_frames_per_call = 8
    long = [(rs.rand(10, 3, 64, 64) * 255).astype(np.uint8)]
    _same(eng.run_tracklets_from_crops(long),
          single.run_tracklets_from_crops(long), **CROPS_TOL)
    eng.max_frames_per_call = single.max_frames_per_call = 4096
    # five tracklets over four replicas: the bucket pads to 8 rows
    five = [(rs.rand(n, 3, 64, 64) * 255).astype(np.uint8)
            for n in (6, 7, 6, 8, 6)]
    _same(eng.run_tracklets_from_crops(five),
          single.run_tracklets_from_crops(five), **CROPS_TOL)
    assert len({id(r.tepose) for r in eng._replicas}) == 4
    assert all(r.tepose is not m["gen"] for r in eng._replicas)


def test_live_mesh_matches_jax_mesh(m):
    """LiveSession on 4 CPU replicas against the JAX session over
    make_mesh(4) (tests/test_live.py's mesh test): 8 streams, 12 frames,
    slot 3 reset at frame 5, rtol 2e-4, atol 2e-5."""
    rs = m["rs"]
    B, T = 8, 12
    feats = rs.randn(T, B, 2048).astype(np.float32) * 0.1
    jax_live = JaxLive(m["jsmpl"], m["jgen"], m["jvibe"], m["jcfg"],
                       m["jvcfg"], n_streams=B, outputs=("theta", "kp_3d"),
                       mesh=jax_make_mesh(4))
    live = LiveSession(m["smpl"], m["gen"], m["vibe"], n_streams=B,
                       outputs=("theta", "kp_3d"),
                       mesh=make_mesh(devices=CPU4))
    solo = LiveSession(m["smpl"], m["gen"], m["vibe"], n_streams=B,
                       outputs=("theta", "kp_3d"))
    for t in range(T):
        reset = None
        if t == 5:
            reset = np.zeros((B,), bool)
            reset[3] = True
        a = live.push(feats[t], reset=reset)
        if t == 5:
            # the reset reached slot 3 only: its window is filling again
            assert not a["valid"][3] and a["valid"][np.arange(B) != 3].all()
        b = jax_live.push(feats[t], reset=reset)
        c = solo.push(feats[t], reset=reset)
        np.testing.assert_array_equal(a["valid"], b["valid"], err_msg=f"{t}")
        np.testing.assert_array_equal(a["valid"], c["valid"], err_msg=f"{t}")
        for k in ("theta", "kp_3d"):
            np.testing.assert_allclose(a[k], b[k], err_msg=f"t={t} {k}",
                                       **LIVE_TOL)
            np.testing.assert_allclose(a[k], c[k], err_msg=f"t={t} {k}",
                                       **LIVE_TOL)
    with pytest.raises(ValueError, match="must divide"):
        LiveSession(m["smpl"], m["gen"], m["vibe"], n_streams=6,
                    mesh=make_mesh(devices=CPU4))


def test_feature_extractor_mesh_matches_jax_mesh(m):
    """FeatureExtractor on 4 CPU replicas against the JAX extractor over
    make_mesh(4) (tests/test_preprocess.py's mesh test) on uint8 crops with
    a ragged last batch, rtol 1e-4, atol 1e-3; float32 crops against the
    port's one device (one JAX compile, not two)."""
    rs = m["rs"]
    jax_fe = JaxExtractor(m["jbb"], batch_size=8, crop_size=64,
                          conv_chunk=2, mesh=jax_make_mesh(4))
    fe = FeatureExtractor(m["bb"], batch_size=8, crop_size=64,
                          mesh=make_mesh(devices=CPU4))
    single = FeatureExtractor(m["bb"], batch_size=8, crop_size=64)
    u8 = rs.randint(0, 255, (10, 3, 64, 64)).astype(np.uint8)
    got = fe.features_from_crops(u8)
    np.testing.assert_allclose(got, jax_fe.features_from_crops(u8),
                               rtol=1e-4, atol=1e-3)
    for x in (u8, rs.randn(10, 3, 64, 64).astype(np.float32)):
        np.testing.assert_allclose(fe.features_from_crops(x),
                                   single.features_from_crops(x),
                                   rtol=1e-5, atol=1e-4)
    with pytest.raises(ValueError, match="must divide"):
        FeatureExtractor(m["bb"], batch_size=6, mesh=make_mesh(devices=CPU4))
