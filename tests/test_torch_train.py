"""Port parity of the training step: the vertex-free joints, the TePose
train forward, dropout, every loss term, window assembly, the optimizers
and their optax-order state, the plateau scheduler, and a 3-window training
segment against JAX `make_train_segment` (with the training golden's
writer held to the port at small width).

Small widths on the CPU in float32: TePose 1 x 16 GRUs (the forward test
2 x 16), the discriminator at 2 GCN / 2 G3D scales, 48-300 vertices,
seqlen 6, batch 3 + 4 rows. Dropout is off on both sides of the segment
comparisons and update_theta_rate is 1.0, so no random draw enters.
Tolerances are stated in each test.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tepose_tpu.models import smpl as JS
from tepose_tpu.models.tepose import TePoseConfig as JCfg, tepose_apply
from tepose_tpu.ops import geometry as JGEO
from tepose_tpu.train import loss as JL
from tepose_tpu.train import optim as JO
from tepose_tpu.train import trainer as JT
from tepose_tpu_torch.models import layers as TLY
from tepose_tpu_torch.models import smpl as TS
from tepose_tpu_torch.models.tepose import TePose, TePoseConfig
from tepose_tpu_torch.ops import geometry as TGEO
from tepose_tpu_torch.train import loss as TL
from tepose_tpu_torch.train import optim as TO
from tepose_tpu_torch.train import trainer as TT
from tepose_tpu_torch.weights import jax_tree_from_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import make_torch_train_golden as golden_writer  # noqa: E402

S = 6
SMALL_SPEC = dict(golden_writer.FULL_SPEC, n_layers=1, hidden_size=16,
                  num_verts=48, n_2d=3, n_3d=4, num_gcn_scales=2,
                  num_g3d_scales=2, disc_update_steps=2)


def _t(x):
    return torch.from_numpy(np.array(x))


# ----------------------------------------------------------- SMPL, forward


def test_smpl_joints_reduced_matches_jax_and_full_forward(rng):
    """1e-5 m against JAX's reduced joints and the port's full forward."""
    V, B = 300, 4
    betas = (rng.randn(B, 10) * 0.5).astype(np.float32)
    aa = (rng.randn(B, 24, 3) * 0.4).astype(np.float32)
    jm = JS.synthetic_smpl_model(0, V)
    tm = TS.synthetic_smpl_model(0, V)
    rot = np.asarray(JGEO.batch_rodrigues(jnp.asarray(aa)))
    want = np.asarray(JS.smpl_joints_reduced(jm, jnp.asarray(betas),
                                             jnp.asarray(rot)))
    got = TS.smpl_joints_reduced(tm, _t(betas), _t(rot)).numpy()
    full = TS.smpl_forward(tm, _t(betas), _t(rot))["joints49"].numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, full, atol=1e-5, rtol=0)
    for a, b in zip(TS.joint_reduction_tensors(tm),
                    JS.joint_reduction_tensors(jm)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


@pytest.mark.parametrize("fast", [False, True])
def test_tepose_train_forward_matches_jax(rng, fast):
    """Both encoder branches (B, 2, ...) through the plain and the fast
    encoder, dropout off, vertex-free joints: 1e-4 against
    `tepose_apply(train=True, compute_verts=False)`."""
    V = 64
    gen = TePose(TePoseConfig(S, 2, 16, fast_encoder=fast),
                 generator=torch.Generator().manual_seed(0), device="cpu")
    x = (rng.randn(3, S, 2133) * 0.3).astype(np.float32)
    with jax.default_matmul_precision("float32"):
        want = tepose_apply(jax_tree_from_state_dict(gen.state_dict()),
                            JS.synthetic_smpl_model(0, V), jnp.asarray(x),
                            JCfg(S, 2, 16, fast_encoder=fast), train=True,
                            compute_verts=False)
    got = gen(_t(x), TS.synthetic_smpl_model(0, V), train=True,
              compute_verts=False)
    assert set(got) == set(want) == {"theta", "kp_2d", "kp_3d", "rotmat"}
    for k in got:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), atol=1e-4, rtol=0,
                                   err_msg=k)
    # gradients reach the encoder through the per-call pack
    got["theta"].sum().backward()
    assert gen.encoder.gru_fwd.weight_ih_l0.grad.abs().sum() > 0
    assert gen.regressor.init_cam.grad.abs().sum() > 0


@pytest.mark.parametrize("case", ["identity", "x180", "y180", "z180",
                                  "axis180"])
def test_angle_axis_gradients_finite(case):
    """theta -> rotmat_to_angle_axis -> batch_rodrigues, the path of
    `smpl_losses`, at identity and 180-degree rotations: finite gradients
    equal to JAX's (1e-4)."""
    axis = {"identity": [0.0, 0.0, 0.0], "x180": [np.pi, 0, 0],
            "y180": [0, np.pi, 0], "z180": [0, 0, np.pi],
            "axis180": np.pi * np.array([1.0, 2.0, 2.0]) / 3.0}[case]
    R = np.asarray(JGEO.batch_rodrigues(
        jnp.asarray(np.asarray(axis, np.float32)[None])))
    if case == "identity":
        R = np.eye(3, dtype=np.float32)[None]
    gt = np.full((1, 3), 0.1, np.float32)

    def jloss(r):
        aa = JGEO.rotmat_to_angle_axis(r)
        return ((JGEO.batch_rodrigues(aa)
                 - JGEO.batch_rodrigues(jnp.asarray(gt))) ** 2).sum()

    want = np.asarray(jax.grad(jloss)(jnp.asarray(R)))
    r = _t(R).requires_grad_()
    aa = TGEO.rotmat_to_angle_axis(r)
    ((TGEO.batch_rodrigues(aa) - TGEO.batch_rodrigues(_t(gt))) ** 2).sum() \
        .backward()
    assert torch.isfinite(r.grad).all()
    np.testing.assert_allclose(r.grad.numpy(), want, atol=1e-4, rtol=1e-4)


def test_dropout_keeps_half_and_scales_by_two():
    x = torch.ones(200_000)
    g = torch.Generator().manual_seed(0)
    y = TLY.dropout(x, 0.5, g)
    kept = (y != 0).float().mean().item()
    assert abs(kept - 0.5) < 0.005            # 0.5 +- 4.5 sigma
    assert set(torch.unique(y).tolist()) == {0.0, 2.0}
    assert torch.equal(TLY.dropout(x, 0.5, None), x)
    y2 = TLY.dropout(x, 0.5, torch.Generator().manual_seed(0))
    assert torch.equal(y, y2)                 # the generator alone decides


def test_regressor_dropout_is_train_only(rng):
    gen = TePose(TePoseConfig(S, 1, 16),
                 generator=torch.Generator().manual_seed(0), device="cpu")
    smpl = TS.synthetic_smpl_model(0, 48)
    x = _t((rng.randn(2, S, 2133) * 0.3).astype(np.float32))
    g = torch.Generator().manual_seed(1)
    a = gen(x, smpl, train=True, generator=g, compute_verts=False)
    b = gen(x, smpl, train=True, generator=None, compute_verts=False)
    c = gen(x, smpl, generator=g)
    d = gen(x, smpl)
    assert not torch.allclose(a["theta"], b["theta"])
    assert torch.equal(c["theta"], d["theta"])


# ------------------------------------------------------------------- loss


def _loss_inputs(rng, n_2d=3, n_3d=4):
    B = n_2d + n_3d
    preds = {"kp_2d": rng.randn(B, 2, 49, 2), "kp_3d": rng.randn(B, 2, 49, 3),
             "theta": rng.randn(B, 2, 85) * 0.3}
    kp2 = rng.randn(B, 2, 49, 3)
    kp2[..., 2] = rng.rand(B, 2, 49)
    tgt = dict(kp_2d_gt=kp2, kp_3d_gt=rng.randn(n_3d, 2, 49, 3),
               theta_gt=rng.randn(n_3d, 2, 85) * 0.3,
               w_3d=np.array([1, 1, 0, 1]), w_smpl=np.array([1, 0, 1, 0]),
               valid=np.array([1, 0, 1, 1, 1, 1, 0]),
               prev_thetas=rng.randn(B, S - 1, 85) * 0.3,
               real_motion=rng.randn(B, S, 85) * 0.3)
    f32 = lambda d: {k: np.asarray(v, np.float32) for k, v in d.items()}
    return f32(preds), f32(tgt), rng.randn(72).astype(np.float32) * 0.1


def test_tepose_loss_terms_match_jax(rng):
    """Every term of `tepose_loss` and both totals, rtol 1e-5, with a
    deterministic stand-in discriminator; the three passes see the same
    row mask."""
    preds, tgt, w = _loss_inputs(rng)
    masks = {"jax": [], "port": []}

    def jdisc(x, m):
        masks["jax"].append(np.asarray(m))
        return jax.nn.sigmoid((x * w).sum((1, 2)) * 0.1)

    def tdisc(x, m):
        masks["port"].append(m.numpy())
        return torch.sigmoid((x * _t(w)).sum((1, 2)) * 0.1)

    jg, jd, jdict = JL.tepose_loss(
        {k: jnp.asarray(v) for k, v in preds.items()}, n_2d=3,
        disc_fn=jdisc, **{k: jnp.asarray(v) for k, v in tgt.items()})
    tg, td, tdict = TL.tepose_loss(
        {k: _t(v) for k, v in preds.items()}, n_2d=3, disc_fn=tdisc,
        **{k: _t(v) for k, v in tgt.items()})
    assert tdict.keys() == jdict.keys()
    for k in tdict:
        np.testing.assert_allclose(float(tdict[k]), float(jdict[k]),
                                   rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(tg), float(jg), rtol=1e-5)
    np.testing.assert_allclose(float(td), float(jd), rtol=1e-5)
    assert len(masks["port"]) == 3
    for a, b in zip(masks["port"], masks["jax"]):
        np.testing.assert_array_equal(a, b)


def test_loss_helpers_match_jax(rng):
    """The Wasserstein, smoothness and masked-mean helpers, rtol 1e-5, and
    the empty-mask zeros."""
    rv, fv = rng.rand(6).astype(np.float32), rng.rand(6).astype(np.float32)
    mr = np.array([1, 0, 1, 1, 0, 1], bool)
    mf = np.array([0, 1, 1, 0, 0, 1], bool)
    th = rng.randn(5, 6, 85).astype(np.float32)
    m5 = np.array([1, 0, 1, 1, 0], bool)
    pairs = [
        (TL.encoder_disc_wasserstein_loss(_t(rv), _t(mr)),
         JL.encoder_disc_wasserstein_loss(rv, mr)),
        (TL.adv_disc_wasserstein_loss(_t(rv), _t(fv), _t(mr), _t(mf))[2],
         JL.adv_disc_wasserstein_loss(rv, fv, mr, mf)[2]),
        (TL.adv_disc_l2_loss(_t(rv), _t(fv), _t(mr), _t(mf))[0],
         JL.adv_disc_l2_loss(rv, fv, mr, mf)[0]),
        (TL.smooth_pose_loss(_t(th)), JL.smooth_pose_loss(th)),
        (TL.smooth_pose_loss(_t(th), _t(m5)), JL.smooth_pose_loss(th, m5)),
        (TL.smooth_shape_loss(_t(th), _t(m5)), JL.smooth_shape_loss(th, m5)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    none = np.zeros(6, bool)
    assert float(TL.encoder_disc_l2_loss(_t(rv), _t(none))) == 0.0
    assert float(TL._masked_row_mean(_t(th), _t(np.zeros(5, bool)))) == 0.0


# ---------------------------------------------------------------- trainer


def _window_batches(rng, n_2d=3, n_3d=4, VL=10):
    spec = dict(SMALL_SPEC, n_2d=n_2d, n_3d=n_3d, vidlen=VL, data_seed=3)
    return golden_writer.make_batch(spec)


@pytest.mark.parametrize("rate", [0.0, 1.0])
def test_assemble_window_matches_jax(rng, rate):
    """Every window of the batch, with 2D channel switches inside it:
    input, feedback buffer, update and validity masks and targets equal to
    JAX's (1e-6; the channel pick is a 0/1 weighted sum)."""
    data = _window_batches(rng)
    hp = TT.TrainHyper(seqlen=S, n_2d=3, n_3d=4, update_theta_rate=rate)
    jhp = JT.TrainHyper(seqlen=S, n_2d=3, n_3d=4, update_theta_rate=rate)
    b2 = {k: _t(v) for k, v in data["batch_2d"].items()}
    b3 = {k: _t(v) for k, v in data["batch_3d"].items()}
    jb2 = {k: jnp.asarray(v) for k, v in data["batch_2d"].items()}
    jb3 = {k: jnp.asarray(v) for k, v in data["batch_3d"].items()}
    buf = TT.initial_theta_buf(b2, b3, S)
    jbuf = jnp.asarray(buf.numpy())
    switched = 0
    for j in range(10 - S + 1):
        got = TT.assemble_window(b2, b3, buf, j, hp, None)
        want = JT.assemble_window(jb2, jb3, jbuf, j, jhp,
                                  jax.random.PRNGKey(j))
        for a, b in zip(got[:4], want[:4]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
        for k in want[4]:
            np.testing.assert_allclose(got[4][k].numpy(),
                                       np.asarray(want[4][k]), atol=1e-6)
        switched += int((got[2][:3] == 0).sum()) if rate else 0
        # feed a fresh buffer forward so the where() picks differ per row
        buf = got[1] + 0.01
        jbuf = jnp.asarray(buf.numpy())
    if rate:
        assert switched > 0        # a channel switch forced the reset


def test_optimizers_match_optax():
    """Adam and SGD with weight decay over 5 steps, the learning rate
    changed by set_lr after step 2: parameters (1e-6) and the optax-order
    state leaves (1e-6) equal optax's."""
    rs = np.random.RandomState(0)
    shapes = {"b": {"w": (3, 2), "a": (4,)}, "a": (2,)}
    init = {"b": {"w": rs.randn(3, 2), "a": rs.randn(4)}, "a": rs.randn(2)}
    grads = [{"b": {"w": rs.randn(3, 2), "a": rs.randn(4)},
              "a": rs.randn(2)} for _ in range(5)]
    del shapes

    class M(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.b = torch.nn.Module()
            self.b.w = torch.nn.Parameter(_t(init["b"]["w"]).float())
            self.b.a = torch.nn.Parameter(_t(init["b"]["a"]).float())
            self.a = torch.nn.Parameter(_t(init["a"]).float())

    for name in ("adam", "sgd"):
        tx = JO.make_optimizer(name, 1e-2, 1e-3)
        params = jax.tree_util.tree_map(
            lambda x: jnp.asarray(x, jnp.float32), init)
        state = tx.init(params)
        m = M()
        opt = TO.make_optimizer(name, m, 1e-2, 1e-3)
        for i, g in enumerate(grads):
            if i == 2:
                state = JO.set_lr(state, 3e-3)
                TO.set_lr(opt, 3e-3)
            jg = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float32),
                                        g)
            upd, state = tx.update(jg, state, params)
            params = optax.apply_updates(params, upd)
            m.b.w.grad = _t(g["b"]["w"]).float()
            m.b.a.grad = _t(g["b"]["a"]).float()
            m.a.grad = _t(g["a"]).float()
            TO.take_step(opt)
        for got, want in ((m.a, params["a"]), (m.b.a, params["b"]["a"]),
                          (m.b.w, params["b"]["w"])):
            np.testing.assert_allclose(got.detach().numpy(),
                                       np.asarray(want), atol=1e-6)
        leaves = jax.tree_util.tree_leaves(state)
        mine = TO.opt_state_leaves(opt)
        assert len(mine) == len(leaves)
        for a, b in zip(mine, leaves):
            assert a.shape == np.asarray(b).shape
            np.testing.assert_allclose(a, np.asarray(b), atol=1e-6)
        assert TO.get_lr(opt) == pytest.approx(JO.get_lr(state))


def test_plateau_scheduler_copy_matches():
    metrics = [10.0, 9.0, 9.0, 9.5, 9.0, 8.99, 9.2, 9.3, 9.1, 7.0, 7.5]
    a, b = TO.ReduceLROnPlateau(patience=2), JO.ReduceLROnPlateau(patience=2)
    la = lb = 1e-3
    for v in metrics:
        la, lb = a.step(v, la), b.step(v, lb)
        assert la == lb and a.state_dict() == b.state_dict()
    c = TO.ReduceLROnPlateau()
    c.load_state_dict(b.state_dict())
    assert c.state_dict() == b.state_dict()


# ---------------------------------------------------------------- segment


@pytest.fixture(scope="module")
def jax_segments():
    """The JAX segment on SMALL_SPEC for K = 1 and 3 ("full") and K = 1
    ("grad"): the module's three segment compiles."""
    return golden_writer.jax_segments(SMALL_SPEC)


@pytest.mark.parametrize("K", [1, 3])
def test_segment_matches_make_train_segment(jax_segments, K):
    """K windows from the same start: one 3D row turns invalid at window 2,
    one in three 3D rows has w_smpl = 0, disc_update_steps = 2.
    Mean losses rtol 1e-5; parameters within 2 K lr max abs (an Adam step
    moves an element by about lr at most, so where a gradient element sits
    at float noise the two runs may step it opposite ways) and RMS within
    0.05 lr; BN statistics 1e-4 of each array's magnitude; the update
    cadence and the optimizer state in optax order (counts equal; each
    moment array within 1e-2 of its norm: elements of float-noise size
    differ more between the two summation orders)."""
    want = jax_segments[K]
    setup = golden_writer.port_setup(SMALL_SPEC, "cpu")
    got = golden_writer.port_segment(setup, K)
    for k, v in want["losses"].items():
        np.testing.assert_allclose(got["losses"][k], v, rtol=1e-5, err_msg=k)
    for group, lr in (("gen", SMALL_SPEC["gen_lr"]),
                      ("disc", SMALL_SPEC["disc_lr"])):
        assert got[group].keys() == want[group].keys()
        d = np.concatenate([(got[group][k] - want[group][k]).ravel()
                            for k in want[group]])
        assert np.abs(d).max() <= 2 * K * lr, (group, np.abs(d).max())
        assert np.sqrt((d ** 2).mean()) <= 0.05 * lr, group
    for k, v in want["disc_state"].items():
        np.testing.assert_allclose(got["disc_state"][k], v, rtol=0,
                                   atol=1e-4 * max(np.abs(v).max(), 1e-6),
                                   err_msg=k)
    # cadence: the generator steps every window, the discriminator on
    # windows 0 and 2 (disc_update_steps = 2)
    n_disc = len(range(0, K, 2))
    assert setup["gen_opt"].param_groups[0]["count"] == K
    assert setup["disc_opt"].param_groups[0]["count"] == n_disc
    for opt, leaves in ((setup["gen_opt"], want["gen_opt"]),
                        (setup["disc_opt"], want["disc_opt"])):
        mine = TO.opt_state_leaves(opt)
        assert len(mine) == len(leaves)
        assert [int(x) for x in mine[:1]] == [int(leaves[0])]
        for a, b in zip(mine[1:], leaves[1:]):
            assert a.shape == b.shape
            assert np.linalg.norm(a - b) <= 1e-2 * np.linalg.norm(b) + 1e-12


def test_golden_writer_matches_port_small(jax_segments):
    """The writer's golden at small width against the port on the CPU, at
    chip_smoke.py's bars (`golden_deviation`)."""
    golden = golden_writer.golden_from(SMALL_SPEC, jax_segments)
    golden["spec"] = SMALL_SPEC
    for K in SMALL_SPEC["windows"]:
        setup = golden_writer.port_setup(SMALL_SPEC, "cpu")
        np.testing.assert_array_equal(golden_writer.weight_checksums(setup),
                                      golden["weight_checksums"])
        dev = golden_writer.golden_deviation(
            golden, golden_writer.port_segment(setup, K), K)
        assert set(dev) >= {"losses", "bn_stats", "gen_leaves",
                            "disc_leaves", "gen_leaves_rms",
                            "disc_leaves_rms", "adam_steps"}
        for k, (d, bar) in dev.items():
            assert d <= bar, (K, k, d, bar)


@pytest.mark.parametrize("fault", ["skipped_step", "empty_step"])
def test_golden_deviation_catches_a_missing_update(jax_segments, monkeypatch,
                                                   fault):
    """chip_smoke.py's golden bars fail a K = 1 segment whose generator
    update is skipped (no step call) or empty (a step at lr 0), though
    every leaf stays inside the 2 K lr max-abs bar: the leaf RMS (0.05 lr)
    and, for the skipped step, the Adam step count give it away."""
    golden = golden_writer.golden_from(SMALL_SPEC, jax_segments)
    golden["spec"] = SMALL_SPEC
    setup = golden_writer.port_setup(SMALL_SPEC, "cpu")
    if fault == "skipped_step":
        take_step = TT.take_step
        monkeypatch.setattr(TT, "take_step", lambda opt: None
                            if opt is setup["gen_opt"] else take_step(opt))
    else:
        TO.set_lr(setup["gen_opt"], 0.0)
    dev = golden_writer.golden_deviation(
        golden, golden_writer.port_segment(setup, 1), 1)
    failed = {k for k, (d, bar) in dev.items() if not d <= bar}
    assert failed == ({"gen_leaves_rms", "adam_steps"}
                      if fault == "skipped_step" else {"gen_leaves_rms"})


def test_committed_golden_spec_and_size():
    """The committed full-width golden is small, names the full spec and
    holds every field chip_smoke.py reads."""
    path = golden_writer.GOLDEN_PATH
    assert os.path.getsize(path) < 1 << 20
    golden = golden_writer.load_golden(path)
    assert golden["spec"] == golden_writer.FULL_SPEC
    for K in golden["spec"]["windows"]:
        assert np.isfinite(float(golden[f"K{K}/loss/gen_loss"]))
        for k in golden_writer.GEN_LEAVES:
            assert f"K{K}/gen/{k}" in golden
        assert int(golden[f"K{K}/adam_steps/gen"]) == K
        assert int(golden[f"K{K}/adam_steps/disc"]) == K
    assert float(golden["grad_sq"]) > 0
