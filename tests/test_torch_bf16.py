"""bf16 compute in the port: the training gate, the dtype boundaries, the
`--precision` CLI of training and evaluation, and evaluate's tiers.

Training (`TrainHyper.compute_dtype="bfloat16"`) is held to the JAX
package's gate (tests/test_trainer.py::test_bf16_compute_gradient_agreement,
`tools/bf16_gate.py`): one window with SGD at lr 1 and update_theta_rate 1,
so the parameters' change is the gradient; update cosine > 0.98, relative
norm of the difference < 0.2, gen_loss and dis_loss within 5 %, every
metric float32 and finite, master parameters, gradients, optimizer state
and BN running statistics float32. Against the port's float32 step (same
dropout draws), against JAX `make_train_segment(compute_dtype="bfloat16")`
on the same weights and batch (dropout off on both sides; the one JAX
compile of this file), and at the fast-training batch splits 38+26 and
76+52. Small widths: seqlen 6, TePose 1 x 32 (fast encoder), GCN 3 / 2
scales, 64 vertices, batch 2 + 3.

The module boundaries where JAX promotes and torch would refuse: the
masked BN (float32 statistics, output in the weight's dtype) against
`bn_apply`, the discriminator with bf16 parameters against
`motion_discriminator_apply`, and the reduced SMPL joints on bf16 inputs
(float32 out), each against JAX with bf16 inputs.

Evaluation: every tier spelling parses, unknown ones exit naming the
choices; the bfloat16 tier's rollout (TePose and VIBE 1 x 32, 300
vertices, the synthetic 3DPW videos) stays within bars derived from a
float64 run of the port on this input: measured 0.589 mm (joints) and
1.264 mm (MPVPE) for bfloat16 and 9.5e-5 / 9.6e-5 mm for float32; the
bars are twice the bf16 measurement and 1e-3 mm for float32.
"""

import copy
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from tepose_tpu.models import gcn as JG
from tepose_tpu.models import smpl as JS
from tepose_tpu_torch import evaluate as port_evaluate
from tepose_tpu_torch import precision as P
from tepose_tpu_torch.eval.evaluator import (
    eval_rollout, make_sharded_eval_rollout)
from tepose_tpu_torch.models import gcn as TG
from tepose_tpu_torch.models import smpl as TS
from tepose_tpu_torch.models.tepose import (
    TePose, TePoseConfig, Vibe, VibeConfig)
from tepose_tpu_torch.parallel.mesh import make_mesh
from tepose_tpu_torch.train import run as TRUN
from tepose_tpu_torch.train import trainer as TT
from tepose_tpu_torch.weights import disc_jax_trees_from_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import bf16_gate  # noqa: E402
import make_torch_train_golden as tg  # noqa: E402

SPEC = dict(tg.FULL_SPEC, n_layers=1, hidden_size=32, num_verts=64, n_2d=2,
            n_3d=3, num_gcn_scales=3, num_g3d_scales=2, windows=(1,))


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs six workers on this host's
    cores, and these tests' small ops gain nothing from more."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _assert_gate(want, got):
    res = bf16_gate.gate(want, got)
    failed = {k: v for k, v in res.items() if not v[2]}
    assert not failed, failed
    return res


# ---------------------------------------------------------------- training


@pytest.fixture(scope="module")
def jax_window():
    """JAX's one bf16 window on SPEC's weights (its float32 segment is
    held to the port's by tests/test_torch_train.py)."""
    return bf16_gate.jax_window(SPEC, "bfloat16")


def test_bf16_gradient_agreement_with_f32():
    """The port's bf16 window against its float32 window, same dropout."""
    f32 = bf16_gate.port_window(SPEC, "cpu", None)
    bf16 = bf16_gate.port_window(SPEC, "cpu", "bfloat16")
    assert f32["float32_state"] == []
    res = _assert_gate(f32, bf16)
    # the step really ran in bf16: the discriminator's scalars are rounded
    assert res["dis_loss"][0] > 0


def test_bf16_matches_jax_bf16_segment(jax_window):
    """The port's bf16 window against JAX's bf16 segment (dropout off on
    both), at the gate's bars; JAX's bf16 run keeps float32 metrics too."""
    got = bf16_gate.port_window(SPEC, "cpu", "bfloat16", dropout=False)
    _assert_gate(jax_window, got)
    assert set(jax_window["metric_dtypes"].values()) == {"float32"}


@pytest.mark.parametrize("n_2d,n_3d", [(38, 26), (76, 52)],
                         ids=["batch64", "batch128"])
def test_fast_train_composition_bf16(n_2d, n_3d):
    """configs/fast_train.yaml's composition: its batch splits with bf16
    compute, port bf16 against port float32."""
    spec = dict(SPEC, n_2d=n_2d, n_3d=n_3d)
    f32 = bf16_gate.port_window(spec, "cpu", None)
    bf16 = bf16_gate.port_window(spec, "cpu", "bfloat16")
    _assert_gate(f32, bf16)
    assert np.linalg.norm(bf16["delta"]) > 0


def test_bf16_window_losses_are_float32_and_reach_master_params():
    """`window_losses` under bf16 returns float32 losses, terms and mean
    theta; the backward leaves float32 gradients on every master
    parameter it reaches, and the BN running statistics stay float32."""
    setup = tg.port_setup(SPEC, "cpu")
    hp = TT.TrainHyper(**{**setup["hp"].__dict__,
                          "compute_dtype": "bfloat16"})
    b2 = TT.upload(setup["batch_2d"], "cpu")
    b3 = TT.upload(setup["batch_3d"], "cpu")
    buf = TT.initial_theta_buf(b2, b3, 6)
    inp, buf, _, valid, targets = TT.assemble_window(b2, b3, buf, 0, hp,
                                                     None)
    gen_loss, dis_loss, ld, mean_theta = TT.window_losses(
        setup["gen"], setup["disc"], setup["smpl"], hp, setup["weights"],
        inp, targets, valid, buf, torch.from_numpy(setup["amass"][0]), None,
        SPEC["n_2d"])
    for t in (gen_loss, dis_loss, mean_theta, *ld.values()):
        assert t.dtype == torch.float32
    (gen_loss + dis_loss).backward()
    for m in (setup["gen"], setup["disc"]):
        for name, p in m.named_parameters():
            assert p.dtype == torch.float32, name
            assert p.grad is None or p.grad.dtype == torch.float32, name
    assert setup["gen"].encoder.gru_fwd.weight_ih_l0.grad.abs().sum() > 0
    assert setup["disc"].fc.weight.grad.abs().sum() > 0
    assert all(b.dtype == torch.float32
               for b in setup["disc"].buffers())


def test_masked_batchnorm_bf16_matches_bn_apply(rng):
    """bf16 weight and input: float32 statistics and running statistics,
    a bf16 output, as `bn_apply` with bf16 params (output within one bf16
    rounding, running statistics 1e-6)."""
    x = rng.randn(6, 5, 4, 3).astype(np.float32)
    mask = np.array([1, 0, 1, 1, 0, 1], bool)
    w = (1 + 0.1 * rng.randn(5)).astype(np.float32)
    b = (0.1 * rng.randn(5)).astype(np.float32)
    bn = TG.MaskedBatchNorm(5, "cpu")
    bn.train()
    xb = torch.from_numpy(x).bfloat16()
    out = functional_call(bn, {"weight": torch.from_numpy(w).bfloat16(),
                               "bias": torch.from_numpy(b).bfloat16()},
                          (xb, torch.from_numpy(mask)))
    want, state = JG.bn_apply(
        {"weight": jnp.asarray(w, jnp.bfloat16),
         "bias": jnp.asarray(b, jnp.bfloat16)},
        {"running_mean": jnp.zeros(5), "running_var": jnp.ones(5)},
        jnp.asarray(x, jnp.bfloat16), 1, True, jnp.asarray(mask))
    assert out.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want, np.float32), rtol=8e-3,
                               atol=8e-3)
    for k in ("running_mean", "running_var"):
        assert getattr(bn, k).dtype == torch.float32
        np.testing.assert_allclose(getattr(bn, k).numpy(),
                                   np.asarray(state[k]), atol=1e-6)


def test_discriminator_bf16_params_match_jax(rng):
    """The GCN discriminator with bf16 parameters (the constant
    adjacencies meet bf16 `A_res`) against JAX's with the same bf16
    parameters: P(real) within two bf16 units at 1 (2^-7), running
    statistics within one bf16 unit (2^-8) of each array's magnitude (the
    two packages round bf16 activations apart by an ulp here and there),
    output bf16 and statistics float32."""
    disc = TG.MotionDiscriminator(generator=torch.Generator().manual_seed(1),
                                  device="cpu", num_gcn_scales=3,
                                  num_g3d_scales=2)
    disc.train()
    # copies: the trees' arrays are views of the module's tensors, which
    # the port's forward updates in place
    jp, js = jax.tree_util.tree_map(
        lambda a: np.array(a), disc_jax_trees_from_state_dict(
            disc.state_dict()))
    x = (rng.randn(5, 6, 72) * 0.3).astype(np.float32)
    mask = np.array([1, 1, 0, 1, 1], bool)
    got = functional_call(disc, P.cast_params(disc, torch.bfloat16),
                          (torch.from_numpy(x).bfloat16(),
                           torch.from_numpy(mask)))
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), jp)
    apply = jax.jit(lambda p, s, x, m: JG.motion_discriminator_apply(
        p, s, x, num_gcn_scales=3, num_g3d_scales=2, train=True,
        row_mask=m))
    want, state = apply(jp, js, jnp.asarray(x, jnp.bfloat16),
                        jnp.asarray(mask))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().detach().numpy(),
                               np.asarray(want, np.float32), atol=2**-7)
    sd = disc.state_dict()
    for path, v in jax.tree_util.tree_leaves_with_path(state):
        key = ".".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        if key.endswith(("running_mean", "running_var")):
            assert sd[key].dtype == torch.float32, key
            np.testing.assert_allclose(
                sd[key].numpy(), np.asarray(v), rtol=0,
                atol=2**-8 * max(np.abs(np.asarray(v)).max(), 1e-6),
                err_msg=key)


def test_smpl_joints_reduced_bf16_inputs_match_jax(rng):
    """bf16 betas and rotations against the float32 model: float32 joints
    within 1e-5 m of JAX's promoted computation."""
    V, B = 64, 4
    betas = (rng.randn(B, 10) * 0.5).astype(np.float32)
    aa = torch.from_numpy((rng.randn(B, 24, 3) * 0.4).astype(np.float32))
    rot = TS.batch_rodrigues(aa).bfloat16()
    want = JS.smpl_joints_reduced(JS.synthetic_smpl_model(0, V),
                                  jnp.asarray(betas, jnp.bfloat16),
                                  jnp.asarray(rot.float().numpy(),
                                              jnp.bfloat16))
    got = TS.smpl_joints_reduced(TS.synthetic_smpl_model(0, V),
                                 torch.from_numpy(betas).bfloat16(), rot)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


# ---------------------------------------------------------------- CLIs


def test_train_precision_spellings_and_errors(monkeypatch, tmp_path):
    """train.py's spellings: bf16 / bfloat16 train in bf16, f32 / float32
    / default in float32; other values exit with the JAX CLI's messages,
    for the flag and for TRAIN.PRECISION."""
    for v in ("bf16", "bfloat16"):
        assert P.parse_train_precision(v) == "bfloat16"
    for v in ("f32", "float32", "default"):
        assert P.parse_train_precision(v) is None
    monkeypatch.setattr(sys, "argv", ["train", "--precision", "fp8"])
    with pytest.raises(SystemExit,
                       match=r"unknown --precision 'fp8' \(choose bf16 or "
                             r"float32\)"):
        TRUN.main()
    monkeypatch.setattr(sys, "argv", ["train", "--precision"])
    with pytest.raises(SystemExit, match="needs a value"):
        TRUN.main()
    from tepose_tpu_torch import config as TCFG

    cfg = TCFG.get_cfg_defaults()
    cfg.TRAIN.PRECISION = "fp8"
    cfg.OUTPUT_DIR = str(tmp_path)
    with pytest.raises(SystemExit, match=r"unknown TRAIN.PRECISION 'fp8'"):
        TRUN.build_train_loop(cfg, synthetic=True, device="cpu")


def _fast_train_cfg(tmp_path):
    """configs/fast_train.yaml as it stands (TRAIN.PRECISION bf16, batch
    128 = 76 + 52) with its width and video length cut for the CPU."""
    from tepose_tpu_torch import config as TCFG

    cfg = TCFG.update_cfg(os.path.join(REPO, "configs", "fast_train.yaml"))
    assert cfg.TRAIN.PRECISION == "bf16" and cfg.TRAIN.BATCH_SIZE == 128
    cfg.OUTPUT_DIR = str(tmp_path / "out")
    cfg.DATASET.VIDLEN = 12
    cfg.MODEL.TGRU.NUM_LAYERS, cfg.MODEL.TGRU.HIDDEN_SIZE = 1, 16
    cfg.TRAIN.MOT_DISCR.GCN.num_gcn_scales = 2
    cfg.TRAIN.MOT_DISCR.GCN.num_g3d_scales = 2
    cfg.TRAIN.END_EPOCH = 1
    cfg.TRAIN.PRETRAINED_REGRESSOR = ""
    path = tmp_path / "fast_train_cpu.yaml"
    path.write_text(cfg.dump())
    return str(path)


def test_fast_train_cli_on_cpu(monkeypatch, tmp_path):
    """`python -m tepose_tpu_torch.train --cfg <fast_train> --synthetic
    --gpu cpu --smoke-iters 1 --smoke-verts 64` trains one epoch in bf16
    from TRAIN.PRECISION (finite metrics, a checkpoint); an explicit
    `--precision float32` wins over the file. Scalars go to the JSONL
    file only: tensorboard's import (TensorFlow's) is blocked."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    argv = ["train", "--cfg", _fast_train_cfg(tmp_path), "--synthetic",
            "--gpu", "cpu", "--smoke-iters", "1", "--smoke-verts", "64"]
    with monkeypatch.context() as m:
        m.setattr(sys, "argv", argv + ["--precision", "float32"])
        m.setattr(TRUN, "run_train", lambda cfg, **kw: kw)
        assert P.parse_train_precision(TRUN.main()["precision"]) is None
    monkeypatch.setattr(sys, "argv", argv)
    loop = TRUN.main()
    assert loop.hp.compute_dtype == "bfloat16"
    assert (loop.hp.n_2d, loop.hp.n_3d) == (76, 52)
    assert os.path.isfile(os.path.join(loop.logdir, "checkpoint.npz"))
    import json

    lines = [json.loads(s) for s in
             open(os.path.join(loop.logdir, "metrics.jsonl"))]
    assert {"train_loss/gen_loss", "error/pa-mpjpe"} <= {d["tag"]
                                                        for d in lines}
    assert all(np.isfinite(d["value"]) for d in lines)


# ---------------------------------------------------------------- eval


def test_eval_tier_spellings():
    """Every spelling of the JAX evaluate.py maps to its tier; unknown
    ones exit naming the choices; the CLI default stays float32."""
    for tier, spellings in P.EVAL_TIERS.items():
        for s in spellings:
            assert P.eval_tier(s) == tier
    with pytest.raises(SystemExit, match="choose float32 .*tensorfloat32"
                                         ".*bfloat16"):
        P.eval_tier("fp8")
    import inspect

    assert inspect.signature(port_evaluate.run_eval).parameters[
        "precision"].default == "float32"


def test_tier_scope_sets_and_restores_flags():
    cuda, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    P.strict_f32()
    with P.tier_scope("tensorfloat32"):
        assert cuda.allow_tf32 and cudnn.allow_tf32
    with P.tier_scope("bfloat16"):
        assert not cuda.allow_tf32
        assert not cuda.allow_bf16_reduced_precision_reduction
    assert not cuda.allow_tf32 and not cudnn.allow_tf32
    assert cuda.allow_bf16_reduced_precision_reduction


V_EVAL, T_PAD = 300, 96     # the synthetic videos have 40-89 frames


@pytest.fixture(scope="module")
def eval_models():
    smpl = TS.synthetic_smpl_model(0, V_EVAL, device="cpu")
    gen = TePose(TePoseConfig(6, 1, 32),
                 generator=torch.Generator().manual_seed(0),
                 device="cpu").eval()
    vibe = Vibe(VibeConfig(16, 1, 32),
                generator=torch.Generator().manual_seed(1),
                device="cpu").eval()
    jreg = torch.as_tensor(port_evaluate.synthetic_j_regressor(V_EVAL))
    return smpl, gen, vibe, jreg


def _rollout(models, dtype, cd=None, mesh=None, windows=T_PAD - 5):
    smpl, gen, vibe, jreg = models
    data = port_evaluate.synthetic_eval_data()
    batch = port_evaluate.make_eval_batch(data, list(data), 6, T_PAD, 4)
    args = [torch.from_numpy(batch[k]).to(dtype)
            for k in ("feats", "theta_pseu", "theta_gt")]
    if mesh is not None:
        return make_sharded_eval_rollout(gen, vibe, smpl, jreg.to(dtype),
                                         mesh, cd)(*args, windows)
    return eval_rollout(gen, vibe, smpl, *args[:3], jreg.to(dtype),
                        windows, cd)


def test_bfloat16_tier_drift_against_float64(eval_models):
    """The bfloat16 tier's rollout and the float32 one against a float64
    run of the port (valid frames of each video): joints and MPVPE within
    the bars of the module docstring; bf16 really drifts more."""
    smpl, gen, vibe, jreg = eval_models
    ref = _rollout((copy.deepcopy(smpl).double(), copy.deepcopy(gen).double(),
                    copy.deepcopy(vibe).double(), jreg), torch.float64)
    bf16_models = (smpl, copy.deepcopy(gen).to(torch.bfloat16),
                   copy.deepcopy(vibe).to(torch.bfloat16), jreg)
    outs = {"float32": _rollout(eval_models, torch.float32),
            "bfloat16": _rollout(bf16_models, torch.float32,
                                 torch.bfloat16)}
    lengths = [len(d["features"])
               for d in port_evaluate.synthetic_eval_data().values()]
    dev = {}
    for tier, o in outs.items():
        assert o["pred_theta"].dtype == o["pred_j3d"].dtype == torch.float32
        dev[tier] = [1e3 * max(float((o[k][i, :n].double()
                                      - ref[k][i, :n]).abs().max())
                               for i, n in enumerate(lengths))
                     for k in ("pred_j3d", "mpvpe")]
    assert dev["float32"][0] <= 1e-3 and dev["float32"][1] <= 1e-3, dev
    assert dev["bfloat16"][0] <= 1.2 and dev["bfloat16"][1] <= 2.6, dev
    assert dev["bfloat16"][0] > 10 * dev["float32"][0], dev
    # --devices: the tier on every shard equals one device's (the first
    # 20 windows; the rollout is causal)
    sharded = _rollout(bf16_models, torch.float32, torch.bfloat16,
                       make_mesh(devices=["cpu"] * 2), windows=20)
    for k in ("pred_j3d", "pred_theta", "mpvpe"):
        np.testing.assert_allclose(np.asarray(sharded[k]),
                                   outs["bfloat16"][k][:, :25].numpy(),
                                   atol=1e-6, err_msg=k)


def test_run_eval_each_tier_on_cpu(eval_models, monkeypatch):
    """run_eval at each tier on the CPU with small models: finite metrics
    near the float32 tier's, and the flags restored after."""
    import argparse

    from tepose_tpu_torch import config as TCFG

    monkeypatch.setattr(port_evaluate, "build_models",
                        lambda cfg, synthetic, device: eval_models)
    cfg = TCFG.update_cfg(os.path.join(REPO, "configs",
                                       "repr_wopw_3dpw_model.yaml"))
    args = argparse.Namespace(dataset="3dpw", seq="", render=False,
                              render_plain=False, filter=False, plot=False,
                              frame=0, eval_batch=None, eval_bucket=None)
    P.strict_f32()
    base = port_evaluate.run_eval(cfg, args, synthetic=True, device="cpu")
    for precision in ("tf32", "bf16"):
        res = port_evaluate.run_eval(cfg, args, synthetic=True,
                                     device="cpu", precision=precision)
        assert not torch.backends.cuda.matmul.allow_tf32
        for k in ("mpjpe", "pa_mpjpe", "mpvpe", "accel_err"):
            assert np.isfinite(res[k])
            assert abs(res[k] - base[k]) <= 5.0, (k, res[k], base[k])
