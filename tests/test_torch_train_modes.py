"""The training segment's other modes in the port: `share_fake_disc`, and
the measurement knobs `mode` and `ablate`, held to what the JAX package's
tests require of its segment (tests/test_trainer.py:372-553), port against
port:

  * `share_fake_disc=True` (one fake-motion discriminator forward behind
    `SharedFakeDisc`) against the two-call step over 2 Adam windows, in
    float32 and under bf16 compute: losses rtol 2e-5 (atol 1e-6),
    parameters rtol 2e-4 (atol 2e-6), BN running statistics rtol 1e-5
    (atol 1e-7), the bars of `test_shared_fake_disc_grad_parity`; the
    shared step runs the discriminator twice a window, not three times;
  * `mode="forward"` and `mode="grad"` compute the first window's
    gen_loss and dis_loss of `mode="full"` (rtol 1e-5) and take no step;
    "grad" reports `grad_keepalive`, the sum of squares of every gradient
    leaf; unknown modes raise naming the argument;
  * `ablate="disc"`: the keypoint and SMPL terms equal the real step's,
    d_m_disc_fake is 0, the discriminator never runs; unknown values raise.

Small widths: seqlen 6, TePose 1 x 32 (fast encoder), GCN 3 / 2 scales, 64
vertices, batch 2 + 3, the batch of `make_torch_train_golden.make_batch`.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from tepose_tpu_torch.models.gcn import MotionDiscriminator
from tepose_tpu_torch.train import trainer as TT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import make_torch_train_golden as tg  # noqa: E402

SPEC = dict(tg.FULL_SPEC, n_layers=1, hidden_size=32, num_verts=64, n_2d=2,
            n_3d=3, num_gcn_scales=3, num_g3d_scales=2, windows=(2,),
            gen_lr=1e-4, disc_lr=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs six workers on this host's
    cores, and these tests' small ops gain nothing from more."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _segment(K=1, mode="full", ablate=None, **hp):
    setup = tg.port_setup(SPEC, "cpu")
    setup["hp"] = dataclasses.replace(setup["hp"], **hp)
    metrics = TT.train_segment(
        setup["gen"], setup["disc"], setup["smpl"], setup["gen_opt"],
        setup["disc_opt"], setup["hp"], setup["weights"], setup["batch_2d"],
        setup["batch_3d"], setup["amass"][:K],
        torch.Generator().manual_seed(5), mode=mode, ablate=ablate)
    return metrics, setup


def _count_disc_calls(monkeypatch):
    calls = [0]
    forward = MotionDiscriminator.forward

    def counted(self, *a, **kw):
        calls[0] += 1
        return forward(self, *a, **kw)

    monkeypatch.setattr(MotionDiscriminator, "forward", counted)
    return calls


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"],
                         ids=["float32", "bf16"])
def test_shared_fake_disc_matches_two_calls(compute_dtype, monkeypatch):
    calls = _count_disc_calls(monkeypatch)
    two, s_two = _segment(K=2, compute_dtype=compute_dtype)
    assert calls[0] == 6
    shared, s_shared = _segment(K=2, compute_dtype=compute_dtype,
                                share_fake_disc=True)
    assert calls[0] == 6 + 4
    assert shared.keys() == two.keys()
    for k in two:
        np.testing.assert_allclose(shared[k], two[k], rtol=2e-5, atol=1e-6,
                                   err_msg=k)
    for name in ("gen", "disc"):
        a, b = s_shared[name].state_dict(), s_two[name].state_dict()
        for k in b:
            tol = (dict(rtol=1e-5, atol=1e-7)
                   if k.endswith(("running_mean", "running_var"))
                   else dict(rtol=2e-4, atol=2e-6))
            assert a[k].dtype == b[k].dtype
            np.testing.assert_allclose(a[k].numpy(), b[k].numpy(),
                                       err_msg=f"{name} {k}", **tol)
    # both nets stepped twice, and the BN statistics moved
    for opt in ("gen_opt", "disc_opt"):
        assert s_shared[opt].param_groups[0]["count"] == 2
    assert s_shared["disc"].data_bn.running_mean.abs().sum() > 0


def test_shared_fake_disc_routes_each_gradient():
    """The shared forward's first output sends its gradient to the input
    only, the second to the discriminator's parameters only."""
    disc = MotionDiscriminator(generator=torch.Generator().manual_seed(1),
                               device="cpu", num_gcn_scales=3,
                               num_g3d_scales=2)
    disc.train()
    x = (torch.randn(4, 6, 72, generator=torch.Generator().manual_seed(0))
         * 0.3).requires_grad_(True)
    mask = torch.tensor([True, True, False, True])
    params = dict(disc.named_parameters())
    for out in (0, 1):
        x.grad = None
        disc.zero_grad(set_to_none=True)
        v = TT.SharedFakeDisc.apply(disc, list(params), mask, x,
                                    *params.values())
        torch.testing.assert_close(v[0], v[1], rtol=0, atol=0)
        v[out].sum().backward()
        x_reached = x.grad is not None and x.grad.abs().sum() > 0
        p_reached = disc.fc.weight.grad is not None and \
            disc.fc.weight.grad.abs().sum() > 0
        assert (x_reached, p_reached) == ((True, False) if out == 0
                                          else (False, True))


def test_measurement_modes_agree():
    """mode forward / grad / full: the same first-window losses; forward
    and grad leave parameters and optimizers untouched; grad reports the
    sum of squares of every gradient leaf."""
    outs, setups = {}, {}
    for mode in ("full", "grad", "forward"):
        outs[mode], setups[mode] = _segment(mode=mode)
    for mode in ("grad", "forward"):
        for k in ("gen_loss", "dis_loss"):
            np.testing.assert_allclose(outs[mode][k], outs["full"][k],
                                       rtol=1e-5, err_msg=f"{mode}:{k}")
    fresh = tg.port_setup(SPEC, "cpu")
    for mode in ("grad", "forward"):
        for name in ("gen", "disc"):
            for k, v in fresh[name].state_dict().items():
                if not k.endswith(("running_mean", "running_var")):
                    torch.testing.assert_close(
                        setups[mode][name].state_dict()[k], v, rtol=0,
                        atol=0)
        assert setups[mode]["gen_opt"].param_groups[0]["count"] == 0
    assert setups["full"]["gen_opt"].param_groups[0]["count"] == 1
    g = outs["grad"]["grad_keepalive"]
    assert np.isfinite(g) and g > 0
    np.testing.assert_allclose(
        g, tg.grad_sq((setups["grad"]["gen"], setups["grad"]["disc"])),
        rtol=1e-5)
    assert "grad_keepalive" not in outs["full"]
    assert all(p.grad is None for p in setups["forward"]["gen"].parameters())
    with pytest.raises(ValueError, match="mode"):
        _segment(mode="bogus")


def test_disc_ablation(monkeypatch):
    """ablate="disc" in mode forward: the non-adversarial terms equal the
    real step's bit for bit, the fake term is the surrogate's 0, and the
    discriminator never runs (its BN statistics stay put)."""
    calls = _count_disc_calls(monkeypatch)
    real, _ = _segment(mode="forward")
    assert calls[0] == 3
    ablated, setup = _segment(mode="forward", ablate="disc")
    assert calls[0] == 3
    for k in ("loss_kp_2d", "loss_kp_3d", "loss_pose", "loss_shape"):
        assert ablated[k] == real[k], k
    assert ablated["d_m_disc_fake"] == 0.0
    assert setup["disc"].data_bn.running_mean.abs().sum() == 0
    # in the full step the generator still learns from the other terms
    _, setup = _segment(ablate="disc")
    assert setup["gen_opt"].param_groups[0]["count"] == 1
    with pytest.raises(ValueError, match="ablate"):
        _segment(ablate="bogus")
