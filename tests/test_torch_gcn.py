"""Port parity of the motion discriminator: the graph copies, the row-masked
BatchNorm, the MS-GCN / MS-G3D blocks and the whole discriminator's output,
BN state and gradients against `jax.grad`, and the weight mapping between
the JAX (params, state) trees and the module's state_dict.

Small inputs (N = 5 sequences of T = 6 frames) on the CPU in float32; the
discriminator at 3 GCN / 2 G3D scales. Tolerances: rtol 1e-5 / atol 1e-6
for BN outputs and statistics, rtol 1e-4 / atol 1e-6 for the
discriminator's outputs, state and gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tepose_tpu.models import gcn as JG
from tepose_tpu.models import graph as JGR
from tepose_tpu_torch.models import gcn as TG
from tepose_tpu_torch.models import graph as TGR
from tepose_tpu_torch.weights import (
    DISC_STATE_LEAVES, disc_jax_trees_from_state_dict,
    disc_state_dict_from_jax, flatten_tree)

N, T = 5, 6
SCALES = dict(num_gcn_scales=3, num_g3d_scales=2)
TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs six workers on this host's
    cores, and these tests' small ops gain nothing from more."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def test_graph_copy_matches():
    A = TGR.smpl_graph_binary()
    np.testing.assert_array_equal(A, JGR.smpl_graph_binary())
    assert TGR.NEIGHBOR == JGR.NEIGHBOR
    for k in range(4):
        for ws in (False, True):
            np.testing.assert_array_equal(TGR.k_adjacency(A, k, ws),
                                          JGR.k_adjacency(A, k, ws))
    np.testing.assert_array_equal(TGR.normalize_adjacency(A),
                                  JGR.normalize_adjacency(A))
    for s in (1, 6, 13):
        np.testing.assert_array_equal(TGR.multi_scale_adjacency(A, s),
                                      JGR.multi_scale_adjacency(A, s))
    st = TGR.spatial_temporal_adjacency(A, 3)
    np.testing.assert_array_equal(st, JGR.spatial_temporal_adjacency(A, 3))
    np.testing.assert_array_equal(TGR.multi_scale_adjacency(st, 6),
                                  JGR.multi_scale_adjacency(st, 6))


# (train, row mask): eval, train unmasked, train with a mixed mask, train
# with every row masked (the running statistics must not move)
BN_CASES = {"eval": (False, None), "train": (True, None),
            "train_mixed_mask": (True, [1, 0, 1, 1, 0]),
            "train_all_masked": (True, [0, 0, 0, 0, 0])}


@pytest.mark.parametrize("case", sorted(BN_CASES))
def test_bn_apply_matches_jax(rng, case):
    train, mask = BN_CASES[case]
    C = 7
    x = (rng.randn(N, C, T, 4) * 2 + 1).astype(np.float32)
    params = {"weight": rng.rand(C).astype(np.float32) + 0.5,
              "bias": rng.randn(C).astype(np.float32)}
    state = {"running_mean": rng.randn(C).astype(np.float32),
             "running_var": rng.rand(C).astype(np.float32) + 0.5}
    m = None if mask is None else np.asarray(mask, np.float32)
    want, want_state = JG.bn_apply(
        params, state, jnp.asarray(x), 1, train,
        None if m is None else jnp.asarray(m))
    bn = TG.MaskedBatchNorm(C, "cpu")
    bn.load_state_dict({k: torch.from_numpy(v) for k, v in
                        {**params, **state}.items()})
    bn.train(train)
    got = bn(torch.from_numpy(x), None if m is None else torch.from_numpy(m))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    for k in state:
        np.testing.assert_allclose(getattr(bn, k).numpy(),
                                   np.asarray(want_state[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    if case in ("eval", "train_all_masked"):
        for k in state:
            np.testing.assert_array_equal(getattr(bn, k).numpy(), state[k])


@pytest.fixture(scope="module")
def disc_pair():
    jp, js = jax.device_get(JG.motion_discriminator_init(
        jax.random.PRNGKey(3), **SCALES))
    disc = TG.MotionDiscriminator(generator=torch.Generator().manual_seed(0),
                                  device="cpu", **SCALES)
    disc.load_state_dict(disc_state_dict_from_jax(jp, js))
    return jp, js, disc


def _inputs(seed=0):
    rs = np.random.RandomState(seed)
    x = (rs.randn(N, T, 72) * 0.3).astype(np.float32)
    mask = np.array([1, 1, 0, 1, 0], np.float32)
    w = rs.randn(N).astype(np.float32)
    return x, mask, w


@pytest.mark.parametrize("train,masked", [(True, True), (True, False),
                                          (False, False)])
def test_discriminator_output_state_and_grads_match_jax(disc_pair, train,
                                                        masked):
    jp, js, disc0 = disc_pair
    x, mask, w = _inputs()
    m = mask if masked else None

    def jloss(params, xx):
        out, new_state = JG.motion_discriminator_apply(
            params, js, xx, train=train,
            row_mask=None if m is None else jnp.asarray(m), **SCALES)
        return (out * w).sum(), (out, new_state)

    with jax.default_matmul_precision("float32"):
        (_, (want, want_state)), (g_params, g_x) = jax.value_and_grad(
            jloss, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(x))

    disc = TG.MotionDiscriminator(generator=torch.Generator().manual_seed(0),
                                  device="cpu", **SCALES)
    disc.load_state_dict(disc0.state_dict())
    disc.train(train)
    xt = torch.from_numpy(x).requires_grad_()
    out = disc(xt, None if m is None else torch.from_numpy(m))
    (out * torch.from_numpy(w)).sum().backward()

    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **TOL)
    _, got_state = disc_jax_trees_from_state_dict(disc.state_dict())
    want_flat, got_flat = flatten_tree(want_state), flatten_tree(got_state)
    assert want_flat.keys() == got_flat.keys()
    for k in want_flat:
        np.testing.assert_allclose(got_flat[k], want_flat[k], **TOL,
                                   err_msg=k)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_x), **TOL)
    grads = {n: p.grad.numpy() for n, p in disc.named_parameters()}
    want_g = {k.replace("/", "."): v
              for k, v in flatten_tree(g_params).items()}
    assert grads.keys() == want_g.keys()
    for k in grads:
        np.testing.assert_allclose(grads[k], want_g[k], **TOL, err_msg=k)


def test_unfold_temporal_windows_matches_jax(rng):
    x = rng.randn(2, 3, 7, 24).astype(np.float32)
    for w in (1, 3, 5):
        np.testing.assert_array_equal(
            TG.unfold_temporal_windows(torch.from_numpy(x), w).numpy(),
            np.asarray(JG.unfold_temporal_windows(jnp.asarray(x), w)))


def test_weights_round_trip(disc_pair):
    jp, js, disc = disc_pair
    params, state = disc_jax_trees_from_state_dict(disc.state_dict())
    for mine, theirs in ((params, jp), (state, js)):
        a, b = flatten_tree(mine), flatten_tree(theirs)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert {k.rsplit(".", 1)[-1] for k, _ in disc.named_buffers()} \
        == set(DISC_STATE_LEAVES)
    assert {n.replace(".", "/") for n, _ in disc.named_parameters()} \
        == set(flatten_tree(jp))


def test_seeded_init_is_deterministic_and_in_bounds():
    def make(seed):
        return TG.MotionDiscriminator(
            generator=torch.Generator().manual_seed(seed), device="cpu",
            **SCALES).state_dict()

    a, b, c = make(0), make(0), make(1)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["fc.weight"], c["fc.weight"])
    assert a["sgcn1.A_res"].abs().max() <= 1e-6
    assert a["residual_2.conv.weight"].abs().max() <= 1 / np.sqrt(64)
    assert torch.equal(a["data_bn.running_var"], torch.ones(72))
    jp, js = JG.motion_discriminator_init(jax.random.PRNGKey(0), **SCALES)
    for k, v in flatten_tree(jax.device_get((jp, js))).items():
        key = k.split("/", 1)[1].replace("/", ".")
        assert tuple(a[key].shape) == v.shape, k
