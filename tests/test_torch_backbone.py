"""Port parity of the ResNet-50 backbone (`models/backbone.py`).

The BN folding and the torch-checkpoint converter against their JAX copies,
the folded ResNet-50 features and single-frame HMR against the JAX functions
on the same params (loaded `strict=True`), `normalize_crop`, the seeded
init and the JAX tree <-> state_dict round trip. 64 x 64 crops on the CPU,
atol 5e-4 as tests/test_backbone.py holds the JAX backbone.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tepose_tpu.models import backbone as JB
from tepose_tpu.models.regressor import regressor_init
from tepose_tpu.models.smpl import synthetic_smpl_model as jax_smpl
from tepose_tpu_torch.models import backbone as PB
from tepose_tpu_torch.models.regressor import Regressor
from tepose_tpu_torch.models.smpl import synthetic_smpl_model
from tepose_tpu_torch.weights import (
    flatten_tree, jax_tree_from_state_dict, state_dict_from_jax_tree)

pytestmark = pytest.mark.heavy

ATOL = 5e-4
jax_features = jax.jit(JB.resnet50_features)


def _hmr_state_dict(seed=0):
    """An HMR-style torch ResNet-50 state_dict (numpy values) with random
    BN statistics, so that folding is exercised; conv weights N(0, 1/fan_in)
    keep the features O(1-100)."""
    rs = np.random.RandomState(seed)
    sd = {}

    def conv(name, o, i, k):
        sd[f"{name}.weight"] = (rs.randn(o, i, k, k) / np.sqrt(i * k * k)
                                ).astype(np.float32)

    def bn(name, c):
        sd[f"{name}.weight"] = rs.uniform(0.5, 1.0, c).astype(np.float32)
        sd[f"{name}.bias"] = rs.uniform(-0.2, 0.2, c).astype(np.float32)
        sd[f"{name}.running_mean"] = rs.uniform(-0.2, 0.2, c).astype(
            np.float32)
        sd[f"{name}.running_var"] = rs.uniform(0.5, 1.5, c).astype(np.float32)

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    inplanes = 64
    for li, blocks in enumerate(JB.BOTTLENECK_LAYERS, start=1):
        planes = 64 * 2 ** (li - 1)
        for bi in range(blocks):
            p = f"layer{li}.{bi}"
            conv(f"{p}.conv1", planes, inplanes, 1)
            bn(f"{p}.bn1", planes)
            conv(f"{p}.conv2", planes, planes, 3)
            bn(f"{p}.bn2", planes)
            conv(f"{p}.conv3", planes * 4, planes, 1)
            bn(f"{p}.bn3", planes * 4)
            if bi == 0:
                conv(f"{p}.downsample.0", planes * 4, inplanes, 1)
                bn(f"{p}.downsample.1", planes * 4)
            inplanes = planes * 4
    return sd


@pytest.fixture(scope="module")
def converted():
    sd = _hmr_state_dict()
    tree = PB.convert_torch_resnet50(sd)
    model = PB.ResNet50(device="cpu")
    model.load_state_dict(state_dict_from_jax_tree(tree), strict=True)
    return sd, tree, model.eval()


def test_fold_bn_matches_jax(rng):
    w = rng.randn(8, 4, 3, 3).astype(np.float32)
    bn = {"weight": rng.rand(8), "bias": rng.randn(8),
          "running_mean": rng.randn(8), "running_var": rng.rand(8) + 0.1}
    for a, b in zip(PB._fold_bn(w, bn), JB._fold_bn(w, bn)):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_convert_matches_jax(converted):
    sd, tree, _ = converted
    want = flatten_tree(jax.device_get(JB.convert_torch_resnet50(sd)))
    got = flatten_tree(tree)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # tensors are accepted as values too
    tsd = {k: torch.from_numpy(v) for k, v in sd.items()}
    np.testing.assert_array_equal(
        PB.convert_torch_resnet50(tsd)["layer4"][2]["conv3"]["w"],
        tree["layer4"][2]["conv3"]["w"])


def test_features_match_jax(converted, rng):
    _, tree, model = converted
    x = rng.randn(2, 3, 64, 64).astype(np.float32)
    want = np.asarray(jax_features(tree, jnp.asarray(x)))
    with torch.inference_mode():
        got = PB.resnet50_features(model, torch.from_numpy(x))
    assert 1.0 < np.abs(want).max() < 1e3   # the bar means something
    assert got.shape == (2, 2048) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    with torch.inference_mode():
        np.testing.assert_array_equal(model(torch.from_numpy(x)).numpy(),
                                      got.numpy())


def test_random_init_features_match_jax(rng):
    """JAX's own `resnet50_init` tree in the port: He-init, zero biases and
    no BN make the net positively homogeneous, so the features are large
    (hundreds at 64 x 64); the bar is relative to their size."""
    tree = jax.device_get(JB.resnet50_init(jax.random.PRNGKey(0)))
    model = PB.ResNet50(device="cpu")
    model.load_state_dict(state_dict_from_jax_tree(tree), strict=True)
    x = rng.randn(1, 3, 64, 64).astype(np.float32)
    want = np.asarray(jax_features(tree, jnp.asarray(x)))
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    scale = np.abs(want).max()
    assert scale > 10.0
    np.testing.assert_allclose(got, want, atol=ATOL * scale / 10.0, rtol=0)


def test_resnet50_init_seeded_and_he_scaled():
    torch.manual_seed(123)
    rng_state = torch.get_rng_state()
    a = PB.resnet50_init(torch.Generator().manual_seed(2), "cpu")
    b = PB.resnet50_init(torch.Generator().manual_seed(2), "cpu")
    c = PB.resnet50_init(torch.Generator().manual_seed(3), "cpu")
    assert torch.equal(torch.get_rng_state(), rng_state)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["stem.w"], sc["stem.w"])
    for k, v in sa.items():
        if k.endswith(".b"):
            assert not v.any(), k
        else:
            fan_in = v[0].numel()
            std = float(v.std())
            assert abs(std * np.sqrt(fan_in / 2.0) - 1.0) < 0.1, (k, std)
    assert a.memory_format == torch.contiguous_format


def test_serving_layout_keeps_the_features(converted, rng):
    """`to_serving_layout` casts a copy once and puts reduced precision in
    channels_last; the activations follow the weights' layout, which
    changes no feature beyond summation order."""
    _, _, model = converted
    assert PB.to_serving_layout(model, None) is model
    assert PB.to_serving_layout(model, torch.float32) is model
    b16 = PB.to_serving_layout(model, torch.bfloat16)
    assert b16.dtype == torch.bfloat16 and model.dtype == torch.float32
    assert b16.memory_format == torch.channels_last
    assert b16.layer3[1].conv2.w.is_contiguous(
        memory_format=torch.channels_last)
    nhwc = copy.deepcopy(model).to(memory_format=torch.channels_last)
    assert nhwc.memory_format == torch.channels_last
    x = torch.from_numpy(rng.randn(2, 3, 64, 64).astype(np.float32))
    with torch.inference_mode():
        a, b = model(x), nhwc(x)
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0,
                               atol=1e-5 * float(a.abs().max()))


def test_state_dict_keys_are_jax_tree_paths_and_round_trip():
    tree = jax.device_get(JB.resnet50_init(jax.random.PRNGKey(1)))
    model = PB.resnet50_init(torch.Generator().manual_seed(0), "cpu")
    want = {k.replace("/", ".") for k in flatten_tree(tree)}
    assert set(model.state_dict()) == want
    back = jax_tree_from_state_dict(model.state_dict())
    assert isinstance(back["layer3"], list) and len(back["layer3"]) == 6
    assert "downsample" in back["layer2"][0]
    assert "downsample" not in back["layer2"][1]
    flat = flatten_tree(back)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(flat[k.replace(".", "/")], v.numpy())
    again = PB.ResNet50(device="cpu")
    again.load_state_dict(state_dict_from_jax_tree(back), strict=True)
    assert all(torch.equal(v, again.state_dict()[k])
               for k, v in model.state_dict().items())


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_normalize_crop_matches_jax(rng, dtype):
    x = (rng.rand(2, 3, 8, 8) * 255).astype(dtype)
    want = np.asarray(JB.normalize_crop(jnp.asarray(x)))
    got = PB.normalize_crop(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(PB.IMAGENET_MEAN, JB.IMAGENET_MEAN)
    np.testing.assert_array_equal(PB.IMAGENET_STD, JB.IMAGENET_STD)


@pytest.mark.parametrize("n_iter", [1, 3])
def test_hmr_forward_matches_jax(converted, rng, n_iter):
    _, tree, model = converted
    jreg = jax.device_get(regressor_init(jax.random.PRNGKey(4)))
    reg = Regressor(generator=torch.Generator().manual_seed(0), device="cpu")
    reg.load_state_dict(state_dict_from_jax_tree(jreg), strict=True)
    x = rng.randn(2, 3, 64, 64).astype(np.float32)
    xf_want, want = JB.hmr_forward(tree, jreg, jax_smpl(0, 64),
                                   jnp.asarray(x), n_iter=n_iter,
                                   return_features=True)
    with torch.inference_mode():
        xf, got = PB.hmr_forward(model, reg, synthetic_smpl_model(0, 64),
                                 torch.from_numpy(x), n_iter=n_iter,
                                 return_features=True)
    np.testing.assert_allclose(xf.numpy(), np.asarray(xf_want), atol=ATOL,
                               rtol=0)
    for k in ("theta", "verts", "kp_2d", "kp_3d"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=ATOL, rtol=1e-5, err_msg=k)


def test_bf16_features_close_to_f32(converted, rng):
    """A bfloat16 copy of the backbone stays within bf16 rounding of the
    float32 features, relative to their scale (the JAX engine's bar)."""
    _, _, model = converted
    x = torch.from_numpy(rng.randn(3, 3, 64, 64).astype(np.float32))
    with torch.inference_mode():
        f32 = model(x).numpy()
        b16 = model.to(torch.bfloat16)(x.to(torch.bfloat16)).float().numpy()
    model.float()
    assert PB.ResNet50.dtype.fget(model) == torch.float32
    assert np.abs(f32 - b16).mean() / np.abs(f32).mean() < 0.01
