"""Port parity of the networks: JAX params from `tepose_init` / `vibe_init`
load into the port's modules with `strict=True`, and the encoders, the IEF
regressor, TePose and VIBE then agree with the JAX apply functions on the
same numpy inputs. Small widths (hidden 32, 2 layers, 300 vertices), fp32 on
the CPU, atol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tepose_tpu.models import regressor as JR
from tepose_tpu.models import temporal as JT
from tepose_tpu.models.smpl import synthetic_smpl_model as jax_smpl
from tepose_tpu.models.tepose import (
    TePoseConfig as JaxTePoseConfig, VibeConfig as JaxVibeConfig,
    tepose_apply, tepose_init, vibe_apply, vibe_init)
from tepose_tpu.train.checkpoint import export_torch_generator, save_checkpoint
from tepose_tpu_torch.models.smpl import synthetic_smpl_model
from tepose_tpu_torch.models.tepose import TePose, TePoseConfig, Vibe, VibeConfig
from tepose_tpu_torch.weights import (
    flatten_tree, jax_tree_from_state_dict, load_checkpoint,
    state_dict_from_jax_tree, unflatten_tree)

ATOL = 1e-5
V = 300
OUT_KEYS = ("theta", "verts", "kp_2d", "kp_3d", "rotmat")

# jitted once per module: op-by-op JAX would compile every op separately
jax_tepose = jax.jit(tepose_apply, static_argnums=(3,))
jax_vibe = jax.jit(vibe_apply, static_argnums=(3,))
jax_regressor = jax.jit(JR.regressor_apply)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs six workers on this host's
    cores, and these tests' small ops gain nothing from more."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _gen():
    return torch.Generator().manual_seed(0)


@pytest.fixture(scope="module")
def nets():
    jcfg = JaxTePoseConfig(seqlen=6, n_layers=2, hidden_size=32)
    jvcfg = JaxVibeConfig(seqlen=6, n_layers=2, hidden_size=32,
                          add_linear=True)
    jgen = jax.device_get(tepose_init(jax.random.PRNGKey(0), jcfg))
    jvibe = jax.device_get(vibe_init(jax.random.PRNGKey(1), jvcfg))
    gen = TePose(TePoseConfig(6, 2, 32), generator=_gen(), device="cpu")
    vibe = Vibe(VibeConfig(6, 2, 32), generator=_gen(), device="cpu")
    gen.load_state_dict(state_dict_from_jax_tree(jgen), strict=True)
    vibe.load_state_dict(state_dict_from_jax_tree(jvibe), strict=True)
    jreg = np.random.RandomState(7).rand(17, V).astype(np.float32)
    jreg /= jreg.sum(1, keepdims=True)
    return dict(jcfg=jcfg, jvcfg=jvcfg, jgen=jgen, jvibe=jvibe,
                gen=gen.eval(), vibe=vibe.eval(), jreg=jreg,
                jsmpl=jax_smpl(0, V), smpl=synthetic_smpl_model(0, V))


def _close(got, want, keys=OUT_KEYS):
    for k in keys:
        g = got[k].detach().numpy()
        w = np.asarray(want[k])
        assert g.shape == w.shape, k
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0, err_msg=k)


def test_state_dict_keys_are_jax_paths(nets):
    assert set(nets["gen"].state_dict()) == set(
        export_torch_generator(nets["jgen"]))
    assert set(nets["vibe"].state_dict()) == set(
        export_torch_generator(nets["jvibe"]))


def test_init_is_seeded_bounded_and_leaves_global_rng(nets):
    torch.manual_seed(123)
    rng_state = torch.get_rng_state()
    a = TePose(TePoseConfig(6, 2, 32), generator=_gen(), device="cpu")
    b = TePose(TePoseConfig(6, 2, 32), generator=_gen(), device="cpu")
    c = TePose(TePoseConfig(6, 2, 32),
               generator=torch.Generator().manual_seed(1), device="cpu")
    assert torch.equal(torch.get_rng_state(), rng_state)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["encoder.gru_fwd.weight_ih_l0"],
                           sc["encoder.gru_fwd.weight_ih_l0"])
    # the JAX package's bounds for each init
    bounds = {"encoder.gru_rec.weight_hh_l1_reverse": 1 / np.sqrt(32),
              "encoder.linear_rec.weight": 1 / np.sqrt(64),
              "regressor.fc1.weight": 1 / np.sqrt(2048 + 144 + 13),
              "regressor.decpose.weight": 0.01 * np.sqrt(6 / (1024 + 144))}
    for k, bound in bounds.items():
        assert sa[k].abs().max() <= bound and sa[k].abs().max() > 0.8 * bound
    for k in ("init_pose", "init_shape", "init_cam"):
        np.testing.assert_array_equal(sa[f"regressor.{k}"].numpy(),
                                      np.asarray(nets["jgen"]["regressor"][k]))


def test_temporal_encoder_matches_jax(nets, rng):
    x = (rng.randn(3, 6, JT.INPUT_DIM) * 0.3).astype(np.float32)
    want = JT.temporal_encoder_apply(nets["jgen"]["encoder"], jnp.asarray(x),
                                     n_layers=2)
    got = nets["gen"].encoder(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=0)


def test_vibe_encoder_matches_jax(nets, rng):
    x = (rng.randn(3, 6, 2048) * 0.3).astype(np.float32)
    want = JT.vibe_encoder_apply(nets["jvibe"]["encoder"], jnp.asarray(x),
                                 n_layers=2)
    got = nets["vibe"].encoder(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("use_jreg", [True, False])
def test_regressor_matches_jax(nets, rng, use_jreg):
    x = (rng.randn(4, 2048) * 0.5).astype(np.float32)
    jreg = nets["jreg"] if use_jreg else None
    want = jax_regressor(nets["jgen"]["regressor"], nets["jsmpl"],
                         jnp.asarray(x),
                         j_regressor=None if jreg is None
                         else jnp.asarray(jreg))
    with torch.inference_mode():
        got = nets["gen"].regressor(
            torch.from_numpy(x), nets["smpl"],
            j_regressor=None if jreg is None else torch.from_numpy(jreg))
    assert got["kp_3d"].shape[1] == (14 if use_jreg else 49)
    _close(got, want)


def test_projection_matches_jax(rng):
    joints = (rng.randn(5, 14, 3) * 0.3).astype(np.float32)
    cam = np.concatenate([rng.rand(5, 1) + 0.5, rng.randn(5, 2) * 0.1],
                         1).astype(np.float32)
    from tepose_tpu_torch.models.regressor import projection

    np.testing.assert_allclose(
        projection(torch.from_numpy(joints), torch.from_numpy(cam)).numpy(),
        np.asarray(JR.projection(jnp.asarray(joints), jnp.asarray(cam))),
        atol=ATOL, rtol=0)


def test_tepose_matches_jax(nets, rng):
    x = (rng.randn(3, 6, JT.INPUT_DIM) * 0.3).astype(np.float32)
    want = jax_tepose(nets["jgen"], nets["jsmpl"], jnp.asarray(x),
                      nets["jcfg"], j_regressor=jnp.asarray(nets["jreg"]))
    with torch.inference_mode():
        got = nets["gen"](torch.from_numpy(x), nets["smpl"],
                          j_regressor=torch.from_numpy(nets["jreg"]))
    _close(got, want)


def test_vibe_matches_jax(nets, rng):
    x = (rng.randn(2, 6, 2048) * 0.3).astype(np.float32)
    want = jax_vibe(nets["jvibe"], nets["jsmpl"], jnp.asarray(x),
                    nets["jvcfg"], j_regressor=jnp.asarray(nets["jreg"]))
    with torch.inference_mode():
        got = nets["vibe"](torch.from_numpy(x), nets["smpl"],
                           j_regressor=torch.from_numpy(nets["jreg"]))
    _close(got, want)


def test_jax_tree_round_trip(nets):
    tree = jax_tree_from_state_dict(nets["gen"].state_dict())
    flat, want = flatten_tree(tree), flatten_tree(nets["jgen"])
    assert set(flat) == set(want)
    for k in flat:
        np.testing.assert_array_equal(flat[k], want[k])


def test_flatten_unflatten_match_jax(rng):
    from tepose_tpu.train import checkpoint as JC

    tree = {"a": {"b": rng.rand(2), "c": [rng.rand(1), {"d": rng.rand(3)}]},
            "e": None, "f": rng.rand(2, 2)}
    flat = flatten_tree(tree)
    want = JC.flatten_tree(tree)
    assert list(flat) == list(want)
    assert flatten_tree(unflatten_tree(flat)).keys() == flatten_tree(
        JC.unflatten_tree(want)).keys()


def test_jax_checkpoint_loads_strict(nets, tmp_path, rng):
    path = str(tmp_path / "ckpt" / "checkpoint.npz")
    save_checkpoint(path, {"gen": nets["jgen"]}, {"performance": 52.5})
    trees, scalars = load_checkpoint(path)
    assert scalars == {"performance": 52.5}
    gen = TePose(TePoseConfig(6, 2, 32),
                 generator=torch.Generator().manual_seed(5), device="cpu")
    gen.load_state_dict(state_dict_from_jax_tree(trees["gen"]), strict=True)
    x = (rng.randn(3, 6, JT.INPUT_DIM) * 0.3).astype(np.float32)
    jreg = torch.from_numpy(nets["jreg"])
    with torch.inference_mode():
        got = gen.eval()(torch.from_numpy(x), nets["smpl"], j_regressor=jreg)
    want = jax_tepose(nets["jgen"], nets["jsmpl"], jnp.asarray(x),
                      nets["jcfg"], j_regressor=jnp.asarray(nets["jreg"]))
    _close(got, want)
