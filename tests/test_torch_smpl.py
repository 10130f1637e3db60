"""Port parity of the SMPL layer: constants, the synthetic model (exactly
equal), asset loading, the kinematic chain and the forward against JAX's
einsum skinning path. fp32 on the CPU; atol 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from tepose_tpu.models import smpl as JS
from tepose_tpu_torch.models import smpl as TS

ATOL = 1e-5
FIELDS = ("v_template", "shapedirs", "posedirs", "j_regressor",
          "lbs_weights", "j_regressor_extra")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs six workers on this host's
    cores, and these tests' small ops gain nothing from more."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _assert_same_model(jax_model, port_model, exact=True):
    for f in FIELDS:
        want = np.asarray(getattr(jax_model, f))
        got = getattr(port_model, f).numpy()
        assert got.dtype == np.float32 and got.shape == want.shape, f
        if exact:
            np.testing.assert_array_equal(got, want, err_msg=f)
    np.testing.assert_array_equal(port_model.lbs_weights_t.numpy(),
                                  np.asarray(jax_model.lbs_weights).T)
    assert port_model.parents == jax_model.parents
    assert port_model.joint_map == jax_model.joint_map
    assert port_model.vertex_joint_ids == jax_model.vertex_joint_ids


def test_constants_match():
    assert TS.JOINT_MAP == JS.JOINT_MAP
    assert TS.JOINT_NAMES == JS.JOINT_NAMES
    assert TS.H36M_TO_J17 == JS.H36M_TO_J17
    assert TS.H36M_TO_J14 == JS.H36M_TO_J14
    np.testing.assert_array_equal(TS.VERTEX_JOINT_IDS, JS.VERTEX_JOINT_IDS)
    np.testing.assert_array_equal(TS.SMPL_PARENTS, JS.SMPL_PARENTS)
    assert (TS.NUM_SMPL_JOINTS, TS.NUM_BETAS, TS.NUM_VERTS) == (
        JS.NUM_SMPL_JOINTS, JS.NUM_BETAS, JS.NUM_VERTS)


@pytest.mark.parametrize("seed,num_verts", [(0, 300), (3, 700), (0, 6890)])
def test_synthetic_smpl_model_is_equal(seed, num_verts):
    _assert_same_model(JS.synthetic_smpl_model(seed, num_verts),
                       TS.synthetic_smpl_model(seed, num_verts))


def test_from_numpy_of_jax_model():
    jm = JS.synthetic_smpl_model(1, 300)
    pm = TS.SmplModel.from_numpy(
        **{f: np.asarray(getattr(jm, f)) for f in FIELDS},
        parents=jm.parents, vertex_joint_ids=jm.vertex_joint_ids,
        joint_map=jm.joint_map)
    _assert_same_model(jm, pm)


def test_load_smpl_assets_matches_jax(tmp_path, rng):
    V = 300
    arrays = {
        "v_template": rng.randn(V, 3), "shapedirs": rng.randn(V, 3, 12),
        "posedirs": rng.randn(207, V * 3), "j_regressor": rng.rand(24, V),
        "lbs_weights": rng.rand(V, 24), "parents": JS.SMPL_PARENTS,
    }
    path = str(tmp_path / "smpl_no_extra.npz")
    np.savez(path, **arrays)
    with pytest.raises(KeyError):
        JS.load_smpl_assets(path)
    with pytest.raises(KeyError):
        TS.load_smpl_assets(path, "cpu")
    _assert_same_model(JS.load_smpl_assets(path, allow_missing_extra=True),
                       TS.load_smpl_assets(path, "cpu",
                                           allow_missing_extra=True))
    path = str(tmp_path / "smpl.npz")
    np.savez(path, j_regressor_extra=rng.rand(9, V), **arrays)
    _assert_same_model(JS.load_smpl_assets(path),
                       TS.load_smpl_assets(path, "cpu"))


def _pose_inputs(rng, B):
    betas = (rng.randn(B, 10) * 0.5).astype(np.float32)
    aa = (rng.randn(B, 72) * 0.4).astype(np.float32)
    aa[0] = 0.0                                    # rest pose
    rot = Rotation.from_rotvec(aa.reshape(-1, 3).astype(np.float64))
    return betas, aa, rot.as_matrix().reshape(B, 24, 3, 3).astype(np.float32)


@pytest.mark.parametrize("num_verts", [300, 700])
@pytest.mark.parametrize("pose2rot", [False, True])
def test_smpl_forward_matches_jax(rng, num_verts, pose2rot):
    jm = JS.synthetic_smpl_model(0, num_verts)
    pm = TS.synthetic_smpl_model(0, num_verts)
    betas, aa, rotmats = _pose_inputs(rng, 4)
    pose = aa if pose2rot else rotmats
    want = JS.smpl_forward(jm, jnp.asarray(betas), jnp.asarray(pose),
                           pose2rot=pose2rot)
    got = TS.smpl_forward(pm, torch.from_numpy(betas), torch.from_numpy(pose),
                          pose2rot=pose2rot)
    for key in ("verts", "joints49", "joints24"):
        assert got[key].shape == want[key].shape
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=ATOL, rtol=0, err_msg=key)


def test_rigid_transform_matches_jax(rng):
    _, _, rotmats = _pose_inputs(rng, 3)
    joints = rng.randn(3, 24, 3).astype(np.float32)
    want = JS._rigid_transform(jnp.asarray(rotmats), jnp.asarray(joints),
                               JS.SMPL_PARENTS)
    parents = tuple(TS.SMPL_PARENTS.tolist())
    got = TS._rigid_transform(torch.from_numpy(rotmats),
                              torch.from_numpy(joints), parents,
                              torch.tensor(parents[1:]))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0)


def test_regress_h36m_joints_matches_jax(rng):
    verts = rng.randn(2, 300, 3).astype(np.float32)
    jreg = rng.rand(17, 300).astype(np.float32)
    jreg /= jreg.sum(1, keepdims=True)
    for subset in (None, JS.H36M_TO_J14):
        want = JS.regress_h36m_joints(jnp.asarray(verts), jnp.asarray(jreg),
                                      None if subset is None
                                      else np.array(subset))
        got = TS.regress_h36m_joints(torch.from_numpy(verts),
                                     torch.from_numpy(jreg), subset)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0)
