"""Port parity of the ops: rotation conversions, Procrustes and the LBS
skinning wrapper against the JAX package on the same numpy inputs, plus the
kernel build's failure modes. fp32 on the CPU; atol 1e-5 throughout."""

import os
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from tepose_tpu.ops import geometry as JG
from tepose_tpu.ops.lbs_pallas import lbs_skinning_pallas
from tepose_tpu.ops.procrustes import batch_similarity_transform as jax_pa
from tepose_tpu_torch import kernels
from tepose_tpu_torch.ops import geometry as TG
from tepose_tpu_torch.ops import lbs_skinning as LS
from tepose_tpu_torch.ops.procrustes import batch_similarity_transform

ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs six workers on this host's
    cores, and these tests' small ops gain nothing from more."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _check(jax_fn, torch_fn, *xs, atol=ATOL):
    want = np.asarray(jax_fn(*map(jnp.asarray, xs)))
    got = torch_fn(*map(torch.from_numpy, xs)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def _axis_angles(rng):
    axes = rng.randn(12, 3)
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    return np.concatenate([
        rng.randn(64, 3) * 0.8,                       # generic
        np.zeros((2, 3)),                             # identity
        rng.randn(4, 3) * 1e-7,                       # near zero
        axes[:6] * (np.pi - 1e-3),                    # near pi
        axes[6:] * np.pi,                             # pi
        np.eye(3) * np.pi,                            # pi about x, y, z
    ]).astype(np.float32)


def _rotmats(rng):
    mats = Rotation.from_rotvec(_axis_angles(rng).astype(np.float64))
    return np.concatenate([mats.as_matrix(), np.eye(3)[None]]).astype(
        np.float32)


def test_batch_rodrigues(rng):
    _check(JG.batch_rodrigues, TG.batch_rodrigues, _axis_angles(rng))


def test_quat_to_rotmat(rng):
    q = rng.randn(40, 4).astype(np.float32)
    q = np.concatenate([q, [[1, 0, 0, 0], [-1, 0, 0, 0]]]).astype(np.float32)
    _check(JG.quat_to_rotmat, TG.quat_to_rotmat, q)


def test_rotmat_to_quat_all_branches(rng):
    R = _rotmats(rng)
    m = np.swapaxes(R, -1, -2)  # the branch masks read the transpose
    d2 = m[:, 2, 2] < 1e-6
    d01 = m[:, 0, 0] > m[:, 1, 1]
    nd1 = m[:, 0, 0] < -m[:, 1, 1]
    branches = {int(b) for b in np.where(
        d2, np.where(d01, 0, 1), np.where(nd1, 2, 3))}
    assert branches == {0, 1, 2, 3}
    _check(JG.rotmat_to_quat, TG.rotmat_to_quat, R)


def test_quat_to_angle_axis(rng):
    q = np.concatenate([
        rng.randn(40, 4),
        [[1, 0, 0, 0], [-1, 0, 0, 0], [0, 1, 0, 0], [-0.5, 0.5, 0.5, 0.5]],
    ]).astype(np.float32)
    _check(JG.quat_to_angle_axis, TG.quat_to_angle_axis, q)


def test_rotmat_to_angle_axis(rng):
    R = np.concatenate([_rotmats(rng), np.zeros((1, 3, 3), np.float32)])
    _check(JG.rotmat_to_angle_axis, TG.rotmat_to_angle_axis, R)
    out = TG.rotmat_to_angle_axis(torch.from_numpy(R))
    assert torch.isfinite(out).all()  # NaN-zeroing


def test_rot6d_to_rotmat(rng):
    x = np.concatenate([
        rng.randn(64, 6),
        np.tile([1, 0, 0, 1, 0, 0], (2, 1)),         # identity init
        np.zeros((1, 6)),                             # clamped normalise
        [[1, 0, 0, 0, 1, 0]],                         # rank-1 column pair
    ]).astype(np.float32)
    _check(JG.rot6d_to_rotmat, TG.rot6d_to_rotmat, x)
    ident = TG.rot6d_to_rotmat(torch.tensor([1.0, 0, 0, 1, 0, 0]))
    torch.testing.assert_close(ident, torch.eye(3))


def test_procrustes(rng):
    S1 = rng.randn(16, 14, 3).astype(np.float32)
    R = Rotation.random(16, random_state=1).as_matrix().astype(np.float32)
    S2 = (1.3 * np.einsum("bij,bnj->bni", R, S1) + 0.2
          + 0.01 * rng.randn(16, 14, 3)).astype(np.float32)
    S2[0] = S1[0] * np.array([-1, 1, 1], np.float32)  # reflection
    _check(jax_pa, batch_similarity_transform, S1, S2)


def _skin_inputs(rng, B=3, V=700, J=24):
    w = np.abs(rng.rand(V, J)).astype(np.float32)
    w /= w.sum(1, keepdims=True)
    A = rng.randn(B, J, 4, 4).astype(np.float32)
    A[:, :, 3] = [0, 0, 0, 1]
    v = rng.randn(B, V, 3).astype(np.float32)
    return w, A, v


def test_lbs_reference_matches_pallas_interpret(rng):
    """The plain version against the TPU kernel, run in interpret mode as
    tests/test_lbs_pallas.py runs it."""
    w, A, v = _skin_inputs(rng)
    want = np.asarray(lbs_skinning_pallas(
        jnp.asarray(w), jnp.asarray(A), jnp.asarray(v), interpret=True))
    got = LS.lbs_skinning_reference(torch.from_numpy(w.T.copy()),
                                    torch.from_numpy(A), torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_lbs_cpu_dispatch_takes_plain_path(rng):
    w, A, v = _skin_inputs(rng)
    wT, A, v = torch.from_numpy(w.T.copy()), torch.from_numpy(A), \
        torch.from_numpy(v)
    before = LS.LAUNCHES
    out = LS.lbs_skinning(wT, A, v)
    assert LS.LAUNCHES == before
    assert torch.equal(out, LS.lbs_skinning_reference(wT, A, v))


def test_lbs_wrapper_rejects_bad_shapes_and_devices(rng):
    w, A, v = _skin_inputs(rng)
    wT, A, v = torch.from_numpy(w.T.copy()), torch.from_numpy(A), \
        torch.from_numpy(v)
    with pytest.raises(ValueError, match="shape mismatch"):
        LS.lbs_skinning(wT, A[:, :20], v)
    with pytest.raises(ValueError, match="expects"):
        LS.lbs_skinning(wT, A.reshape(3, 24, 16), v)
    # neither all on the CPU nor on one CUDA device: no silent plain path
    with pytest.raises(ValueError, match="one CUDA device"):
        LS.lbs_skinning(wT.to("meta"), A.to("meta"), v.to("meta"))


@pytest.mark.parametrize("V", [64, 300, 700, 6890])
@pytest.mark.parametrize("B", [1, 2, 8, 32, 48, 160, 192, 256])
def test_lbs_launch_config_covers_each_sample_vertex_once(B, V):
    """The launch shape the wrapper picks (on a 132-SM card, for SMPL's 24
    joints and for another count) puts every (sample, vertex) in exactly
    one block, masks the ragged last vertex tile, and stays within one wave
    of BLOCKS_PER_SM blocks an SM, the grid limits and the 48 KB of static
    shared memory a block may have."""
    for J in (24, 17):
        cfg = LS._launch_config(B, V, J, 132)
        assert cfg.verts_per_thread == (
            4 if J == 24 and B >= LS.FOUR_VERTEX_MIN_BATCH else 1)
        assert cfg.threads == LS.THREADS[cfg.verts_per_thread]
        assert cfg.threads % 32 == 0 and cfg.threads <= 1024
        assert 1 <= cfg.groups <= min(B, LS.MAX_GRID_Y)
        assert (cfg.tiles * cfg.groups <= LS.BLOCKS_PER_SM * 132
                or cfg.groups == 1)
        assert LS.smem_bytes(J) <= 48 * 1024
        # the last tile is the only ragged one, and it is not empty
        assert (cfg.tiles - 1) * cfg.tile < V <= cfg.tiles * cfg.tile
        count = np.zeros((B, V), np.int32)
        for x in range(cfg.tiles):
            v0 = x * cfg.tile
            for y in range(cfg.groups):
                b0, b1 = LS.sample_range(y, B, cfg.groups)
                assert b0 < b1
                for t in range(cfg.threads):
                    # the kernel's vertices of thread t, and its mask
                    first = v0 + (t // 32) * 32 * cfg.verts_per_thread + t % 32
                    verts = [first + 32 * q
                             for q in range(cfg.verts_per_thread)]
                    verts = [u for u in verts if u < V]
                    count[b0:b1, verts] += 1
        assert (count == 1).all(), (J, cfg)


@pytest.fixture
def no_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(kernels.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))


def test_kernel_build_without_nvcc_raises(no_nvcc):
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.build("tepose_lbs", ["lbs_skinning.cu"])


def test_kernel_build_command_and_atomic_install(monkeypatch, tmp_path):
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kernels, "find_nvcc", lambda: "nvcc")
    calls = []

    def fake_run(cmd, **kw):
        calls.append(cmd)
        out = cmd[cmd.index("-o") + 1]
        with open(out, "wb") as f:
            f.write(b"so")
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(kernels.subprocess, "run", fake_run)
    path = kernels.build("tepose_lbs", ["lbs_skinning.cu"])
    assert path == kernels.library_path("tepose_lbs", ["lbs_skinning.cu"])
    assert path.parent == tmp_path and path.is_file()
    assert path.name.startswith("libtepose_lbs_") and path.suffix == ".so"
    assert os.listdir(tmp_path) == [path.name]      # the temp name is gone
    cmd = calls[0]
    assert cmd[:1] == ["nvcc"] and cmd[-1].endswith("csrc/lbs_skinning.cu")
    for flag in ("arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                 "-shared", "-fPIC"):
        assert flag in cmd
    kernels.build("tepose_lbs", ["lbs_skinning.cu"])
    assert len(calls) == 1                           # built once
    assert 0 <= kernels.BUILD_SECONDS["tepose_lbs"] < 60


def test_kernel_build_failure_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kernels, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(
        kernels.subprocess, "run",
        lambda cmd, **kw: subprocess.CompletedProcess(cmd, 2, "", "boom"))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        kernels.build("tepose_lbs", ["lbs_skinning.cu"])
    assert os.listdir(tmp_path) == []
