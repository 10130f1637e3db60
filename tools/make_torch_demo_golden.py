#!/usr/bin/env python
"""Write the JAX golden that the port's Temporal SMPLify and `--filter` are
held to, and measure the float32 drift its bars come from.

The GPU host has no JAX, so this script runs the JAX functions here, on the
CPU, at full width (synthetic SMPL with 6890 vertices, equal element for
element in both packages):

  * `tepose_tpu.models.smplify.smplify_refine` on one tracklet of T = 48
    frames, 60 Adam iterations at lr 0.02. Its inputs are rebuilt by
    `smplify_inputs` from the spec's seed with numpy alone (a smooth pose
    track, its perturbation as the initial fit), except the 2D keypoint
    targets: the projected joints of the true fit plus noise, computed by
    JAX and stored. The golden keeps the loss trace, the refined theta
    (camera, axis-angle pose, betas) and rotation matrices, the 49 joints
    in 3D and 2D and, on every `vert_frame_step`-th frame,
    `num_vert_subset` seeded vertices.
  * the `--filter` block of the JAX `evaluate.py` (Rodrigues, slerp ratio
    0.3, SMPL rebuild, H36M J14 through the synthetic J_regressor) on one
    stored video of seeded thetas.

  python tools/make_torch_demo_golden.py            # writes GOLDEN_PATH
  python tools/make_torch_demo_golden.py drift      # float32 vs float64
  python tools/make_torch_demo_golden.py drift '{"num_verts": 128, "T": 5}'

`drift` prints, per compared output, JAX float32 against JAX float64 (a
child process with `jax_enable_x64`), the port float32 against the port
float64, and the port against JAX, all on the CPU at the golden's inputs
(or at FULL_SPEC with the given overrides, as the CPU tests' size); the
bars in `SMPLIFY_BARS` are a small multiple of the larger of the two
float32-versus-float64 deviations (PERF.md, PR 5). Only the `jax_*`
functions and `main` import JAX, so the rest can be imported on a host
without it.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from typing import Dict

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

GOLDEN_PATH = os.path.join(REPO, "tests", "golden", "torch_port_demo_f32.npz")
DRIFT_DIR = os.path.join(REPO, "build", "demo_golden_drift")

FULL_SPEC = dict(num_verts=6890, smpl_seed=0, input_seed=5, T=48,
                 num_iters=60, lr=0.02, kp_noise=0.01, vert_seed=6,
                 num_vert_subset=512, vert_frame_step=6, filter_seed=7,
                 filter_len=64)

SMPLIFY_KEYS = ("losses", "theta", "rotmat", "kp_3d", "kp_2d", "verts")
# Bars for the port against the JAX golden: 4 times the larger of the JAX
# and port float32-versus-float64 deviations that `drift` measured at
# FULL_SPEC on the CPU (JAX's, in every output: losses 2.87e-6, theta
# 4.53e-6, rotmat 1.91e-6, kp_3d 7.8e-7, kp_2d 4.1e-7, verts 9.5e-7),
# rounded up to one digit. `losses` is relative to the trace's largest
# value; the others are absolute (m for kp_3d and verts, normalised image
# units for kp_2d, radians and camera units for theta).
SMPLIFY_BARS = dict(losses=2e-5, theta=2e-5, rotmat=8e-6, kp_3d=4e-6,
                    kp_2d=2e-6, verts=4e-6)
FILTER_ATOL = 1e-4   # 0.1 mm, the reproduction bar (BASELINE.md:64)


def rodrigues_np(aa: np.ndarray) -> np.ndarray:
    """Axis-angle (..., 3) -> rotation matrices (..., 3, 3), float64."""
    aa = np.asarray(aa, np.float64)
    angle = np.linalg.norm(aa, axis=-1, keepdims=True)
    k = aa / np.maximum(angle, 1e-12)
    x, y, z = k[..., 0], k[..., 1], k[..., 2]
    zero = np.zeros_like(x)
    K = np.stack([zero, -z, y, z, zero, -x, -y, x, zero],
                 -1).reshape(aa.shape[:-1] + (3, 3))
    s, c = np.sin(angle)[..., None], np.cos(angle)[..., None]
    return np.eye(3) + s * K + (1 - c) * (K @ K)


def smplify_inputs(spec: Dict) -> Dict[str, np.ndarray]:
    """The true fit (axis-angle pose, betas, cam), the initial fit as
    SMPLify takes it (rotation matrices, betas, cam, float32) and the
    keypoint confidences, from `input_seed`."""
    rs = np.random.RandomState(spec["input_seed"])
    T = spec["T"]
    t = np.arange(T)[:, None, None]
    base = rs.randn(24, 3) * 0.25
    amp = rs.randn(24, 3) * 0.1
    phase = rs.rand(24, 3) * 2 * np.pi
    true_aa = base + amp * np.sin(t / 6.0 + phase)                # (T,24,3)
    true_betas = np.tile(rs.randn(10) * 0.5, (T, 1))
    ts = np.arange(T)
    true_cam = np.stack([0.9 + 0.05 * np.sin(ts / 10.0),
                         0.05 * np.cos(ts / 8.0),
                         -0.03 * np.sin(ts / 7.0)], axis=1)
    init_aa = true_aa + rs.randn(T, 24, 3) * 0.1
    conf = rs.uniform(0.4, 1.0, (T, 49))
    conf[rs.rand(T, 49) < 0.1] = 0.0
    noise = rs.randn(T, 49, 2) * spec["kp_noise"]
    f32 = lambda a: np.ascontiguousarray(a, np.float32)
    return {
        "true_aa": f32(true_aa), "true_betas": f32(true_betas),
        "true_cam": f32(true_cam), "conf": f32(conf), "noise": f32(noise),
        "init_rotmat": f32(rodrigues_np(init_aa)),
        "init_betas": f32(true_betas + rs.randn(T, 10) * 0.2),
        "init_cam": f32(true_cam + rs.randn(T, 3) * 0.02),
    }


def filter_theta(spec: Dict) -> np.ndarray:
    """(filter_len, 85) thetas of one video: identity-ish cam, a jittery
    smooth pose track and constant betas, from `filter_seed`."""
    rs = np.random.RandomState(spec["filter_seed"])
    L = spec["filter_len"]
    t = np.arange(L)[:, None]
    pose = (rs.randn(72) * 0.3 + 0.2 * np.sin(t / 9.0 + rs.rand(72) * 6)
            + rs.randn(L, 72) * 0.05)
    cam = np.concatenate([np.full((L, 1), 0.9), rs.randn(L, 2) * 0.05], 1)
    betas = np.tile(rs.randn(10) * 0.5, (L, 1))
    return np.concatenate([cam, pose, betas], 1).astype(np.float32)


def vertex_subset(spec: Dict):
    """(frame indices, vertex indices) of the stored vertex subset."""
    rs = np.random.RandomState(spec["vert_seed"])
    verts = np.sort(rs.choice(spec["num_verts"], spec["num_vert_subset"],
                              replace=False))
    return np.arange(0, spec["T"], spec["vert_frame_step"]), verts


def smplify_outputs(out: Dict, spec: Dict) -> Dict[str, np.ndarray]:
    """smplify_refine's dict (either package) -> the golden's keys, float64
    for comparisons."""
    frames, verts = vertex_subset(spec)
    a = {k: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v,
                       np.float64) for k, v in out.items()}
    out = {k: a[k] for k in SMPLIFY_KEYS if k != "verts"}
    out["verts"] = a["verts"][frames][:, verts]
    return out


def deviation(got: Dict[str, np.ndarray],
              want: Dict[str, np.ndarray]) -> Dict[str, float]:
    """Max abs deviation per SMPLify output; `losses` relative to the
    trace's largest magnitude."""
    dev = {}
    for k in SMPLIFY_KEYS:
        g, w = np.asarray(got[k], np.float64), np.asarray(want[k], np.float64)
        if g.shape != w.shape or not np.isfinite(g).all():
            raise ValueError(f"{k}: shape {g.shape} vs {w.shape}, or "
                             f"non-finite values")
        d = float(np.abs(g - w).max())
        dev[k] = d / float(np.abs(w).max()) if k == "losses" else d
    return dev


def golden_deviation(got: Dict[str, np.ndarray],
                     golden: Dict) -> Dict[str, tuple]:
    """{output: (deviation, bar)} of the port's SMPLify against the golden."""
    want = {k: golden[f"smplify_{k}"] for k in SMPLIFY_KEYS}
    return {k: (d, SMPLIFY_BARS[k]) for k, d in deviation(got, want).items()}


def port_smplify(spec: Dict, kp_2d: np.ndarray, device,
                 dtype=torch.float32) -> Dict:
    """The port's smplify_refine on the golden's inputs."""
    from tepose_tpu_torch.models.smpl import synthetic_smpl_model
    from tepose_tpu_torch.models.smplify import SmplifyConfig, smplify_refine

    inp = smplify_inputs(spec)
    smpl = synthetic_smpl_model(spec["smpl_seed"], spec["num_verts"],
                                device=device).to(dtype)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return smplify_refine(
        smpl, t(inp["init_rotmat"]), t(inp["init_betas"]),
        t(inp["init_cam"]), t(kp_2d),
        SmplifyConfig(num_iters=spec["num_iters"], lr=spec["lr"]))


def port_filter(spec: Dict, theta: np.ndarray, device) -> np.ndarray:
    """The port's --filter on the stored thetas: J14 joints (L, 14, 3)."""
    from tepose_tpu_torch.evaluate import (
        filter_video_predictions, synthetic_j_regressor)
    from tepose_tpu_torch.models.smpl import synthetic_smpl_model

    smpl = synthetic_smpl_model(spec["smpl_seed"], spec["num_verts"],
                                device=device)
    jreg = torch.as_tensor(synthetic_j_regressor(spec["num_verts"]),
                           device=device)
    return filter_video_predictions(smpl, theta, jreg)


# ------------------------------------------------------------------ JAX


def _jax_smpl(spec: Dict, dtype):
    import jax
    import jax.numpy as jnp

    from tepose_tpu.models.smpl import synthetic_smpl_model

    smpl = synthetic_smpl_model(spec["smpl_seed"], spec["num_verts"])
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), smpl)


def jax_targets(spec: Dict) -> np.ndarray:
    """kp_2d targets (T, 49, 3): the true fit's projected joints plus
    noise, with the confidences."""
    import jax
    import jax.numpy as jnp

    from tepose_tpu.models.regressor import projection
    from tepose_tpu.models.smpl import smpl_forward
    from tepose_tpu.ops.geometry import batch_rodrigues

    inp = smplify_inputs(spec)
    T = spec["T"]
    smpl = _jax_smpl(spec, jnp.float32)
    with jax.default_matmul_precision("float32"):
        rot = batch_rodrigues(jnp.asarray(inp["true_aa"]).reshape(-1, 3))
        out = smpl_forward(smpl, jnp.asarray(inp["true_betas"]),
                           rot.reshape(T, 24, 3, 3))
        kp = np.asarray(projection(out["joints49"],
                                   jnp.asarray(inp["true_cam"])))
    kp = kp + inp["noise"]
    return np.concatenate([kp, inp["conf"][..., None]],
                          -1).astype(np.float32)


def jax_smplify(spec: Dict, kp_2d: np.ndarray, dtype=None) -> Dict:
    """JAX smplify_refine on the golden's inputs (float32, or float64 when
    x64 is on and `dtype` is jnp.float64)."""
    import jax
    import jax.numpy as jnp

    from tepose_tpu.models.smplify import SmplifyConfig, smplify_refine

    dtype = dtype or jnp.float32
    inp = smplify_inputs(spec)
    a = lambda x: jnp.asarray(x, dtype)
    with jax.default_matmul_precision("float32"):
        out = smplify_refine(
            _jax_smpl(spec, dtype), a(inp["init_rotmat"]),
            a(inp["init_betas"]), a(inp["init_cam"]), a(kp_2d),
            SmplifyConfig(num_iters=spec["num_iters"], lr=spec["lr"]))
    return jax.device_get(out)


def jax_filter(spec: Dict, theta: np.ndarray) -> np.ndarray:
    """The JAX `evaluate.py` --filter block (evaluate.py:259-274)."""
    import jax
    import jax.numpy as jnp

    from tepose_tpu.models.smpl import (
        H36M_TO_J14, regress_h36m_joints, smpl_forward)
    from tepose_tpu.ops.geometry import batch_rodrigues
    from tepose_tpu.ops.quaternion import smooth_rotmats_slerp
    from tepose_tpu_torch.evaluate import synthetic_j_regressor

    smpl = _jax_smpl(spec, jnp.float32)
    j_regressor = synthetic_j_regressor(spec["num_verts"])
    L = len(theta)
    with jax.default_matmul_precision("float32"):
        rm = np.asarray(batch_rodrigues(jnp.asarray(
            theta[:, 3:75].reshape(-1, 3)))).reshape(L, 24, 3, 3)
        rm = smooth_rotmats_slerp(rm, ratio=0.3)
        sm = smpl_forward(smpl, jnp.asarray(theta[:, 75:]), jnp.asarray(rm))
        return np.asarray(regress_h36m_joints(
            sm["verts"], jnp.asarray(j_regressor),
            subset=np.array(H36M_TO_J14)))


def make_golden(spec: Dict) -> Dict[str, np.ndarray]:
    """Everything the golden file holds, for `spec`."""
    kp_2d = jax_targets(spec)
    theta = filter_theta(spec)
    out = {f"smplify_{k}": v.astype(np.float32) for k, v in
           smplify_outputs(jax_smplify(spec, kp_2d), spec).items()}
    out.update(spec=np.asarray(json.dumps(spec, sort_keys=True)),
               kp_2d_target=kp_2d, filter_theta=theta,
               filter_j14=jax_filter(spec, theta).astype(np.float32))
    return out


def load_golden(path: str = GOLDEN_PATH) -> Dict:
    with np.load(path, allow_pickle=False) as z:
        golden = {k: z[k] for k in z.files}
    golden["spec"] = json.loads(str(golden["spec"]))
    return golden


def drift(spec: Dict) -> Dict[str, Dict[str, float]]:
    """The float32 drift of SMPLify at `spec` on the CPU: JAX f32 vs f64,
    port f32 vs f64, port vs JAX (and the port vs the JAX float64)."""
    os.makedirs(DRIFT_DIR, exist_ok=True)
    kp_path = os.path.join(DRIFT_DIR, "kp_2d.npy")
    kp_2d = jax_targets(spec)
    np.save(kp_path, kp_2d)
    x64_path = os.path.join(DRIFT_DIR, "jax_f64.npz")
    subprocess.run([sys.executable, os.path.abspath(__file__), "jax64",
                    json.dumps(spec), kp_path, x64_path], check=True)
    with np.load(x64_path) as z:
        jax64 = {k: z[k] for k in z.files}
    jax32 = smplify_outputs(jax_smplify(spec, kp_2d), spec)
    port32 = smplify_outputs(port_smplify(spec, kp_2d, "cpu"), spec)
    port64 = smplify_outputs(
        port_smplify(spec, kp_2d, "cpu", torch.float64), spec)
    return {"jax_f32_vs_f64": deviation(jax32, jax64),
            "port_f32_vs_f64": deviation(port32, port64),
            "port_f64_vs_jax_f64": deviation(port64, jax64),
            "port_vs_jax_f32": deviation(port32, jax32)}


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    if sys.argv[1:2] == ["jax64"]:
        jax.config.update("jax_enable_x64", True)
        import jax.numpy as jnp

        spec, kp_path, out_path = (json.loads(sys.argv[2]), sys.argv[3],
                                   sys.argv[4])
        out = jax_smplify(spec, np.load(kp_path).astype(np.float64),
                          jnp.float64)
        np.savez(out_path, **smplify_outputs(out, spec))
        return
    if sys.argv[1:2] == ["drift"]:
        res = drift(dict(FULL_SPEC, **json.loads(
            sys.argv[2] if len(sys.argv) > 2 else "{}")))
        for name, dev in res.items():
            print(name + ": " + ", ".join(f"{k} {v:.3e}"
                                          for k, v in dev.items()))
        print(json.dumps({"smplify_drift": res}))
        return
    golden = make_golden(FULL_SPEC)
    os.makedirs(os.path.dirname(GOLDEN_PATH), exist_ok=True)
    tmp = GOLDEN_PATH + ".tmp.npz"
    np.savez_compressed(tmp, **golden)
    os.replace(tmp, GOLDEN_PATH)
    print(f"wrote {GOLDEN_PATH} ({os.path.getsize(GOLDEN_PATH)} bytes): "
          + ", ".join(f"{k} {v.shape}" for k, v in golden.items()))


if __name__ == "__main__":
    main()
