"""Multi-process dryrun: one deterministic tiny training + eval problem that
runs alike in one process and in P processes over gloo on the CPU, so the
two can be compared numerically.

Port of `tepose_tpu/parallel/mp_dryrun.py`. Every process builds the same
weights and the full global batch from the shared seeds, keeps its rows
(`distributed.host_slice_tree`, the contract of the loaders' `num_shards`),
runs two windows of the data-parallel training segment
(`parallel.dp.sharded_train_segment`, scheduled sampling at rate 0.9 and
dropout on, one 3D row's video ending after the first window), then the
eval rollout of its rows of six videos on the post-step generator, gathered
in rank order (`distributed.fetch_global`). The metrics and outputs must
agree with the single process's to float tolerance (`compare_runs`).

Run as a module to act as one process:

  python -m tepose_tpu_torch.parallel.mp_dryrun --out ref.json
  python -m tepose_tpu_torch.parallel.mp_dryrun --out w0.json \
      --coordinator localhost:29511 --num-processes 2 --process-id 0

`spawn_and_compare(P)` does both and compares; every process it starts has
a time limit, and so has every collective of the group.
"""

from __future__ import annotations

import json

N_ROWS = 6          # 2D rows = 3D rows = eval videos; divides 1, 2, 3, 6
VIDLEN, NUM_ITERS, SEQLEN = 12, 2, 6


def run_payload() -> dict:
    """Run the training segment and the eval rollout over every process of
    the group (one when there is none); return a JSON-able dict of
    metrics and outputs, the same on every process."""
    import numpy as np
    import torch

    from tepose_tpu_torch.eval.evaluator import eval_rollout
    from tepose_tpu_torch.models.gcn import MotionDiscriminator
    from tepose_tpu_torch.models.smpl import synthetic_smpl_model
    from tepose_tpu_torch.models.tepose import (
        TePose, TePoseConfig, Vibe, VibeConfig)
    from tepose_tpu_torch.parallel import distributed, dp
    from tepose_tpu_torch.train.loss import LossWeights
    from tepose_tpu_torch.train.optim import make_optimizer
    from tepose_tpu_torch.train.trainer import TrainHyper

    S = SEQLEN
    hp = TrainHyper(seqlen=S, n_2d=N_ROWS, n_3d=N_ROWS, num_gcn_scales=3,
                    num_g3d_scales=2)
    smpl = synthetic_smpl_model(0, 64)
    gen = TePose(TePoseConfig(S, 1, 32),
                 generator=torch.Generator().manual_seed(0), device="cpu")
    disc = MotionDiscriminator(generator=torch.Generator().manual_seed(1),
                               device="cpu", num_gcn_scales=3,
                               num_g3d_scales=2)
    dp.replicate_from_primary(gen, disc)
    gen_opt = make_optimizer("adam", gen, 5e-5)
    disc_opt = make_optimizer("adam", disc, 1e-4, weight_decay=1e-4)

    # ---- global batches from the shared seed; keep only this process's rows
    rng = np.random.RandomState(0)
    switch = np.zeros((N_ROWS, 2, VIDLEN), np.float32)
    switch[:, 0, :VIDLEN // 2] = 1
    switch[:, 1, VIDLEN // 2:] = 1
    batch_2d = {
        "features": rng.randn(N_ROWS, 2, VIDLEN, 2048).astype(np.float32),
        "theta_pseu": rng.randn(N_ROWS, 2, VIDLEN, 85).astype(np.float32),
        "kp_2d": rng.randn(N_ROWS, VIDLEN, 49, 3).astype(np.float32),
        "switch_id": switch,
        "vidlen_each": np.full((N_ROWS,), VIDLEN, np.float32),
    }
    vidlen3 = np.full((N_ROWS,), VIDLEN, np.float32)
    vidlen3[-1] = S                     # valid at window 0 only
    w_smpl = np.ones((N_ROWS, VIDLEN), np.float32)
    w_smpl[1::2] = 0.0                  # 3D rows in the GAN
    batch_3d = {
        "features": rng.randn(N_ROWS, VIDLEN, 2048).astype(np.float32),
        "theta_pseu": rng.randn(N_ROWS, VIDLEN, 85).astype(np.float32),
        "kp_2d": rng.randn(N_ROWS, VIDLEN, 49, 3).astype(np.float32),
        "kp_3d": rng.randn(N_ROWS, VIDLEN, 49, 3).astype(np.float32),
        "theta": rng.randn(N_ROWS, VIDLEN, 85).astype(np.float32),
        "w_3d": np.ones((N_ROWS, VIDLEN), np.float32),
        "w_smpl": w_smpl,
        "vidlen_each": vidlen3,
    }
    amass = rng.randn(NUM_ITERS, 2 * N_ROWS, S, 85).astype(np.float32)

    b2, b3, am = dp.local_batches(batch_2d, batch_3d, amass)
    metrics = dp.sharded_train_segment(
        gen, disc, smpl, gen_opt, disc_opt, hp, LossWeights(), b2, b3, am,
        torch.Generator().manual_seed(0))
    assert all(np.isfinite(v) for v in metrics.values()), metrics

    # ---- eval rollout over this process's rows of the post-step generator
    vibe = Vibe(VibeConfig(S, 1, 32, add_linear=True),
                generator=torch.Generator().manual_seed(2), device="cpu")
    jreg = torch.from_numpy(rng.rand(17, 64).astype(np.float32))
    edata = {
        "feats": rng.randn(N_ROWS, VIDLEN, 2048).astype(np.float32),
        "pseu": rng.randn(N_ROWS, S - 1, 85).astype(np.float32),
        "gt": rng.randn(N_ROWS, VIDLEN, 85).astype(np.float32)}
    mine = distributed.host_slice_tree(edata)
    gen.eval()
    out = eval_rollout(gen, vibe, smpl, *(torch.from_numpy(mine[k]) for k in
                                          ("feats", "pseu", "gt")),
                       jreg, VIDLEN - S + 1)
    pt = distributed.fetch_global(out["pred_theta"])
    mp = distributed.fetch_global(out["mpvpe"])
    assert np.isfinite(pt).all()
    return {
        "process_count": distributed.process_count(),
        "train_metrics": metrics,
        "pred_theta": pt.tolist(),
        "mpvpe": mp.tolist(),
    }


def worker_main(argv=None) -> None:
    """One process of the dryrun: join the group (if multi-process), run
    the payload, dump JSON."""
    import argparse

    import torch

    from tepose_tpu_torch.parallel import distributed

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", required=True)
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--timeout", type=float, default=120.0,
                    help="seconds before any collective fails")
    args = ap.parse_args(argv)

    torch.set_num_threads(2)
    if args.coordinator:
        distributed.maybe_initialize(args.coordinator, args.num_processes,
                                     args.process_id, backend="gloo",
                                     timeout_s=args.timeout)
    try:
        result = run_payload()
    finally:
        distributed.shutdown()
    if args.process_id == 0 or not args.coordinator:
        with open(args.out, "w") as f:
            json.dump(result, f)
    print(f"mp_dryrun p{args.process_id}: ok "
          f"({result['process_count']} processes)")


def compare_runs(ref: dict, run: dict) -> None:
    """Assert a multi-process run reproduces the single-process one:
    metrics within 1e-5 relative, eval outputs rtol 2e-5, atol 2e-6."""
    import numpy as np

    for k, v in ref["train_metrics"].items():
        dv = abs(run["train_metrics"][k] - v)
        assert dv <= 1e-5 * max(1.0, abs(v)), (
            f"metric {k}: {run['train_metrics'][k]} vs {v}")
    np.testing.assert_allclose(
        np.asarray(run["pred_theta"]), np.asarray(ref["pred_theta"]),
        rtol=2e-5, atol=2e-6, err_msg="eval pred_theta diverged")
    np.testing.assert_allclose(
        np.asarray(run["mpvpe"]), np.asarray(ref["mpvpe"]),
        rtol=2e-5, atol=2e-6)


def spawn_and_compare(num_processes: int = 2, timeout: float = 120.0,
                      verbose: bool = True) -> dict:
    """Run the payload in one process, then in `num_processes` processes
    over gloo; assert equal results. Each process is a fresh interpreter
    with a time limit of `timeout` seconds (and so is every collective);
    one that fails or overruns fails the call and the others are
    stopped."""
    import os
    import socket
    import subprocess
    import sys
    import tempfile

    if N_ROWS % num_processes:
        raise ValueError(f"{N_ROWS} rows do not divide over "
                         f"{num_processes} processes")
    repo = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]

    def launch(out, extra):
        return subprocess.Popen(
            [sys.executable, "-m", "tepose_tpu_torch.parallel.mp_dryrun",
             "--out", out, "--timeout", str(timeout)] + extra,
            cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)

    def drain(procs):
        try:
            for name, proc in procs:
                log, _ = proc.communicate(timeout=timeout)
                if proc.returncode:
                    raise RuntimeError(f"mp_dryrun {name} failed "
                                       f"(rc={proc.returncode}):\n"
                                       f"{log[-4000:]}")
        finally:
            for _, proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()

    with tempfile.TemporaryDirectory() as td:
        ref_out, run_out = (os.path.join(td, n) for n in ("ref.json",
                                                          "run.json"))
        drain([("ref", launch(ref_out, []))])
        drain([(f"w{p}", launch(run_out, [
            "--coordinator", f"localhost:{port}",
            "--num-processes", str(num_processes), "--process-id", str(p)]))
            for p in range(num_processes)])
        with open(ref_out) as f:
            ref = json.load(f)
        with open(run_out) as f:
            run = json.load(f)
    assert run["process_count"] == num_processes, run["process_count"]
    compare_runs(ref, run)
    if verbose:
        print(f"multiprocess dryrun OK: {num_processes} processes == 1 "
              f"process (gen_loss {ref['train_metrics']['gen_loss']:.6f})")
    return ref


if __name__ == "__main__":
    worker_main()
