"""Data-parallel training across processes over gloo on the CPU.

  * a 2-rank segment (update_theta_rate 1.0, dropout off) against JAX
    `make_sharded_train_segment` over a 2-device mesh, with uneven valid
    rows: one 3D row of rank 0 and two of rank 1 end after window 1, and
    rank 1 holds two GAN rows of the 3D batch where rank 0 holds one;
  * 2 and 3 ranks at rate 0.9 with dropout on against the port's one
    process on the same batch;
  * `MaskedBatchNorm`'s global statistics, running statistics and input
    gradients on 2 ranks against the one-process module;
  * `parallel.mp_dryrun.spawn_and_compare` (2 ranks);
  * 2 ranks at rate 0.9 with bf16 compute and with the shared fake
    discriminator pass against one process with the same;
  * `python -m tepose_tpu_torch.train --synthetic --gpu cpu` as 2
    processes joined through the TEPOSE_* environment: only the primary
    writes files; `--devices N`'s launcher (`train.run.launch_ranks`).

The segment bars are `tests/test_torch_train.py::
test_segment_matches_make_train_segment`'s: mean losses rtol 1e-5, leaves
within 2 K lr max abs and 0.05 lr RMS, BN statistics 1e-4 of each array's
magnitude, optimizer step counts equal and moments within 1e-2 of their
norm. On this batch the port's own one-process segment misses two of
them against JAX: its BN statistics sit 2.4e-4 from JAX's and one
discriminator moment array 2.2e-2 from its norm, the known drift of the
discriminator's float32 gradient under Adam (tools/train_golden_drift.py). So against JAX
the 2 ranks are held at the other bars and at 1e-3 for the BN statistics
(the training golden's bar beyond K = 1,
`tools/make_torch_train_golden.py::golden_deviation`), and against the
port's one process at all of them (measured: BN 2.7e-6, moments 1.7e-3).
Small widths (TePose 1 x 16, GCN 2 / 2 scales, 48 vertices, batch 6 + 6
rows, K = 3 windows).

The ranks run this file as a script (`_worker`), which imports no JAX.
Every process has a time limit (`communicate(timeout=...)`) and so has
every collective (the process group's timeout): a hang fails in seconds.
"""

import dataclasses
import glob
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "tools")]

import make_torch_train_golden as golden_writer  # noqa: E402

TIMEOUT = 120          # seconds, per process and per collective
# the ranks share this host's cores with the suite's other workers
ENV = dict(os.environ, OMP_NUM_THREADS="2")
K = 3
SPEC = dict(golden_writer.FULL_SPEC, n_layers=1, hidden_size=16,
            num_verts=48, n_2d=6, n_3d=6, num_gcn_scales=2,
            num_g3d_scales=2, disc_update_steps=2, windows=(K,))
DROPOUT_SEED = 5


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs six workers on this host's
    cores, and these tests' small ops gain nothing from more."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


VARIANTS = {"": {}, "bf16": {"compute_dtype": "bfloat16"},
            "share": {"share_fake_disc": True}}


def _setup(rate: float, variant: str = ""):
    """The port's models, optimizers and global batch for SPEC at
    `update_theta_rate` rate, with uneven valid rows and GAN rows, and the
    `VARIANTS` entry's hyperparameters (bf16 compute, the shared fake
    discriminator pass)."""
    setup = golden_writer.port_setup(SPEC, "cpu")
    setup["hp"] = dataclasses.replace(setup["hp"], update_theta_rate=rate,
                                      **VARIANTS[variant])
    b3 = setup["batch_3d"]
    b3["vidlen_each"][4:] = SPEC["seqlen"] + 1     # and row 2 (make_batch)
    b3["w_smpl"][5] = 0.0                          # rows 1, 4 and 5 in the GAN
    setup["amass"] = setup["amass"][:K]
    return setup


def _segment(setup, dropout: bool, sharded: bool) -> dict:
    """One K-window segment; the state after it."""
    import torch

    from tepose_tpu_torch.parallel import dp
    from tepose_tpu_torch.train.optim import opt_state_leaves
    from tepose_tpu_torch.train.trainer import train_segment

    gen = (torch.Generator().manual_seed(DROPOUT_SEED) if dropout
           else None)
    args = (setup["gen"], setup["disc"], setup["smpl"], setup["gen_opt"],
            setup["disc_opt"], setup["hp"], setup["weights"])
    if sharded:
        losses = dp.sharded_train_segment(*args, *dp.local_batches(
            setup["batch_2d"], setup["batch_3d"], setup["amass"]), gen)
    else:
        losses = train_segment(*args, setup["batch_2d"], setup["batch_3d"],
                               setup["amass"], gen)
    out = golden_writer.port_state(setup)
    out["losses"] = losses
    out["gen_opt"] = opt_state_leaves(setup["gen_opt"])
    out["disc_opt"] = opt_state_leaves(setup["disc_opt"])
    return out


def _bn_case(rank: int, world: int) -> dict:
    """MaskedBatchNorm over this rank's rows of a seeded global batch,
    inside `reducing()`; returns its rows' outputs and input gradients
    and the weight, bias and running statistics after the step."""
    import torch

    from tepose_tpu_torch.models.gcn import MaskedBatchNorm
    from tepose_tpu_torch.parallel import distributed

    rs = np.random.RandomState(3)
    x = torch.from_numpy(rs.randn(8, 5, 4, 3).astype(np.float32))
    mask = torch.tensor([1, 1, 0, 1, 0, 0, 1, 0], dtype=torch.bool)
    w = torch.from_numpy(rs.randn(8, 5, 4, 3).astype(np.float32))
    rows = distributed.host_local_rows(8) if world > 1 else slice(0, 8)
    bn = MaskedBatchNorm(5, "cpu")
    bn.train()
    xl = x[rows].clone().requires_grad_(True)
    with distributed.reducing():
        out = bn(xl, mask[rows])
        ((out * w[rows]) ** 2).sum().backward()
    g = torch.cat([bn.weight.grad, bn.bias.grad])
    if world > 1:
        distributed.all_reduce_sum_(g)
    return {"out": distributed.fetch_global(out.detach()),
            "x_grad": distributed.fetch_global(xl.grad),
            "param_grad": g.numpy(),
            "running_mean": bn.running_mean.numpy().copy(),
            "running_var": bn.running_var.numpy().copy()}


def _worker(argv) -> None:
    """One rank: `rank world port out jobs...`; rank 0 writes the results
    of every job into the npz `out`."""
    import torch

    from tepose_tpu_torch.parallel import distributed

    rank, world, port, out = int(argv[0]), int(argv[1]), argv[2], argv[3]
    torch.set_num_threads(2)
    distributed.maybe_initialize(f"localhost:{port}", world, rank,
                                 backend="gloo", timeout_s=TIMEOUT)
    res = {}
    try:
        for job in argv[4:]:
            if job == "bn":
                for k, v in _bn_case(rank, world).items():
                    res[f"bn/{k}"] = np.asarray(v)
                continue
            _, rate, variant = (job + ":").split(":")[:3]
            rate = float(rate)
            got = _segment(_setup(rate, variant), dropout=rate < 1.0,
                           sharded=True)
            for k, v in _flat(got).items():
                res[f"{job}/{k}"] = v
    finally:
        distributed.shutdown()
    if rank == 0:
        np.savez(out, **res)


def _flat(seg: dict) -> dict:
    out = {}
    for group in ("gen", "disc", "disc_state"):
        for k, v in seg[group].items():
            out[f"{group}/{k}"] = np.asarray(v)
    for k, v in seg["losses"].items():
        out[f"loss/{k}"] = np.asarray(v, np.float64)
    for group in ("gen_opt", "disc_opt"):
        for i, v in enumerate(seg[group]):
            out[f"{group}/{i:05d}"] = np.asarray(v)
    return out


def _unflat(z, prefix: str) -> dict:
    seg = {g: {} for g in ("gen", "disc", "disc_state", "losses")}
    opt = {"gen_opt": [], "disc_opt": []}
    for key in sorted(k for k in z.files if k.startswith(prefix + "/")):
        group, name = key[len(prefix) + 1:].split("/", 1)
        if group == "loss":
            seg["losses"][name] = float(z[key])
        elif group in opt:
            opt[group].append(z[key])
        else:
            seg[group][name] = z[key]
    seg.update(opt)
    return seg


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_ranks(world: int, jobs, tmp_path) -> dict:
    out = str(tmp_path / f"world{world}.npz")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(world),
         str(port), out, *jobs], cwd=REPO, env=ENV, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} of {world}:\n{log[-4000:]}"
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


class _Npz(dict):
    @property
    def files(self):
        return list(self)


def _assert_segment_bars(got: dict, want: dict, bn_bar: float = 1e-4,
                         moments: bool = True) -> None:
    """test_segment_matches_make_train_segment's bars (BN statistics at
    `bn_bar` of each array's magnitude; the moments' bar only with
    `moments`)."""
    for k, v in want["losses"].items():
        np.testing.assert_allclose(got["losses"][k], v, rtol=1e-5, err_msg=k)
    for group, lr in (("gen", SPEC["gen_lr"]), ("disc", SPEC["disc_lr"])):
        assert got[group].keys() == want[group].keys()
        d = np.concatenate([(got[group][k] - want[group][k]).ravel()
                            for k in want[group]])
        assert np.abs(d).max() <= 2 * K * lr, (group, np.abs(d).max())
        assert np.sqrt((d ** 2).mean()) <= 0.05 * lr, group
    for k, v in want["disc_state"].items():
        np.testing.assert_allclose(got["disc_state"][k], v, rtol=0,
                                   atol=bn_bar * max(np.abs(v).max(), 1e-6),
                                   err_msg=k)
    for group in ("gen_opt", "disc_opt"):
        mine, leaves = got[group], want[group]
        assert len(mine) == len(leaves)
        assert int(mine[0]) == int(leaves[0]), group
        for a, b in zip(mine[1:], leaves[1:]):
            assert np.shape(a) == np.shape(b)
            assert not moments or (np.linalg.norm(np.asarray(a) - np.asarray(b))
                    <= 1e-2 * np.linalg.norm(b) + 1e-12)


@pytest.fixture(scope="module")
def one_process_dropout():
    """The port's one-process segment at rate 0.9 with dropout."""
    return _segment(_setup(0.9), dropout=True, sharded=False)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Rank 0's results of the 2-rank jobs: the segment at rate 1.0
    (dropout off) and at 0.9 (dropout on), at 0.9 with bf16 compute and
    with the shared fake discriminator pass, and the BatchNorm case."""
    return _Npz(_run_ranks(2, ["seg:1.0", "seg:0.9", "seg:0.9:bf16",
                               "seg:0.9:share", "bn"],
                           tmp_path_factory.mktemp("mp")))


def _jax_sharded_segment() -> dict:
    """JAX `make_sharded_train_segment` over a 2-device mesh on the port's
    weights and batch (dropout off, rate 1.0)."""
    import jax
    import jax.numpy as jnp

    from tepose_tpu.models.smpl import synthetic_smpl_model
    from tepose_tpu.models.tepose import TePoseConfig
    from tepose_tpu.parallel.dp import make_sharded_train_segment
    from tepose_tpu.parallel.mesh import make_mesh
    from tepose_tpu.train.loss import LossWeights
    from tepose_tpu.train.optim import make_optimizer
    from tepose_tpu.train.trainer import TrainHyper
    from tepose_tpu_torch.weights import (
        disc_jax_trees_from_state_dict, flatten_tree,
        jax_tree_from_state_dict)

    setup = _setup(1.0)
    gp = jax_tree_from_state_dict(setup["gen"].state_dict())
    dp_, ds = disc_jax_trees_from_state_dict(setup["disc"].state_dict())
    hp = TrainHyper(**{k: getattr(setup["hp"], k) for k in (
        "seqlen", "n_2d", "n_3d", "update_theta_rate", "disc_update_steps",
        "num_gcn_scales", "num_g3d_scales")})
    gen_tx = make_optimizer("adam", SPEC["gen_lr"], SPEC["gen_wd"])
    disc_tx = make_optimizer("adam", SPEC["disc_lr"], SPEC["disc_wd"])
    carry = tuple(jax.tree_util.tree_map(jnp.asarray, t) for t in (
        gp, dp_, ds))
    carry = carry + (gen_tx.init(carry[0]), disc_tx.init(carry[1]))
    data = {"batch_2d": setup["batch_2d"], "batch_3d": setup["batch_3d"],
            "amass": setup["amass"]}
    with golden_writer.jax_dropout_off(), \
            jax.default_matmul_precision("float32"):
        fn, carry_placer, data_placer = make_sharded_train_segment(
            synthetic_smpl_model(SPEC["smpl_seed"], SPEC["num_verts"]),
            TePoseConfig(SPEC["seqlen"], SPEC["n_layers"],
                         SPEC["hidden_size"], fast_encoder=True),
            hp, gen_tx, disc_tx, LossWeights(), K, make_mesh(2), carry,
            data)
        flats, mvec = fn(carry_placer.pack_np(carry),
                         data_placer.pack_np(data), jax.random.PRNGKey(0))
        names = fn.metric_names()
    gp, dp_, ds, go, do = carry_placer.unpack_np(flats)
    return {"losses": dict(zip(names, np.asarray(mvec).tolist())),
            "gen": flatten_tree(gp), "disc": flatten_tree(dp_),
            "disc_state": flatten_tree(ds),
            "gen_opt": [np.asarray(x) for x in jax.tree_util.tree_leaves(go)],
            "disc_opt": [np.asarray(x) for x in
                         jax.tree_util.tree_leaves(do)]}


def test_two_ranks_match_jax_sharded_segment(two_ranks):
    """update_theta_rate 1.0, dropout off, uneven valid and GAN rows."""
    got = _unflat(two_ranks, "seg:1.0")
    want = _jax_sharded_segment()
    assert set(got["losses"]) <= set(want["losses"])
    _assert_segment_bars(got, want, bn_bar=1e-3, moments=False)
    _assert_segment_bars(got, _segment(_setup(1.0), dropout=False,
                                       sharded=False))
    # the 3D rows that ended early left windows 2-3 to fewer rows: the
    # generator still stepped every window, the discriminator on 0 and 2
    assert int(got["gen_opt"][0]) == K
    assert int(got["disc_opt"][0]) == len(range(0, K, 2))


@pytest.mark.parametrize("world", [2, 3])
def test_ranks_match_one_process_with_dropout(world, two_ranks,
                                              one_process_dropout, tmp_path):
    """update_theta_rate 0.9 and dropout on: every rank draws the global
    shape and keeps its rows, so 2 and 3 ranks equal one process."""
    want = one_process_dropout
    ranks = (two_ranks if world == 2
             else _Npz(_run_ranks(3, ["seg:0.9"], tmp_path)))
    got = _unflat(ranks, "seg:0.9")
    _assert_segment_bars(got, want)
    # the draws moved the result past the loss bar: rate 1.0 without
    # dropout differs
    other = _unflat(two_ranks, "seg:1.0")
    assert abs(other["losses"]["gen_loss"] - got["losses"]["gen_loss"]) \
        > 1e-5 * abs(got["losses"]["gen_loss"])


@pytest.mark.parametrize("variant", ["bf16", "share"])
def test_ranks_compose_with_bf16_and_shared_disc(variant, two_ranks):
    """2 ranks at rate 0.9 with dropout, with bf16 compute or with the
    shared fake discriminator pass, against one process with the same: the
    flat gradient all-reduce stays float32 and the masked BN all-reduces
    float32 sums (the shared pass once a window where two calls would
    twice). The shared pass is held at every segment bar; bf16, where the
    ranks' global BN statistics round the bf16 activations apart from one
    process's, at the bf16 gate's bars (tools/bf16_gate.py) on each net's
    change over the segment: cosine > 0.98, relative norm < 0.2, losses
    within 5 % (measured: gen 0.99986 / 0.016, disc 0.990 / 0.141, losses
    2.5e-3)."""
    want = _segment(_setup(0.9, variant), dropout=True, sharded=False)
    got = _unflat(two_ranks, f"seg:0.9:{variant}")
    for group in ("gen", "disc", "disc_state"):
        assert all(np.asarray(v).dtype == np.float32
                   for v in got[group].values()), group
    if variant == "share":
        _assert_segment_bars(got, want)
        return
    for k, v in want["losses"].items():
        np.testing.assert_allclose(got["losses"][k], v, rtol=0.05,
                                   err_msg=k)
    init = golden_writer.port_state(_setup(0.9, variant))
    for group in ("gen", "disc"):
        a, b = (np.concatenate([(seg[group][k] - init[group][k]).ravel()
                                for k in sorted(init[group])])
                .astype(np.float64) for seg in (want, got))
        cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
        rel = np.linalg.norm(b - a) / np.linalg.norm(a)
        assert cos > 0.98 and rel < 0.2, (group, cos, rel)


def test_masked_batchnorm_global_statistics(two_ranks):
    """2 ranks (3 and 1 masked rows) against one module over all 8 rows:
    outputs, input gradients, the summed weight and bias gradients and the
    running statistics."""
    want = _bn_case(0, 1)
    for k, v in want.items():
        np.testing.assert_allclose(two_ranks[f"bn/{k}"], v, rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_mp_dryrun_two_processes_match_one_process():
    from tepose_tpu_torch.parallel.mp_dryrun import spawn_and_compare

    ref = spawn_and_compare(num_processes=2, timeout=TIMEOUT, verbose=False)
    assert ref["process_count"] == 1
    assert np.isfinite(ref["train_metrics"]["gen_loss"])


def test_train_cli_two_processes(tmp_path):
    """`python -m tepose_tpu_torch.train --synthetic --gpu cpu` as two
    ranks joined through the TEPOSE_* environment: one logdir, written by
    the primary only (one line a metric a step), with its checkpoint; the
    other rank logs as [p1]."""
    from tepose_tpu_torch import config as TCFG

    cfg = TCFG.update_cfg(os.path.join(REPO, "configs",
                                       "repr_wopw_3dpw_model.yaml"))
    cfg.OUTPUT_DIR = str(tmp_path / "out")
    cfg.DATASET.SEQLEN, cfg.DATASET.VIDLEN = 6, 12
    cfg.TRAIN.BATCH_SIZE, cfg.TRAIN.DATA_2D_RATIO = 8, 0.5
    cfg.MODEL.TGRU.NUM_LAYERS, cfg.MODEL.TGRU.HIDDEN_SIZE = 1, 16
    cfg.TRAIN.MOT_DISCR.GCN.num_gcn_scales = 2
    cfg.TRAIN.MOT_DISCR.GCN.num_g3d_scales = 2
    cfg.TRAIN.END_EPOCH = 1
    cfg.TRAIN.PRETRAINED_REGRESSOR = ""
    cfg_path = tmp_path / "tiny.yaml"
    cfg_path.write_text(cfg.dump())
    argv = [sys.executable, "-m", "tepose_tpu_torch.train", "--synthetic",
            "--gpu", "cpu", "--cfg", str(cfg_path), "--smoke-iters", "2",
            "--smoke-verts", "48"]
    port = _free_port()
    cmds = [(argv, dict(ENV, TEPOSE_COORDINATOR=f"localhost:{port}",
                        TEPOSE_NUM_PROCESSES="2", TEPOSE_PROCESS_ID=str(r)))
            for r in range(2)]
    procs = [subprocess.Popen(c, cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c, env in cmds]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=2 * TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    dirs = glob.glob(str(tmp_path / "out" / "*"))
    assert len(dirs) == 1, dirs
    files = set(os.listdir(dirs[0]))
    assert {"checkpoint.npz", "metrics.jsonl", "config.yaml",
            "train_log.txt"} <= files
    lines = [json.loads(s) for s in open(os.path.join(dirs[0],
                                                      "metrics.jsonl"))]
    tags = [d["tag"] for d in lines]
    assert tags.count("train_loss/gen_loss") == 1
    assert tags.count("error/pa-mpjpe") == 1
    assert all(np.isfinite(d["value"]) for d in lines)
    assert "[p1]" in "".join(logs)


def test_launch_ranks_runs_every_rank_and_stops_on_failure(monkeypatch):
    """`--devices N`'s launcher starts N ranks of the CLI joined through
    the TEPOSE_* environment (each here exits at `--help`) and returns the
    first failing rank's exit code (a precision train.py refuses)."""
    from tepose_tpu_torch.train import run as TRUN

    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    assert TRUN.launch_ranks(2, ["--help"]) == 0
    assert TRUN.launch_ranks(2, ["--synthetic", "--precision", "fp8"]) != 0


if __name__ == "__main__":
    _worker(sys.argv[1:])
