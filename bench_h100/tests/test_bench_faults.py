"""A run with the timed path broken underneath comes out not correct: for
each cell, a step that leaves its state unchanged, half of the batch left
out, and one answer altered where it is produced. (The cells run on one
card, so there is no exchange between cards to leave out.)"""

from __future__ import annotations

import pytest
import torch

from bench_h100.tests import tiny

_two_threads = pytest.fixture(scope="module", autouse=True)(tiny.two_threads)


def _half(out, n):
    """Rows n // 2 on of each output replaced by row 0's: those rows'
    work left out."""
    for v in out.values():
        v[n // 2:] = v[:1]
    return out


def _engine(mp, fault):
    from tepose_tpu_torch.streaming import engine, fast_scan

    if fault == "state":
        def frozen_ring(window, theta_buf0, num_windows, outputs):
            zero = torch.zeros_like(theta_buf0[:, :1])
            outs = [window(k, torch.cat([theta_buf0, zero], dim=1))
                    for k in range(num_windows)]
            return {k: torch.stack([o[k] for o in outs], dim=1)
                    for k in outputs}
        mp.setattr(fast_scan, "_feedback_loop", frozen_ring)
    elif fault == "half":
        orig = engine.StreamingEngine._boot_and_scan
        mp.setattr(engine.StreamingEngine, "_boot_and_scan",
                   lambda self, feats, *a: _half(
                       {k: v.clone() for k, v in
                        orig(self, feats, *a).items()}, feats.shape[0]))
    else:
        orig = engine.StreamingEngine.run_tracklets_from_crops

        def altered(self, crops_list, *a):
            outs = orig(self, crops_list, *a)
            longest = max(range(len(outs)),
                          key=lambda i: len(outs[i]["kp_3d"]))
            outs[longest]["kp_3d"][-1, 0] += 1e-3
            return outs
        mp.setattr(engine.StreamingEngine, "run_tracklets_from_crops",
                   altered)


def _vibe(mp, fault):
    from tepose_tpu_torch.models import tepose, temporal

    if fault == "state":
        def stateless(self, x):
            B, T, F = x.shape
            y, _ = self.gru(x.reshape(1, B * T, F))
            y = y.reshape(B, T, -1)
            if self.linear is not None:
                y = self.linear(torch.relu(y))
            return y + x if self.use_residual else y
        mp.setattr(temporal.VibeEncoder, "forward", stateless)
    else:
        orig = tepose.vibe_demo_forward

        def broken(vibe, backbone, smpl, images, **kw):
            out = {k: v.clone() for k, v in
                   orig(vibe, backbone, smpl, images, **kw).items()}
            if fault == "half":
                T = images.shape[1]
                for v in out.values():
                    v[:, T // 2:] = v[:, :1]
            else:
                out["kp_3d"][0, -1, 0] += 1e-3
            return out
        mp.setattr(tepose, "vibe_demo_forward", broken)


def _eval(mp, fault):
    from tepose_tpu_torch import evaluate
    from tepose_tpu_torch.models import tepose

    if fault == "state":
        orig = tepose.TePose.forward
        first = {}

        def ring_never_moves(self, x, smpl, **kw):
            fb = first.setdefault(x.shape[0], x[..., 2048:].clone())
            return orig(self, torch.cat([x[..., :2048], fb], dim=-1), smpl,
                        **kw)
        mp.setattr(tepose.TePose, "forward", ring_never_moves)
    else:
        orig = evaluate.rollout_chunk

        def broken(models, data, chunk, T_pad, B, *a, **kw):
            out = orig(models, data, chunk, T_pad, B, *a, **kw)
            if fault == "half":
                return _half(out, len(chunk))
            out["pred_j3d"][len(chunk) - 1, 0, 0] += 1e-3
            return out
        mp.setattr(evaluate, "rollout_chunk", broken)


def _live(mp, fault):
    from tepose_tpu_torch.streaming import live

    if fault == "state":
        orig = live._Shard._core
        mp.setattr(live._Shard, "_core",
                   lambda self, carry, x, reset: (
                       carry, orig(self, carry, x, reset)[1]))
    else:
        orig = live.LiveSession.push

        def broken(self, x, reset=None):
            out = orig(self, x, reset)
            if fault == "half":
                return _half(out, self.n_streams)
            out["kp_3d"][self.n_streams - 1, 0, 0] += 1e-3
            return out
        mp.setattr(live.LiveSession, "push", broken)


FAULTS = {"tepose-engine-crops": _engine, "vibe-demo-crops": _vibe,
          "tepose-eval-3dpw": _eval, "tepose-live-crops": _live}


@pytest.mark.parametrize("workload", tiny.CELLS)
@pytest.mark.parametrize("fault", ["state", "half", "altered"])
def test_fault_is_not_correct(workload, fault, monkeypatch):
    FAULTS[workload](monkeypatch, fault)
    result = tiny.run(workload)
    assert result["correct"] is False, result["checks"]
