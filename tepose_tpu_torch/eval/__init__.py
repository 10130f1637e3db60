"""Eval rollout and host metrics (counterpart of `tepose_tpu.eval`)."""
