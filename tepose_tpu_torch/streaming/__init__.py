"""Serving: the offline StreamingEngine, the frame-at-a-time LiveSession
and the fast window scan (counterpart of `tepose_tpu.streaming`)."""
