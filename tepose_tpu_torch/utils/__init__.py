"""Host-side utilities of the port (counterpart of `tepose_tpu.utils`)."""
