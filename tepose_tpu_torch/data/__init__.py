"""Host-side data helpers for the port: copies of `tepose_tpu.data` modules
that hold no JAX."""
