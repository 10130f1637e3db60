"""Low-level math for the port: rotation conversions, Procrustes, and the
LBS skinning kernel's wrapper (counterpart of `tepose_tpu.ops`)."""
