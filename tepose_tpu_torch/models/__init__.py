"""SMPL body model, GRU encoders, IEF regressor, TePose and VIBE in torch
(counterpart of `tepose_tpu.models`)."""
