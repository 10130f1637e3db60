"""SMPL body model, GRU encoders, IEF regressor, TePose and VIBE in torch
(counterpart of `tepose_tpu.models`), and HMR 2.0's ViT-H and transformer
head (`vit`, `hmr2`), which the JAX package does not have."""
