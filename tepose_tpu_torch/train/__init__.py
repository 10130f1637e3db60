"""The training path of the port: loss, trainer, optimizers, validation,
checkpoints, the epoch loop and `python -m tepose_tpu_torch.train`."""
