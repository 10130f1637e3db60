"""Offline DB builders of the port: `python -m
tepose_tpu_torch.preprocess.<builder>` for threedpw, h36m, mpii3d,
posetrack, pennaction, amass, insta and pseudo_theta, with the arguments of
`tools/preprocess/<builder>.py`. The device work (ResNet-50 features, SMPL,
VIBE) runs on `cuda:0` unless `--gpu` names another card or `cpu`."""
