"""Convert released PyTorch checkpoints (.pth.tar) to the npz checkpoints
both packages read, and back.

The port's counterpart of `tools/convert_checkpoint.py`, which needs JAX:

  python -m tepose_tpu_torch.convert_checkpoint in.pth.tar out.npz \
      --kind {tepose,vibe,spin}
  python -m tepose_tpu_torch.convert_checkpoint in.npz out.pth.tar \
      --reverse [--like reference_ckpt.pth.tar]

Kinds: TePose checkpoints ({'gen_state_dict', 'disc_motion_state_dict',
'performance', 'epoch', ...}), VIBE ({'gen_state_dict', 'performance'}) and
SPIN ({'model': HMR state_dict}: the regressor head and the ResNet-50,
whose BN is folded into its convolutions). The output is the npz + json
container of `train.checkpoint`, array for array what the JAX tool writes.

`--reverse` writes a reference-layout .pth.tar from an npz checkpoint.
`--like` seeds it with a reference checkpoint's other entries (the
`regressor.smpl.*` buffers of the torch module, optimizer and scheduler
states), so the reference's strict `load_state_dict` accepts the file;
without it the state dicts hold the learned weights only.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from tepose_tpu_torch.models.backbone import convert_torch_resnet50
from tepose_tpu_torch.train.checkpoint import (
    convert_torch_discriminator, convert_torch_generator,
    export_torch_discriminator, export_torch_generator, save_checkpoint,
    strip_module_prefix)
from tepose_tpu_torch.weights import load_checkpoint

KINDS = ("tepose", "vibe", "spin")


def convert_reverse(src: str, dst: str, like: str = "") -> None:
    """An npz checkpoint -> a reference-layout .pth.tar."""
    trees, scalars = load_checkpoint(src)

    def to_torch(flat):
        return {k: torch.from_numpy(np.array(v)) for k, v in flat.items()}

    base = (torch.load(like, map_location="cpu", weights_only=False)
            if like else {})
    out = dict(base)
    gen_sd = dict(base.get("gen_state_dict", {}))
    gen_sd.update(to_torch(export_torch_generator(trees["gen"])))
    out["gen_state_dict"] = gen_sd
    if "disc" in trees:
        disc_sd = dict(base.get("disc_motion_state_dict", {}))
        disc_sd.update(to_torch(export_torch_discriminator(
            trees["disc"], trees.get("disc_state", {}))))
        out["disc_motion_state_dict"] = disc_sd
    for k in ("performance", "epoch"):
        if k in scalars:
            # the reference stores epoch as an int
            out[k] = int(scalars[k]) if k == "epoch" else scalars[k]
    torch.save(out, dst)
    print(f"wrote {dst} (reference layout"
          f"{', seeded from ' + like if like else ''})")


def convert_forward(src: str, dst: str, kind: str = "tepose") -> None:
    """A reference .pth.tar -> an npz checkpoint."""
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}; choose from {KINDS}")
    ckpt = torch.load(src, map_location="cpu", weights_only=False)
    trees, scalars = {}, {}
    if kind in ("tepose", "vibe"):
        sd = ckpt["gen_state_dict"] if "gen_state_dict" in ckpt else ckpt
        trees["gen"] = convert_torch_generator(sd)
        if "disc_motion_state_dict" in ckpt:
            trees["disc"], trees["disc_state"] = convert_torch_discriminator(
                ckpt["disc_motion_state_dict"])
        for k in ("performance", "epoch"):
            if k in ckpt:
                scalars[k] = float(np.asarray(ckpt[k]))
    else:  # spin
        sd = strip_module_prefix(ckpt["model"] if "model" in ckpt else ckpt)
        # the HMR head's keys are at the top level
        gen = {"regressor": {}}
        for key, val in sd.items():
            parts = key.split(".")
            if parts[0] in ("fc1", "fc2", "decpose", "decshape", "deccam"):
                gen["regressor"].setdefault(parts[0], {})[parts[1]] = \
                    np.asarray(val.cpu().numpy(), np.float32)
            elif parts[0] in ("init_pose", "init_shape", "init_cam"):
                gen["regressor"][parts[0]] = np.asarray(val.cpu().numpy(),
                                                        np.float32)
        trees["gen"] = gen
        trees["backbone"] = convert_torch_resnet50(sd)
    save_checkpoint(dst, trees, scalars)
    print(f"wrote {dst} ({len(trees)} trees)")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("src")
    ap.add_argument("dst")
    ap.add_argument("--kind", choices=KINDS, default="tepose")
    ap.add_argument("--reverse", action="store_true",
                    help="convert an npz checkpoint back to a reference "
                         ".pth.tar")
    ap.add_argument("--like", default="",
                    help="reference checkpoint seeding the reverse output's "
                         "other entries (smpl buffers, optimizer states)")
    args = ap.parse_args(argv)
    if args.reverse:
        convert_reverse(args.src, args.dst, args.like)
    else:
        convert_forward(args.src, args.dst, args.kind)


if __name__ == "__main__":
    main()
