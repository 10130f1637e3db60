"""Config system: yacs-schema-compatible nested config + YAML merge + CLI.

A copy of `tepose_tpu/config.py` (importing that module would import JAX
through the `tepose_tpu` package), pinned equal to it by
tests/test_torch_eval.py. Only the `--gpu` help text differs: in the port
it picks the device, which `gpu_device` resolves for every entry point.
"""

from __future__ import annotations

import argparse
import copy
import os
from typing import Any, Dict, Optional

import yaml

# Path constants (ref: config.py:23-32)
TePose_DB_DIR = os.environ.get("TEPOSE_DB_DIR", "data/preprocessed_data")
AMASS_DIR = "data/amass"
INSTA_DIR = "data/insta_variety"
MPII3D_DIR = "data/mpi_inf_3dhp"
THREEDPW_DIR = "data/3dpw"
H36M_DIR = "data/h36m"
PENNACTION_DIR = "data/penn_action"
POSETRACK_DIR = "data/posetrack"
BASE_DATA_DIR = os.environ.get("TEPOSE_BASE_DATA_DIR", "data/base_data")
VIBE_DATA_DIR = "data/vibe_data"


class CfgNode(dict):
    """Minimal yacs-like attribute dict with recursive merge."""

    def __getattr__(self, k: str) -> Any:
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k: str, v: Any) -> None:
        self[k] = v

    def clone(self) -> "CfgNode":
        return copy.deepcopy(self)

    def merge_from_dict(self, other: Dict[str, Any]) -> None:
        for k, v in other.items():
            if isinstance(v, dict) and isinstance(self.get(k), CfgNode):
                self[k].merge_from_dict(v)
            else:
                self[k] = v

    def merge_from_file(self, path: str) -> None:
        with open(path) as f:
            data = yaml.safe_load(f) or {}
        self.merge_from_dict(data)

    def dump(self) -> str:
        def plain(d):
            return {k: plain(v) if isinstance(v, dict) else v
                    for k, v in d.items()}
        return yaml.safe_dump(plain(self), sort_keys=False)


def _node(**kw) -> CfgNode:
    n = CfgNode()
    for k, v in kw.items():
        n[k] = v
    return n


def get_cfg_defaults() -> CfgNode:
    """Default config tree (key-for-key with ref: config.py:35-113)."""
    cfg = _node(
        TITLE="default",
        OUTPUT_DIR="results",
        EXP_NAME="default",
        DEVICE="tpu",
        DEBUG=True,
        LOGDIR="",
        NUM_WORKERS=8,
        DEBUG_FREQ=1000,
        SEED_VALUE=-1,
        render=False,
    )
    cfg.CUDNN = _node(BENCHMARK=True, DETERMINISTIC=False, ENABLED=True)
    cfg.TRAIN = _node(
        DATASETS_2D=["Insta"],
        DATASETS_3D=["MPII3D"],
        DATASET_EVAL="ThreeDPW",
        BATCH_SIZE=32,
        OVERLAP=True,
        DATA_2D_RATIO=0.5,
        START_EPOCH=0,
        END_EPOCH=5,
        PRETRAINED_REGRESSOR="",
        PRETRAINED="",
        RESUME="",
        NUM_ITERS_PER_EPOCH=1000,
        UPDATE_THETA_RATE=1.0,
        LR_PATIENCE=5,
        GEN_OPTIM="Adam",
        GEN_LR=1e-4,
        GEN_WD=1e-4,
        GEN_MOMENTUM=0.9,
        # '' = f32 (exact reference parity); 'bf16' = mixed-precision GAN
        # passes (f32 master weights; gradient parity pinned in
        # tests/test_trainer.py). TPU-new key — the reference has no
        # precision knob (lib/core/config.py). CLI --precision overrides.
        PRECISION="",
    )
    cfg.TRAIN.MOT_DISCR = _node(
        OPTIM="SGD",
        LR=1e-2,
        WD=1e-4,
        MOMENTUM=0.9,
        NUM_CLASS=2,
        UPDATE_STEPS=1,
        FEATURE_POOL="concat",
        HIDDEN_SIZE=1024,
        NUM_LAYERS=1,
    )
    cfg.TRAIN.MOT_DISCR.GCN = _node(
        num_class=2,
        num_point=24,
        num_person=1,
        num_gcn_scales=13,
        num_g3d_scales=6,
        graph="tepose_tpu.models.graph",
    )
    cfg.DATASET = _node(SEQLEN=20, VIDLEN=1000, OVERLAP=0.5)
    cfg.LOSS = _node(
        KP_2D_W=60.0, KP_3D_W=30.0, SHAPE_W=0.001, POSE_W=1.0,
        D_MOTION_LOSS_W=1.0)
    cfg.MODEL = _node(TEMPORAL_TYPE="gru")
    cfg.MODEL.TGRU = _node(NUM_LAYERS=1, HIDDEN_SIZE=2048)
    return cfg


def update_cfg(cfg_file: str) -> CfgNode:
    cfg = get_cfg_defaults()
    cfg.merge_from_file(cfg_file)
    return cfg.clone()


def gpu_device(gpu: str) -> str:
    """The device a `--gpu` argument names: a CUDA index, or 'cpu'."""
    return "cpu" if gpu == "cpu" else f"cuda:{int(gpu)}"


def parse_args(argv: Optional[list] = None):
    """CLI surface matching the reference (ref: config.py:129-152)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg", type=str, default="./configs/config.yaml",
                        help="cfg file path")
    parser.add_argument("--gpu", type=str, default="0",
                        help="CUDA device index to run on, or 'cpu' for "
                             "the host (plain kernels)")
    parser.add_argument("--dataset", type=str, default="3dpw",
                        help="pick from 3dpw, mpii3d, h36m")
    parser.add_argument("--seq", type=str, default="",
                        help="render target sequence")
    parser.add_argument("--render", action="store_true",
                        help="render meshes on an rgb video")
    parser.add_argument("--render_plain", action="store_true",
                        help="render meshes on plain background")
    parser.add_argument("--filter", action="store_true",
                        help="apply smoothing filter")
    parser.add_argument("--plot", action="store_true",
                        help="plot acceleration error graph")
    parser.add_argument("--frame", type=int, default=0,
                        help="render frame start idx")
    parser.add_argument("--eval_batch", type=int, default=None,
                        help="videos per eval rollout call; default is the "
                             "best of the measured points per dataset of the "
                             "card's own sweep (evaluate.EVAL_BATCHING, from "
                             "tepose_tpu_torch/eval_batching_sweep.json, "
                             "written by python -m tepose_tpu_torch."
                             "tune_eval_batching on an NVIDIA H100)")
    parser.add_argument("--eval_bucket", type=int, default=None,
                        help="round each video's length up to a multiple of "
                             "this many frames and batch within those "
                             "buckets; default: none, each batch pads to its "
                             "longest video")

    args = parser.parse_args(argv)
    cfg_file = args.cfg
    if args.cfg is not None and os.path.isfile(args.cfg):
        cfg = update_cfg(args.cfg)
    else:
        cfg = get_cfg_defaults()
    cfg.render = args.render
    return cfg, cfg_file, args
