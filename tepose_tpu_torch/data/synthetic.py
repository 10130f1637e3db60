"""Synthetic training DBs wired through the real dataset and loader stack.

Copies of the JAX repository's synthetic DB makers, `synthetic_3d_db` and
`synthetic_2d_db` (tests/test_datasets.py) and `synthetic_loaders`
(train.py), pinned equal to them by tests/test_torch_train_loop.py. `python -m tepose_tpu_torch.train
--synthetic` trains on them.
"""

from __future__ import annotations

import numpy as np

from tepose_tpu_torch.data.loaders import get_data_loaders


def synthetic_3d_db(rng, videos=((20, "a"), (9, "b"), (30, "c")),
                    with_smpl=True):
    total = sum(n for n, _ in videos)
    names = np.concatenate(
        [np.array([f"vid_{v}"] * n) for n, v in videos])
    db = {
        "vid_name": names,
        "features": rng.randn(total, 2048).astype(np.float16),
        "joints2D": rng.uniform(0, 224, (total, 49, 3)).astype(np.float32),
        "joints3D": rng.randn(total, 49, 3).astype(np.float32),
        "bbox": np.tile(np.array([112.0, 112.0, 100.0, 200.0], np.float32),
                        (total, 1)),
    }
    if with_smpl:
        db["pose"] = rng.randn(total, 72).astype(np.float32) * 0.2
        db["shape"] = rng.randn(total, 10).astype(np.float32) * 0.2
    pse = rng.randn(total, 85).astype(np.float32) * 0.2
    return db, pse


def synthetic_2d_db(rng, clips=((12, "x"), (10, "y"), (14, "z"))):
    total = sum(n for n, _ in clips)
    names = np.concatenate([np.array([f"clip_{v}"] * n) for n, v in clips])
    db = {
        "vid_name": names,
        "features": rng.randn(total, 2048).astype(np.float16),
        # posetrack DBs store spin-format 49-joint keypoints (converted at
        # preprocessing time)
        "joints2D": rng.uniform(0, 224, (total, 49, 3)).astype(np.float32),
        "bbox": np.tile(np.array([112.0, 112.0, 100.0, 200.0], np.float32),
                        (total, 1)),
    }
    pse = rng.randn(total, 85).astype(np.float32) * 0.2
    return db, pse


def synthetic_loaders(cfg, seed=0, num_shards=1, shard_index=0):
    """(train_2d, train_3d, motion_disc, valid) loaders over in-memory
    synthetic DBs, sized to the configured batch: the loaders drop
    incomplete batches, so the DBs hold at least one full batch each.
    Multi-process: the DBs are seed-deterministic, so every process builds
    the same data and the sharded loaders give it its rows."""
    rs = np.random.RandomState(seed)
    vl = cfg.DATASET.VIDLEN
    sl = cfg.DATASET.SEQLEN
    n_videos = max(6, cfg.TRAIN.BATCH_SIZE + 2)
    # each 2-channel 2D item packs ~ceil((vidlen-seqlen+2)/(clip-seqlen+1))
    # clips (chunking.combine_into_chunks), and the 2D batch needs
    # BATCH_SIZE*DATA_2D_RATIO whole items per step
    clip_len = max(2 * sl, vl // 8)
    clips_per_item = -(-(vl - sl + 2) // (clip_len - sl + 1))
    n_2d = int(cfg.TRAIN.BATCH_SIZE * cfg.TRAIN.DATA_2D_RATIO)
    n_clips = max(20, (n_2d + 2) * clips_per_item)
    db3, pse3 = synthetic_3d_db(
        rs, videos=tuple((vl + 10, f"v{i}") for i in range(n_videos)))
    db2, pse2 = synthetic_2d_db(
        rs, clips=tuple((clip_len, f"c{i}") for i in range(n_clips)))
    # the discriminator loader draws BATCH_SIZE windows per step; the AMASS
    # stream yields ~frames/seqlen windows, so size it to the batch
    n_amass = max(400, (cfg.TRAIN.BATCH_SIZE + 4) * sl + sl)
    amass = {"vid_name": np.array(["m"] * n_amass),
             "theta": rs.randn(n_amass, 82).astype(np.float32) * 0.2}
    over = {name: (db3, pse3) for name in
            ("mpii3d", "h36m", "human36m", "3dpw", "threedpw")}
    over.update({"posetrack": (db2, pse2), "insta": (db2, pse2),
                 "amass": (amass, None)})
    return get_data_loaders(cfg, db_overrides=over, num_shards=num_shards,
                            shard_index=shard_index)
