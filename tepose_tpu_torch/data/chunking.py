"""Video/window index builders for training and evaluation (numpy).

A copy of `tepose_tpu/data/chunking.py` (importing it would import JAX
through the `tepose_tpu` package), pinned equal to it by
tests/test_torch_train_loop.py:

  * `split_into_videos`      — train: one item per video, clamped to vidlen.
  * `split_into_videos_val`  — val: full-length videos (no clamp).
  * `split_into_chunks`      — fixed seqlen windows with stride + edge padding
                               (+ optional VIBE 16-frame alignment).
  * `combine_into_chunks`    — packs short 2D clips into vidlen-long
                               "channels" (consecutive clips overlap by
                               seqlen-1 timeline slots).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def group_video_indices(vid_names: np.ndarray) -> List[np.ndarray]:
    """Frame-index arrays per video, in first-appearance order."""
    names, first = np.unique(vid_names, return_index=True)
    order = np.argsort(first)
    groups = np.split(np.arange(len(vid_names)), np.sort(first)[1:])
    # np.split on sorted first-indices already yields appearance order
    del names, order
    return groups


def split_into_videos(vid_names: np.ndarray, seqlen: int, stride: int,
                      vidlen: int) -> Tuple[List[int], List[int]]:
    """Per-video (start, end) pairs clamped to `vidlen` frames.

    Videos shorter than `seqlen` are dropped. Returns (flat start/end list,
    per-video true lengths) matching the reference's flattened layout.
    """
    starts_ends: List[int] = []
    lens: List[int] = []
    for idx in group_video_indices(vid_names):
        if len(idx) < seqlen:
            continue
        start = int(idx[0])
        end = min(int(idx[-1]), start + vidlen - 1)
        lens.append(end - start + 1)
        starts_ends += [start, end]
    return starts_ends, lens


def split_into_videos_val(vid_names: np.ndarray, seqlen: int,
                          stride: int) -> Tuple[List[int], List[int]]:
    """Like split_into_videos but full-length (eval)."""
    starts_ends: List[int] = []
    lens: List[int] = []
    for idx in group_video_indices(vid_names):
        if len(idx) < seqlen:
            continue
        start, end = int(idx[0]), int(idx[-1])
        lens.append(end - start + 1)
        starts_ends += [start, end]
    return starts_ends, lens


def split_into_chunks(vid_names: np.ndarray, seqlen: int, stride: int,
                      is_train: bool = True,
                      match_vibe: bool = False) -> List[List[int]]:
    """Sliding seqlen-windows with stride; when stride != seqlen the list is
    edge-padded so every frame owns a window (mid-frame models), and
    `match_vibe` trims the tail to align with VIBE's 16-frame chunking."""
    out: List[List[int]] = []
    for idx in group_video_indices(vid_names):
        n = len(idx)
        if n < seqlen:
            continue
        starts = np.arange(0, n - seqlen + 1, stride)
        chunks = [[int(idx[s]), int(idx[s + seqlen - 1])] for s in starts]

        if stride != seqlen:
            if match_vibe and n >= 16:
                vibe_last = int(idx[(n // 16) * 16 - 1])
                for j in range(1, len(chunks) + 1):
                    if chunks[-j][-1] == vibe_last:
                        if j != 1:
                            chunks = chunks[:-j + 1]
                        break
            d = chunks[0][0]
            for j in range(seqlen // 2):
                dummy = chunks[0] if is_train else [d + j, d + j]
                chunks.insert(j, dummy)
            d = chunks[-1][0]
            for j in range(int(seqlen / 2 + 0.5) - 1):
                dummy = (chunks[-1] if is_train
                         else [d + seqlen // 2 + j + 1,
                               d + seqlen // 2 + j + 1])
                chunks.append(dummy)
        out += chunks
    return out


def combine_into_chunks(vid_names: np.ndarray, seqlen: int,
                        vidlen: int) -> List[List[List[int]]]:
    """Pack consecutive clips into items whose *timeline* length stays under
    `vidlen`. A clip of f frames consumes f - seqlen + 1 timeline slots
    (consecutive clips overlap by seqlen-1 via the 2-channel switch scheme).

    Returns a list of items, each a list of [start, end] clip index pairs.
    """
    groups = group_video_indices(vid_names)
    budget = vidlen - seqlen + 2  # max accumulated timeline slots + 1

    items: List[List[List[int]]] = []
    cur: List[List[int]] = []
    used = 0
    for idx in groups:
        start, end = int(idx[0]), int(idx[-1])
        slots = (end - start + 1) - seqlen + 1
        if slots <= 0:
            # a clip shorter than seqlen cannot fill one window; packing it
            # would move the channel offset BACKWARD and overwrite the
            # previous clip's frames. The reference misses this guard (its
            # combine_into_chunks would corrupt the same way); the 3D path's
            # split_into_videos shows the intended drop.
            continue
        if used + slots < budget:
            cur.append([start, end])
            used += slots
        else:
            if cur:
                items.append(cur)
            # clip alone exceeds the budget -> truncate it to vidlen frames
            if slots >= budget:
                cur = [[start, start + vidlen - 1]]
                used = budget  # forces flush on next clip
            else:
                cur = [[start, end]]
                used = slots
    if cur:
        items.append(cur)
    return items


def pack_clip_channels(clip_lengths: Sequence[int], seqlen: int,
                       vidlen: int):
    """Channel/offset layout for a packed 2D item.

    Returns list of (channel, timeline_offset) per clip plus switch_id
    (2, vidlen): clip k goes to channel k % 2 at offset sum of previous
    (len_i - seqlen + 1); switch_id marks which channel is active per frame
    (ref: dataset_2d.py:104-117).
    """
    switch_id = np.zeros((2, vidlen), np.float32)
    switch_id[0, :] = 1
    layout = []
    switch, off = 0, 0
    for length in clip_lengths:
        layout.append((switch, off))
        switch_id[switch, off + seqlen - 1: off + length] = 1
        switch_id[1 - switch, off + seqlen - 1: off + length] = 0
        switch = 1 - switch
        off += length - seqlen + 1
    total_timeline = off + seqlen - 1
    return layout, switch_id, total_timeline
