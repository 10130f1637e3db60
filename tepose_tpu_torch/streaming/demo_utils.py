"""A copy of `tepose_tpu/streaming/demo_utils.py` (numpy; cv2, pytube and
ffmpeg only inside the functions that use them), pinned equal to it by
tests/test_torch_host.py.

Host-side demo plumbing: video IO and camera/coordinate conversions.

ref: lib/utils/demo_utils.py:181-295. Video decode/encode prefers OpenCV
(in-process, no temp jpgs) with an ffmpeg-subprocess fallback matching the
reference's pipeline.
"""

from __future__ import annotations

import os
import os.path as osp
import subprocess
from collections import OrderedDict
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np


def download_youtube_clip(url: str, download_folder: str) -> str:
    """Download a YouTube video to `download_folder`, returning the file path.

    ref: lib/utils/demo_utils.py:85-86 (pytube) — the import is gated because
    this environment has no egress and pytube is not a baked-in dependency;
    demo.py routes `--vid_file https://...` here and surfaces this error
    cleanly when the package is absent (ref: demo.py:64-67).
    """
    try:
        from pytube import YouTube  # type: ignore
    except ImportError as e:  # pragma: no cover - exercised via fake module
        raise RuntimeError(
            "downloading a YouTube --vid_file requires the 'pytube' package "
            "(pip install pytube); alternatively download the clip yourself "
            "and pass the local file") from e
    os.makedirs(download_folder, exist_ok=True)
    return YouTube(url).streams.first().download(output_path=download_folder)


def read_video_frames(path: str) -> Iterator[np.ndarray]:
    """Yield RGB uint8 frames (cv2-based; ref decodes to jpgs via ffmpeg,
    demo_utils.py:181-203)."""
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise FileNotFoundError(f"cannot open video {path}")
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        yield cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
    cap.release()


def video_fps(path: str) -> float:
    import cv2

    cap = cv2.VideoCapture(path)
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    cap.release()
    return float(fps)


def write_video(frames: List[np.ndarray], out_path: str,
                fps: float = 30.0) -> None:
    """Encode RGB frames to mp4 (cv2 VideoWriter, ffmpeg fallback;
    ref: demo_utils.py:229-238)."""
    import cv2

    os.makedirs(osp.dirname(out_path) or ".", exist_ok=True)
    h, w = frames[0].shape[:2]
    fourcc = cv2.VideoWriter_fourcc(*"mp4v")
    writer = cv2.VideoWriter(out_path, fourcc, fps, (w, h))
    if writer.isOpened():
        for f in frames:
            writer.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
        writer.release()
        return
    # ffmpeg fallback via image sequence
    import tempfile

    with tempfile.TemporaryDirectory() as td:
        for i, f in enumerate(frames):
            cv2.imwrite(osp.join(td, f"{i:06d}.png"),
                        cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
        subprocess.run(
            ["ffmpeg", "-y", "-framerate", str(fps), "-i",
             osp.join(td, "%06d.png"), "-pix_fmt", "yuv420p", out_path],
            check=True, capture_output=True)


class StreamingVideoWriter:
    """Incremental mp4 writer for unbounded live streams.

    `write_video` buffers a whole frame list — fine offline, unbounded RAM
    for a webcam session. This appends frame-by-frame (cv2 VideoWriter; on
    open failure, a PNG spool dir encoded by ffmpeg at close)."""

    def __init__(self, out_path: str, width: int, height: int,
                 fps: float = 30.0):
        import cv2

        os.makedirs(osp.dirname(out_path) or ".", exist_ok=True)
        self.out_path = out_path
        self.fps = fps
        self.n = 0
        self._spool = None
        self._writer = cv2.VideoWriter(
            out_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (width, height))
        if not self._writer.isOpened():
            import tempfile

            self._writer = None
            self._spool = tempfile.mkdtemp(prefix="tepose_live_")

    def write(self, frame: np.ndarray) -> None:
        import cv2

        bgr = cv2.cvtColor(frame, cv2.COLOR_RGB2BGR)
        if self._writer is not None:
            self._writer.write(bgr)
        else:
            cv2.imwrite(osp.join(self._spool, f"{self.n:06d}.png"), bgr)
        self.n += 1

    def close(self) -> None:
        import shutil

        if self._writer is not None:
            self._writer.release()
            self._writer = None
        elif self._spool is not None:
            subprocess.run(
                ["ffmpeg", "-y", "-framerate", str(self.fps), "-i",
                 osp.join(self._spool, "%06d.png"), "-pix_fmt", "yuv420p",
                 self.out_path],
                check=True, capture_output=True)
            shutil.rmtree(self._spool, ignore_errors=True)
            self._spool = None


def convert_crop_cam_to_orig_img(cam: np.ndarray, bbox: np.ndarray,
                                 img_width: int,
                                 img_height: int) -> np.ndarray:
    """Weak-perspective cam in crop coords -> original-image coords.

    ref: demo_utils.py:241-258. cam (N, 3) = (s, tx, ty); bbox (N, 4) with
    (cx, cy, h, ...) — the square crop side is bbox[:, 2].
    Returns (N, 4) = (sx, sy, tx, ty).
    """
    cx, cy, h = bbox[:, 0], bbox[:, 1], bbox[:, 2]
    hw, hh = img_width / 2.0, img_height / 2.0
    sx = cam[:, 0] * (1.0 / (img_width / h))
    sy = cam[:, 0] * (1.0 / (img_height / h))
    tx = ((cx - hw) / hw / sx) + cam[:, 1]
    ty = ((cy - hh) / hh / sy) + cam[:, 2]
    return np.stack([sx, sy, tx, ty], axis=-1)


def convert_crop_coords_to_orig_img(bbox: np.ndarray, keypoints: np.ndarray,
                                    crop_size: int = 224) -> np.ndarray:
    """Normalised crop keypoints [-1,1] -> original image pixels.

    ref: demo_utils.py:261-274.
    """
    cx, cy, h = bbox[:, 0], bbox[:, 1], bbox[:, 2]
    kp = 0.5 * crop_size * (keypoints + 1.0)
    kp = kp * (h[..., None, None] / crop_size)
    kp[:, :, 0] = (cx - h / 2)[..., None] + kp[:, :, 0]
    kp[:, :, 1] = (cy - h / 2)[..., None] + kp[:, :, 1]
    return kp


def prepare_rendering_results(results: Dict, nframes: int) -> List[Dict]:
    """Regroup per-person results by frame, depth-ordered by cam y-scale.

    ref: demo_utils.py:277-295.
    """
    frame_results: List[Dict] = [{} for _ in range(nframes)]
    for person_id, person_data in results.items():
        for idx, frame_id in enumerate(person_data["frame_ids"]):
            frame_results[int(frame_id)][person_id] = {
                "verts": person_data["verts"][idx],
                "cam": person_data["orig_cam"][idx],
                "bbox": person_data["bboxes"][idx],
            }
    for frame_id, frame_data in enumerate(frame_results):
        keys = list(frame_data.keys())
        sort_idx = np.argsort([frame_data[k]["cam"][1] for k in keys])
        frame_results[frame_id] = OrderedDict(
            (keys[i], frame_data[keys[i]]) for i in sort_idx)
    return frame_results
