"""A copy of `tepose_tpu/streaming/tracker.py` (numpy; cv2 only inside the
functions that use it), reading the port's `ops/filters.py`; pinned equal
to it by tests/test_torch_host.py and tests/test_torch_demo.py.

Multi-person bbox tracking for the demo pipeline.

Replaces the reference's external dependencies (yolov3 + multi-person-tracker
pip packages, demo.py:34,87-100; OpenPose STAF binary, pose_tracker.py):

  * `IoUTracker` — greedy IoU association over per-frame detections, the same
    tracklet output format the reference's MPT produces:
    {person_id: {"bbox": (T, 4) cx,cy,w,h, "frames": (T,)}}.
  * `detect_people_motion` / `detect_people_stabilized` /
    `detect_people_auto` — in-repo multi-person detectors: median-background
    subtraction for static cameras, its global-motion-compensated variant
    for handheld/panning footage, and an auto selector that probes the
    camera motion and picks (the demo default).
  * `detect_people_simple` — a detector-free fallback (single full-frame
    person) so the demo runs without any external detector; precomputed
    detections (e.g. from any off-the-shelf detector) can be passed in via
    --detections <npz>.
  * `CausalPersonTracker` — strictly causal single-person tracker for the
    `demo.py --live` frame-at-a-time path (bootstrap background build, then
    per-frame diff + IoU follow).
  * `CausalPeopleTracker` — its K-slot multi-person generalisation
    (`--live_streams N`): stable person slots with departure detection
    (ghost absorption + appearance templates) and fresh-seed flags that
    reset the paired LiveSession stream.
  * `load_pose_tracklets` — parse OpenPose-style keypoint JSONs into
    tracklets (the `--tracking_method pose` path, ref: pose_tracker.py:52-99).
"""

from __future__ import annotations

import collections
import json
import os.path as osp
from glob import glob
from typing import Dict, List, Optional, Tuple

import numpy as np


def iou_xywh(a: np.ndarray, b: np.ndarray) -> float:
    """IoU of two (cx, cy, w, h) boxes."""
    ax0, ay0 = a[0] - a[2] / 2, a[1] - a[3] / 2
    ax1, ay1 = a[0] + a[2] / 2, a[1] + a[3] / 2
    bx0, by0 = b[0] - b[2] / 2, b[1] - b[3] / 2
    bx1, by1 = b[0] + b[2] / 2, b[1] + b[3] / 2
    ix = max(0.0, min(ax1, bx1) - max(ax0, bx0))
    iy = max(0.0, min(ay1, by1) - max(ay0, by0))
    inter = ix * iy
    union = a[2] * a[3] + b[2] * b[3] - inter
    return inter / union if union > 0 else 0.0


class IoUTracker:
    """Greedy frame-to-frame IoU association with track persistence."""

    def __init__(self, iou_thresh: float = 0.3, max_missed: int = 10):
        self.iou_thresh = iou_thresh
        self.max_missed = max_missed
        self._next_id = 0
        self._active: Dict[int, Dict] = {}
        self._finished: Dict[int, Dict] = {}

    def update(self, frame_idx: int, detections: np.ndarray) -> None:
        """detections: (N, 4) (cx, cy, w, h)."""
        detections = np.asarray(detections, np.float32).reshape(-1, 4)
        unmatched = list(range(len(detections)))
        # match existing tracks greedily by IoU with their last box
        for tid in list(self._active.keys()):
            tr = self._active[tid]
            best, best_iou = None, self.iou_thresh
            for di in unmatched:
                i = iou_xywh(tr["bbox"][-1], detections[di])
                if i > best_iou:
                    best, best_iou = di, i
            if best is not None:
                tr["bbox"].append(detections[best])
                tr["frames"].append(frame_idx)
                tr["missed"] = 0
                unmatched.remove(best)
            else:
                tr["missed"] += 1
                if tr["missed"] > self.max_missed:
                    self._finish(tid)
        # new tracks for unmatched detections
        for di in unmatched:
            self._active[self._next_id] = {
                "bbox": [detections[di]], "frames": [frame_idx], "missed": 0}
            self._next_id += 1

    def _finish(self, tid: int) -> None:
        tr = self._active.pop(tid)
        self._finished[tid] = tr

    def tracklets(self, min_length: int = 6) -> Dict[int, Dict]:
        """Finalise and return {id: {'bbox': (T,4), 'frames': (T,)}}."""
        for tid in list(self._active.keys()):
            self._finish(tid)
        out = {}
        for tid, tr in self._finished.items():
            if len(tr["frames"]) < min_length:
                continue
            out[tid] = {
                "bbox": np.stack(tr["bbox"]).astype(np.float32),
                "frames": np.asarray(tr["frames"], np.int64),
            }
        return out


def detect_people_simple(frame_shape, num_frames: int) -> Dict[int, Dict]:
    """Detector-free fallback: one tracklet covering a centered square box
    (suited to single-person footage when no detector is available)."""
    h, w = frame_shape[:2]
    side = min(h, w) * 0.95
    bbox = np.tile(np.array([w / 2, h / 2, side, side], np.float32),
                   (num_frames, 1))
    return {0: {"bbox": bbox, "frames": np.arange(num_frames)}}


def _work_gray(img: np.ndarray, wh) -> np.ndarray:
    """RGB frame -> work-scale uint8 grayscale (the shared convention of
    every detector in this module)."""
    import cv2

    g = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)
    return cv2.resize(g, wh, interpolation=cv2.INTER_AREA)


def _fg_threshold(vals: np.ndarray) -> float:
    """Adaptive foreground threshold: robust to global lighting/noise."""
    return max(18.0, float(vals.mean() + 2.5 * vals.std()))


def _boxes_from_mask(mask, scale, min_area, kernel, max_people):
    """Morphology + connected components on a foreground mask -> square
    person boxes (cx, cy, side, side) in FULL-resolution coordinates."""
    import cv2

    mask = cv2.morphologyEx(mask, cv2.MORPH_CLOSE, kernel)
    mask = cv2.dilate(mask, kernel, iterations=2)
    n, _, stats, _ = cv2.connectedComponentsWithStats(mask, connectivity=8)
    boxes = []
    for ci in range(1, n):  # 0 = background
        x, y, bw, bh, area = stats[ci]
        if area < min_area:
            continue
        cx = (x + bw / 2.0) / scale
        cy = (y + bh / 2.0) / scale
        side = max(bw, bh) / scale * 1.2
        boxes.append([cx, cy, side, side])
    boxes.sort(key=lambda b: -b[2] * b[3])
    return (np.asarray(boxes[:max_people], np.float32)
            if boxes else np.zeros((0, 4), np.float32))


def detect_people_motion(
    frames: List[np.ndarray],
    min_area_frac: float = 0.003,
    max_people: int = 8,
    bg_samples: int = 30,
    work_width: int = 320,
    iou_thresh: float = 0.2,
    max_missed: int = 15,
    grays: Optional[np.ndarray] = None,
    bg: Optional[np.ndarray] = None,
) -> Dict[int, Dict]:
    """In-repo multi-person proposal detector: median-background subtraction
    + connected components + IoU tracking. No external model needed.

    Replaces the reference's yolov3-via-MPT detector (ref: demo.py:87-100)
    for footage with a mostly static camera: moving people produce foreground
    blobs, blobs become square person boxes, boxes become tracklets through
    `IoUTracker`. Returns the same {id: {"bbox": (T,4) cx,cy,w,h,
    "frames": (T,)}} format. Empty dict when nothing moves (callers fall back
    to `detect_people_simple`).

    `grays`/`bg` are a fast path for callers (CausalPersonTracker's
    bootstrap) that already hold the work-scale float32 grayscale frames
    and/or median background — skips recomputing them here.
    """
    import cv2

    if not frames:
        return {}
    h, w = frames[0].shape[:2]
    scale = work_width / float(w)
    wh = (work_width, max(1, int(round(h * scale))))

    def gray_at(i):
        return (grays[i] if grays is not None
                else _work_gray(frames[i], wh).astype(np.float32))

    if bg is None:
        idxs = np.linspace(0, len(frames) - 1,
                           min(bg_samples, len(frames))).astype(int)
        bg = np.median(np.stack([gray_at(i) for i in idxs]), axis=0)

    kernel = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (7, 7))
    min_area = min_area_frac * wh[0] * wh[1]
    tracker = IoUTracker(iou_thresh=iou_thresh, max_missed=max_missed)

    for f in range(len(frames)):
        diff = np.abs(gray_at(f) - bg)
        mask = (diff > _fg_threshold(diff)).astype(np.uint8) * 255
        tracker.update(
            f, _boxes_from_mask(mask, scale, min_area, kernel, max_people))

    return tracker.tracklets()


def estimate_camera_motion(frames: List[np.ndarray],
                           work_width: int = 320, grays=None):
    """Per-frame camera motion via sparse optical flow + robust similarity.

    Returns (transforms, per_step_px):
      * transforms: list of 2x3 float32 affines mapping WORK-SCALE coords of
        frame t into frame 0's coordinate system (cumulative composition of
        per-step RANSAC-fit partial affines; identity where estimation
        fails);
      * per_step_px: (T-1,) per-step camera translation magnitudes at work
        scale — the "is the camera moving?" statistic used by
        `detect_people_auto`.

    RANSAC (cv2.estimateAffinePartial2D's default) rejects feature tracks on
    moving people as outliers as long as the background dominates the frame,
    which is what makes stabilized background subtraction a valid
    moving-camera person detector (ref capability: demo.py:87-100 runs
    yolov3 on arbitrary handheld footage).

    `grays`: optional precomputed work-scale uint8 grayscale frames (one
    per frame) — callers that also consume them (detect_people_stabilized)
    pass these to skip a second cvtColor+resize pass over the clip.
    """
    import cv2

    if len(frames) < 2:
        return [np.eye(2, 3, dtype=np.float32)] * len(frames), \
            np.zeros((0,), np.float32)
    h, w = frames[0].shape[:2]
    scale = work_width / float(w)
    wh = (work_width, max(1, int(round(h * scale))))

    if grays is not None:
        gray_at = lambda t: grays[t]  # noqa: E731
    else:
        gray_at = lambda t: _work_gray(frames[t], wh)  # noqa: E731

    eye3 = np.eye(3, dtype=np.float64)
    cum = [eye3]
    steps = []
    # on estimation failure (blurry/textureless pair: too few features, LK
    # loss, or RANSAC degenerate) reuse the PREVIOUS step — a
    # constant-velocity assumption. An identity step during a pan would
    # permanently misregister every later frame against the background
    # canvas; carrying the motion degrades gracefully instead.
    last_step = np.eye(2, 3, dtype=np.float64)
    prev = gray_at(0)
    for t in range(1, len(frames)):
        cur = gray_at(t)
        step = None
        pts = cv2.goodFeaturesToTrack(prev, 300, 0.01, 7)
        if pts is not None and len(pts) >= 8:
            nxt, st, _ = cv2.calcOpticalFlowPyrLK(prev, cur, pts, None)
            ok = st.reshape(-1) == 1
            if ok.sum() >= 8:
                # cur -> prev coords, so cumulative composition lands in
                # frame 0's system
                M, _ = cv2.estimateAffinePartial2D(nxt[ok], pts[ok])
                if M is not None:
                    step = M
        if step is None:
            step = last_step
        last_step = step
        steps.append(float(np.hypot(step[0, 2], step[1, 2])))
        m3 = np.vstack([step, [0, 0, 1]])
        cum.append(cum[-1] @ m3)
        prev = cur
    return [c[:2].astype(np.float32) for c in cum], \
        np.asarray(steps, np.float32)


def detect_people_stabilized(
    frames: List[np.ndarray],
    min_area_frac: float = 0.003,
    max_people: int = 8,
    bg_samples: int = 30,
    work_width: int = 320,
    iou_thresh: float = 0.2,
    max_missed: int = 15,
    max_canvas_frames: float = 16.0,
) -> Dict[int, Dict]:
    """Moving-camera person detection: global-motion-compensated background
    subtraction.

    The plain motion detector's median background is only valid for a
    static camera (its own docstring says so); under a pan the whole frame
    becomes "foreground". Here frames are warped into a shared coordinate
    system using `estimate_camera_motion`, and the median background and
    per-frame diffs are computed on a world canvas (with validity masks so
    off-canvas pixels never vote); detected boxes are mapped back through
    each frame's inverse transform. Long pans sweep an unbounded world
    area, so the clip is partitioned into re-anchored segments whose
    canvases each stay under a memory cap (one IoU tracker spans the
    segments, keeping tracklets continuous across the cuts). Replaces the
    appearance half of the reference's yolov3 path
    (ref: demo.py:87-100) without any pretrained weights — the baked-in
    OpenCV 5 dropped HOGDescriptor, so compensation, not appearance, is the
    in-repo answer for handheld footage.
    """
    import cv2

    if not frames:
        return {}
    h, w = frames[0].shape[:2]
    scale = work_width / float(w)
    wh = (work_width, max(1, int(round(h * scale))))

    # ONE grayscale pass over the clip, shared with the motion estimate
    # (uint8 work-scale: ~1/16 the bytes of the RGB frames the caller
    # already holds)
    grays = [_work_gray(f, wh) for f in frames]
    transforms, _ = estimate_camera_motion(frames, work_width, grays=grays)
    corners = np.array([[0, 0], [wh[0], 0], [0, wh[1]], [wh[0], wh[1]]],
                       np.float32)
    canvas_cap = max_canvas_frames * wh[0] * wh[1]

    def corner_span(M):
        pts = corners @ M[:, :2].T + M[:, 2]
        return pts.min(axis=0), pts.max(axis=0)

    def span_to_bounds(mins, maxs):
        x0, y0 = np.floor(mins).astype(int)
        x1, y1 = np.ceil(maxs).astype(int)
        return int(x0), int(y0), int(x1 - x0), int(y1 - y0)

    # Long legitimate pans sweep an unbounded world area, so one global
    # canvas cannot cap memory. Partition the clip into SEGMENTS, each
    # re-anchored to its own first frame, greedily extended while the
    # segment's canvas stays under the cap; each segment gets its own
    # background model, while ONE IoUTracker spans all segments so
    # tracklets stay continuous across the cuts. The extension is
    # incremental — one composed transform + a running corner min/max per
    # appended frame — so segment construction is O(len), not O(len^2).
    segments = []  # (t0, t1, seg_transforms, offset, (cw, ch))
    t0 = 0
    n = len(frames)
    while t0 < n:
        inv0 = np.linalg.inv(np.vstack([transforms[t0], [0, 0, 1]]))

        def compose(t):
            return (inv0 @ np.vstack([transforms[t], [0, 0, 1]]))[:2] \
                .astype(np.float32)

        t1 = min(t0 + 2, n)
        seg = [compose(t) for t in range(t0, t1)]
        mins, maxs = corner_span(seg[0])
        for M in seg[1:]:
            mn, mx = corner_span(M)
            mins, maxs = np.minimum(mins, mn), np.maximum(maxs, mx)
        x0, y0, cw, ch = span_to_bounds(mins, maxs)
        if cw * ch > canvas_cap:
            # runaway motion estimate (degenerate tracking): even a
            # two-frame canvas blows the cap — bail out to the
            # static-camera detector rather than allocating a huge canvas
            return detect_people_motion(frames, min_area_frac, max_people,
                                        bg_samples, work_width, iou_thresh,
                                        max_missed)
        while t1 < n:
            M = compose(t1)
            mn, mx = corner_span(M)
            nmins = np.minimum(mins, mn)
            nmaxs = np.maximum(maxs, mx)
            nx0, ny0, ncw, nch = span_to_bounds(nmins, nmaxs)
            if ncw * nch > canvas_cap:
                break
            seg.append(M)
            mins, maxs = nmins, nmaxs
            x0, y0, cw, ch = nx0, ny0, ncw, nch
            t1 += 1
        offset = np.array([[0, 0, -x0], [0, 0, -y0]], np.float32)
        segments.append((t0, t1, seg, offset, (cw, ch)))
        t0 = t1

    kernel = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (7, 7))
    min_area = min_area_frac * wh[0] * wh[1]
    tracker = IoUTracker(iou_thresh=iou_thresh, max_missed=max_missed)
    import warnings

    for t0, t1, seg, offset, (cw, ch) in segments:
        idxs = t0 + np.linspace(0, t1 - t0 - 1,
                                min(bg_samples, t1 - t0)).astype(int)
        # cache ONLY the <=bg_samples background-model frames (reused by
        # the scan); scan-only frames are used exactly once — caching every
        # warped canvas would grow O(segment_len x canvas_area) and OOM on
        # long near-static clips despite the canvas cap
        idx_set = set(int(i) for i in idxs)
        warped = {}

        def warp(t):
            if t in warped:
                return warped[t]
            M = seg[t - t0] + offset
            g = cv2.warpAffine(grays[t], M, (cw, ch),
                               flags=cv2.INTER_LINEAR,
                               borderMode=cv2.BORDER_CONSTANT, borderValue=0)
            v = cv2.warpAffine(np.full(wh[::-1], 255, np.uint8), M, (cw, ch),
                               flags=cv2.INTER_NEAREST,
                               borderMode=cv2.BORDER_CONSTANT, borderValue=0)
            out = (g.astype(np.float32), v > 0)
            if t in idx_set:
                warped[t] = out
            return out
        samples = [warp(i) for i in idxs]
        stack = np.stack([g for g, _ in samples])
        valid = np.stack([v for _, v in samples])
        stack[~valid] = np.nan
        count = valid.sum(axis=0)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)  # all-NaN cols
            bg = np.nanmedian(stack, axis=0)
        bg_ok = count >= max(3, len(samples) // 4)

        for f in range(t0, t1):
            g, v = warp(f)
            ok = v & bg_ok
            diff = np.where(ok, np.abs(g - bg), 0.0).astype(np.float32)
            vals = diff[ok]
            if vals.size == 0:
                tracker.update(f, np.zeros((0, 4), np.float32))
                continue
            mask = ((diff > _fg_threshold(vals)) & ok).astype(np.uint8) * 255
            boxes = _boxes_from_mask(mask, 1.0, min_area, kernel,
                                     max_people)
            if len(boxes):
                # world -> frame-f work coords -> full resolution
                inv = cv2.invertAffineTransform(seg[f - t0] + offset)
                ctr = boxes[:, :2] @ inv[:, :2].T + inv[:, 2]
                s = float(np.sqrt(abs(np.linalg.det(inv[:, :2]))))
                boxes = np.stack([ctr[:, 0] / scale, ctr[:, 1] / scale,
                                  boxes[:, 2] * s / scale,
                                  boxes[:, 3] * s / scale], axis=1)
                # drop boxes that left the actual frame
                inside = ((boxes[:, 0] > -boxes[:, 2])
                          & (boxes[:, 0] < w + boxes[:, 2])
                          & (boxes[:, 1] > -boxes[:, 3])
                          & (boxes[:, 1] < h + boxes[:, 3]))
                boxes = boxes[inside].astype(np.float32)
            tracker.update(f, boxes)

    return tracker.tracklets()


def detect_people_auto(frames: List[np.ndarray],
                       pan_thresh_px: float = 0.35,
                       probe_frames: int = 24,
                       **kw) -> Dict[int, Dict]:
    """Pick the right built-in detector for the footage (the demo default).

    A cheap probe estimates the camera's per-frame translation on up to
    `probe_frames` CONSECUTIVE frame pairs scattered evenly through the
    clip; if the median exceeds `pan_thresh_px` (work-scale pixels/frame)
    the footage is treated as moving-camera and routed to
    `detect_people_stabilized`, else to the cheaper
    `detect_people_motion`. Consecutive pairs matter: estimating flow
    between frames many steps apart fails silently on long clips (the
    displacement exceeds what pyramidal LK can track) and under-reports
    motion, which would route pans to the static-camera detector. Mirrors
    VERDICT r2 ask #1 (auto detector selection by a global-motion
    estimate).
    """
    if len(frames) < 2:
        return {}
    starts = np.unique(np.linspace(
        0, len(frames) - 2, min(probe_frames, len(frames) - 1)).astype(int))
    per_frame = []
    for i in starts:
        _, step = estimate_camera_motion([frames[i], frames[i + 1]],
                                         kw.get("work_width", 320))
        if len(step):
            per_frame.append(float(step[0]))
    moving = (len(per_frame) > 0
              and float(np.median(per_frame)) > pan_thresh_px)
    det = detect_people_stabilized if moving else detect_people_motion
    # kwargs routing: which detector runs depends on the FOOTAGE, so a
    # detector-specific kwarg (max_canvas_frames / grays / bg) must not
    # crash when the probe picks the other route — drop what the chosen
    # detector doesn't take, but still reject names neither knows
    import inspect

    stab = set(inspect.signature(detect_people_stabilized).parameters)
    mot = set(inspect.signature(detect_people_motion).parameters)
    unknown = set(kw) - (stab | mot)
    if unknown:
        raise TypeError(f"unknown detector kwargs: {sorted(unknown)}")
    accepted = stab if moving else mot
    return det(frames, **{k: v for k, v in kw.items() if k in accepted})


class _CausalBackgroundTracker:
    """Shared machinery of the causal live trackers: work-scale geometry,
    the grayscale median/adapted background model, foreground candidate
    extraction, and quiet-pixel background adaptation. Subclasses own the
    box-association policy (single box vs K stable slots)."""

    def __init__(self, bootstrap: int, work_width: int, min_area_frac: float,
                 ema: float, bg_alpha: float, iou_keep: float):
        import cv2

        self.bootstrap = max(2, int(bootstrap))
        self.work_width = work_width
        self.min_area_frac = min_area_frac
        self.ema = float(ema)
        self.bg_alpha = float(bg_alpha)
        self.iou_keep = float(iou_keep)
        self._buf: List[np.ndarray] = []
        self._bg: Optional[np.ndarray] = None
        self._wh = None
        self._scale = None
        self._full = None
        self._kernel = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (7, 7))

    def _init_geometry(self, frame: np.ndarray) -> None:
        h, w = frame.shape[:2]
        self._scale = self.work_width / float(w)
        self._wh = (self.work_width, max(1, int(round(h * self._scale))))
        side = min(h, w) * 0.95
        self._full = np.array([w / 2, h / 2, side, side], np.float32)

    def _small_gray(self, img: np.ndarray) -> np.ndarray:
        return _work_gray(img, self._wh).astype(np.float32)

    def _candidates(self, g: np.ndarray, max_people: int):
        """Foreground boxes of the current work-scale gray vs the background.

        Returns (diff, thr, cands) — diff/thr are reused by `_adapt_bg`.
        """
        diff = np.abs(g - self._bg)
        thr = _fg_threshold(diff)
        mask = (diff > thr).astype(np.uint8) * 255
        min_area = self.min_area_frac * self._wh[0] * self._wh[1]
        cands = _boxes_from_mask(mask, self._scale, min_area, self._kernel,
                                 max_people=max_people)
        return diff, thr, cands

    def _adapt_bg(self, g: np.ndarray, diff: np.ndarray, thr: float) -> None:
        # adapt the background where nothing moved (lighting drift); the
        # person's own pixels stay out so they can't burn into the model
        quiet = diff <= thr
        self._bg[quiet] += self.bg_alpha * (g[quiet] - self._bg[quiet])

    def _work_rect(self, box: np.ndarray, shape) -> Tuple[int, int, int, int]:
        """Clip a full-coords (cx, cy, side, ...) box to work-scale bounds."""
        s = self._scale
        cx, cy, side = box[0] * s, box[1] * s, box[2] * s
        h, w = shape
        x0 = max(0, int(cx - side / 2)); x1 = min(w, int(cx + side / 2) + 1)
        y0 = max(0, int(cy - side / 2)); y1 = min(h, int(cy + side / 2) + 1)
        return x0, x1, y0, y1


class CausalPersonTracker(_CausalBackgroundTracker):
    """Frame-at-a-time single-person box tracker for the live demo path.

    The offline detectors need the whole clip (their median background is
    built from frames sampled across the video); a live source only has the
    past. This tracker is strictly causal:

      * bootstrap — the first `bootstrap` frames are buffered; on the last
        one a median background is frozen and `detect_people_motion` runs
        over the buffer. `update()` then returns one box per buffered frame
        (the dominant tracklet, gap-filled), so the caller can drain its
        frame queue. A live system pays this once as startup delay.
      * steady state — each new frame diffs against the (slowly adapted)
        background; candidates come from the same morphology/connected-
        components machinery; the candidate with best IoU against the
        current box wins and is EMA-smoothed. When nothing is found the
        previous box carries over (person standing still == no foreground).

    Static-camera scope like `detect_people_motion` — live sources (webcams,
    fixed installs) are overwhelmingly static-camera; moving-camera *files*
    should use the offline `--detector stabilized` path. TPU-new capability:
    the reference has no live mode at all (its demo batches whole tracklets,
    ref: demo.py:171-252).
    """

    def __init__(self, bootstrap: int = 25, work_width: int = 320,
                 min_area_frac: float = 0.003, ema: float = 0.5,
                 bg_alpha: float = 0.02, iou_keep: float = 0.05):
        super().__init__(bootstrap, work_width, min_area_frac, ema,
                         bg_alpha, iou_keep)
        self._box: Optional[np.ndarray] = None

    def update(self, frame: np.ndarray) -> np.ndarray:
        """Feed one RGB frame; returns (k, 4) (cx, cy, side, side) boxes for
        the k oldest frames not yet boxed — k=0 while bootstrapping, k=
        `bootstrap` on the frame completing it, k=1 afterwards."""
        if self._wh is None:
            self._init_geometry(frame)
        if self._bg is None:
            self._buf.append(frame)
            if len(self._buf) < self.bootstrap:
                return np.zeros((0, 4), np.float32)
            return self._finish_bootstrap()
        return self._step(frame)[None]

    def flush(self) -> np.ndarray:
        """End-of-stream: if still bootstrapping, detect on whatever arrived
        and return those boxes (k = frames buffered so far)."""
        if self._bg is None and self._buf:
            return self._finish_bootstrap()
        return np.zeros((0, 4), np.float32)

    def _finish_bootstrap(self) -> np.ndarray:
        grays = np.stack([self._small_gray(f) for f in self._buf])
        self._bg = np.median(grays, axis=0)
        tracklets = detect_people_motion(
            self._buf, min_area_frac=self.min_area_frac,
            work_width=self.work_width, grays=grays, bg=self._bg)
        boxes = np.tile(self._full, (len(self._buf), 1))
        if tracklets:
            tid = max(tracklets,
                      key=lambda k: (len(tracklets[k]["frames"]),
                                     float(tracklets[k]["bbox"][:, 2].max())))
            tr = tracklets[tid]
            for i in range(len(self._buf)):  # nearest-detection gap fill
                j = int(np.argmin(np.abs(tr["frames"] - i)))
                boxes[i] = tr["bbox"][j]
        self._box = boxes[-1].copy()
        self._buf = []
        return boxes.astype(np.float32)

    def _step(self, frame: np.ndarray) -> np.ndarray:
        g = self._small_gray(frame)
        diff, thr, cands = self._candidates(g, max_people=8)
        best = None
        if len(cands):
            ious = [iou_xywh(self._box, c) for c in cands]
            bi = int(np.argmax(ious))
            if ious[bi] >= self.iou_keep:
                best = cands[bi]
        if best is not None:
            self._box = self.ema * self._box + (1.0 - self.ema) * best
        self._adapt_bg(g, diff, thr)
        return self._box.astype(np.float32).copy()


class CausalPeopleTracker(_CausalBackgroundTracker):
    """Strictly causal K-slot multi-person tracker for `demo.py --live`.

    Generalizes `CausalPersonTracker` to up to `slots` concurrent people in
    STABLE slots (slot i keeps following the same person), sized to pair
    with a `LiveSession(n_streams=slots)`: when a slot's track dies and a
    new person re-seeds it, the step flags it `fresh` so the caller resets
    the corresponding LiveSession stream (push(..., reset=fresh)).

    update(frame) returns (boxes, present, fresh) for the k oldest frames
    not yet boxed (k=0 while bootstrapping, k=bootstrap on the completing
    frame, k=1 afterwards):
      * boxes   (k, slots, 4) — (cx, cy, side, side); empty slots carry a
        centered full-frame box (their stream output is masked by present)
      * present (k, slots) bool — slot holds a person at that frame
      * fresh   (k, slots) bool — slot was (re)seeded AT that frame: reset
        its stream before pushing

    Two departure-robustness rules on top of the single-person tracker:
    a matched blob with no frame-to-frame motion for `static_absorb`
    consecutive frames *whose appearance no longer matches the slot's
    template* is a GHOST (a departed person baked into the bootstrap
    median — the region now shows empty background) and is absorbed into
    the background so the track can actually die; a motionless blob that
    still LOOKS like the tracked person is a person standing still and is
    kept (the template, a small gray patch refreshed while the person
    moves, is what disambiguates the two). And a slot that is already
    coasting (missed > 0) needs `iou_reacquire` (not the loose `iou_keep`)
    to claim a detection, so a stale slot cannot silently capture a
    newcomer — the newcomer instead waits for the slot to free and
    re-seeds it fresh.
    """

    TMPL = 24      # appearance-template side (work-scale gray patch)
    TMPL_LAG = 5   # history depth: _looks_tracked compares the oldest entry

    def __init__(self, slots: int = 2, bootstrap: int = 25,
                 work_width: int = 320, min_area_frac: float = 0.003,
                 ema: float = 0.5, bg_alpha: float = 0.02,
                 iou_keep: float = 0.05, max_missed: int = 25,
                 iou_reacquire: float = 0.25, static_absorb: int = 4,
                 static_motion_eps: float = 4.0, static_frac: float = 0.02,
                 ghost_mad: float = 12.0):
        super().__init__(bootstrap, work_width, min_area_frac, ema,
                         bg_alpha, iou_keep)
        self.slots = int(slots)
        self.max_missed = int(max_missed)
        self.iou_reacquire = float(iou_reacquire)
        self.static_absorb = max(1, int(static_absorb))
        self.static_motion_eps = float(static_motion_eps)
        self.static_frac = float(static_frac)
        self.ghost_mad = float(ghost_mad)
        self._boxes: Optional[np.ndarray] = None     # (slots, 4)
        self._present: Optional[np.ndarray] = None   # (slots,) bool
        self._missed: Optional[np.ndarray] = None    # (slots,) int
        self._streak: Optional[np.ndarray] = None    # (slots,) static frames
        self._tmpl: Optional[list] = None  # per-slot deques of patches
        self._prev_g: Optional[np.ndarray] = None

    def update(self, frame: np.ndarray):
        if self._wh is None:
            self._init_geometry(frame)
        if self._bg is None:
            self._buf.append(frame)
            if len(self._buf) < self.bootstrap:
                return (np.zeros((0, self.slots, 4), np.float32),
                        np.zeros((0, self.slots), bool),
                        np.zeros((0, self.slots), bool))
            return self._finish_bootstrap()
        b, p, f = self._step(frame)
        return b[None], p[None], f[None]

    def flush(self):
        """End-of-stream: drain a bootstrap that never completed."""
        if self._bg is None and self._buf:
            return self._finish_bootstrap()
        return (np.zeros((0, self.slots, 4), np.float32),
                np.zeros((0, self.slots), bool),
                np.zeros((0, self.slots), bool))

    def _finish_bootstrap(self):
        K, n = self.slots, len(self._buf)
        grays = np.stack([self._small_gray(f) for f in self._buf])
        self._bg = np.median(grays, axis=0)
        tracklets = detect_people_motion(
            self._buf, min_area_frac=self.min_area_frac,
            work_width=self.work_width, max_people=K + 4,
            grays=grays, bg=self._bg)
        ranked = sorted(tracklets.values(),
                        key=lambda tr: (-len(tr["frames"]),
                                        -float(tr["bbox"][:, 2].max())))[:K]
        boxes = np.tile(self._full, (n, K, 1)).reshape(n, K, 4)
        present = np.zeros((n, K), bool)
        fresh = np.zeros((n, K), bool)
        self._tmpl = [collections.deque(maxlen=self.TMPL_LAG)
                      for _ in range(K)]
        for s, tr in enumerate(ranked):
            for i in range(n):  # nearest-detection gap fill per slot
                j = int(np.argmin(np.abs(tr["frames"] - i)))
                boxes[i, s] = tr["bbox"][j]
            # presence starts at the tracklet's actual onset — a person who
            # entered mid-bootstrap must not be rendered onto the earlier
            # frames; the paired stream resets at the onset so its temporal
            # context starts with the person's first real frame
            onset = int(tr["frames"].min())
            present[onset:, s] = True
            if onset > 0:
                fresh[onset, s] = True
            self._remember(grays[-1], boxes[-1, s], s, reset=True)
        self._boxes = boxes[-1].copy()
        self._present = present[-1].copy()
        self._missed = np.zeros((K,), np.int64)
        self._streak = np.zeros((K,), np.int64)
        self._prev_g = grays[-1]
        self._buf = []
        return boxes.astype(np.float32), present, fresh

    def _motion_frac(self, fdiff, box):
        """Fraction of a (full-coords cx,cy,side) box with frame motion."""
        x0, x1, y0, y1 = self._work_rect(box, fdiff.shape)
        if x1 <= x0 or y1 <= y0:
            return 1.0
        patch = fdiff[y0:y1, x0:x1]
        return float((patch > self.static_motion_eps).mean())

    def _patch(self, g, box):
        """Fixed-size appearance template of `box` in the work-scale gray."""
        import cv2

        x0, x1, y0, y1 = self._work_rect(box, g.shape)
        if x1 <= x0 or y1 <= y0:
            return None
        return cv2.resize(g[y0:y1, x0:x1], (self.TMPL, self.TMPL),
                          interpolation=cv2.INTER_AREA)

    def _remember(self, g, box, s, reset=False) -> None:
        """Append the region's appearance to slot `s`'s template history."""
        patch = self._patch(g, box)
        if reset:
            self._tmpl[s].clear()
        if patch is not None:
            self._tmpl[s].append(patch)

    def _looks_tracked(self, g, box, s) -> bool:
        """Does the region still look like the person slot `s` follows?

        Compared against the OLDEST remembered patch, not the latest: a
        departure event is itself a high-motion frame, so the newest
        remembered appearance can already BE the post-departure background
        — the lag keeps the comparison anchored on the person.
        """
        patch = self._patch(g, box)
        if patch is None or not self._tmpl[s]:
            return False
        return float(np.abs(patch - self._tmpl[s][0]).mean()) < self.ghost_mad

    def _absorb(self, g, box):
        """Write the current frame into the background inside `box`."""
        x0, x1, y0, y1 = self._work_rect(box, g.shape)
        self._bg[y0:y1, x0:x1] = g[y0:y1, x0:x1]

    def _step(self, frame):
        K = self.slots
        g = self._small_gray(frame)
        fdiff = np.abs(g - self._prev_g)
        self._prev_g = g
        diff, thr, cands = self._candidates(g, max_people=K + 4)
        fresh = np.zeros((K,), bool)
        taken = np.zeros((len(cands),), bool)
        # greedy: each occupied slot claims its best-IoU candidate.  A slot
        # already coasting (missed > 0) must clear the stricter reacquire
        # gate, so a stale box cannot capture a newly-arrived person.
        for s in range(K):
            if not self._present[s]:
                continue
            best, best_iou = None, (self.iou_keep if self._missed[s] == 0
                                    else self.iou_reacquire)
            for ci in range(len(cands)):
                if taken[ci]:
                    continue
                i = iou_xywh(self._boxes[s], cands[ci])
                if i > best_iou:
                    best, best_iou = ci, i
            if best is not None:
                taken[best] = True
                self._boxes[s] = (self.ema * self._boxes[s]
                                  + (1.0 - self.ema) * cands[best])
                self._missed[s] = 0
                # ghost watch: a matched blob with ~zero frame-to-frame
                # motion AND an appearance that no longer matches the
                # slot's template is a departed person baked into the
                # bootstrap median (the region now shows empty
                # background).  After static_absorb such frames, fold the
                # region into the background so the track can die.  A
                # motionless blob that still looks like the person is a
                # person standing still — keep following.
                static = (self._motion_frac(fdiff, cands[best])
                          < self.static_frac)
                if static and not self._looks_tracked(g, cands[best], s):
                    self._streak[s] += 1
                    if self._streak[s] >= self.static_absorb:
                        self._absorb(g, cands[best])
                        self._streak[s] = 0
                else:
                    self._streak[s] = 0
                    if not static:
                        # refresh the appearance history while the person
                        # demonstrably moves (only then is the blob surely
                        # the person, not a ghost)
                        self._remember(g, cands[best], s)
            else:
                self._missed[s] += 1  # person still: keep following the box
                self._streak[s] = 0
                if self._missed[s] > self.max_missed:
                    self._present[s] = False  # track died, slot freed
        # unmatched candidates (largest first) seed free slots
        for ci in range(len(cands)):
            if taken[ci]:
                continue
            free = np.flatnonzero(~self._present)
            if not len(free):
                break
            s = int(free[0])
            self._boxes[s] = cands[ci].copy()
            self._present[s] = True
            self._missed[s] = 0
            self._streak[s] = 0
            self._remember(g, cands[ci], s, reset=True)
            fresh[s] = True
        self._adapt_bg(g, diff, thr)
        boxes = np.where(self._present[:, None], self._boxes,
                         self._full[None]).astype(np.float32)
        return boxes.copy(), self._present.copy(), fresh


def run_staf(video_file: str, output_folder: str, staf_dir: str,
             vis: bool = False) -> Dict[int, Dict]:
    """Shell out to the OpenPose STAF binary, then parse its JSONs.

    ref: lib/utils/pose_tracker.py:25-48 (run_openpose) — same binary path,
    model and tracking flags; the binary itself is an optional external
    install (STAF is not shipped).
    """
    import os
    import subprocess

    binary = osp.join(staf_dir, "build/examples/openpose/openpose.bin")
    if not osp.isfile(binary):
        raise FileNotFoundError(
            f"STAF openpose binary not found at {binary}; install STAF or "
            "use --detections / the built-in motion detector")
    os.makedirs(output_folder, exist_ok=True)
    cmd = [
        "build/examples/openpose/openpose.bin",
        "--model_pose", "BODY_21A",
        "--tracking", "1",
        "--render_pose", "1" if vis else "0",
        "--video", osp.abspath(video_file),
        "--write_json", osp.abspath(output_folder),
        "--display", "2" if vis else "0",
    ]
    print("Executing", " ".join(cmd))
    subprocess.check_call(cmd, cwd=staf_dir)
    return load_pose_tracklets(output_folder)


def load_detections_npz(path: str, num_frames: int) -> Dict[int, Dict]:
    """Load precomputed per-frame detections and track them.

    npz with arrays `frames` (N,) and `boxes` (N, 4) (cx, cy, w, h), or
    already-tracked `tracklet_{i}_bbox` / `tracklet_{i}_frames` pairs.
    """
    z = np.load(path)
    if "boxes" in z:
        tracker = IoUTracker()
        frames = z["frames"]
        boxes = z["boxes"]
        for f in range(num_frames):
            tracker.update(f, boxes[frames == f])
        return tracker.tracklets()
    out = {}
    i = 0
    while f"tracklet_{i}_bbox" in z:
        out[i] = {"bbox": z[f"tracklet_{i}_bbox"].astype(np.float32),
                  "frames": z[f"tracklet_{i}_frames"].astype(np.int64)}
        i += 1
    return out


def load_pose_tracklets(json_folder: str,
                        vis_thresh: float = 0.3) -> Dict[int, Dict]:
    """Parse OpenPose-format person keypoints JSONs into bbox tracklets.

    ref: lib/utils/pose_tracker.py:52-99 (read_posetrack_keypoints +
    conversion): per-frame people with `person_id` and pose_keypoints_2d;
    boxes derived from visible joints via the 150-px person scaling.
    """
    from tepose_tpu_torch.ops.filters import kp_to_bbox_param

    people: Dict[int, Dict[str, list]] = {}
    files = sorted(glob(osp.join(json_folder, "*.json")))
    for idx, path in enumerate(files):
        with open(path) as f:
            data = json.load(f)
        for person in data.get("people", []):
            pid = int(person.get("person_id", [0])[0]
                      if isinstance(person.get("person_id"), list)
                      else person.get("person_id", 0))
            kp = np.asarray(person["pose_keypoints_2d"],
                            np.float32).reshape(-1, 3)
            p = kp_to_bbox_param(kp, vis_thresh)
            if p is None:
                continue
            entry = people.setdefault(pid, {"bbox": [], "frames": [],
                                            "joints2d": []})
            size = 150.0 / p[2] * 1.2
            entry["bbox"].append([p[0], p[1], size, size])
            entry["frames"].append(idx)
            entry["joints2d"].append(kp)
    return {pid: {"bbox": np.asarray(v["bbox"], np.float32),
                  "frames": np.asarray(v["frames"], np.int64),
                  "joints2d": np.asarray(v["joints2d"], np.float32)}
            for pid, v in people.items() if len(v["frames"]) >= 6}
