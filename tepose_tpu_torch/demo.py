"""In-the-wild video demo of the port: `python -m tepose_tpu_torch.demo`.

Counterpart of the repository's `demo.py` (JAX), with the same flags.
Pipeline per person tracklet: bbox crops -> ResNet-50 features -> VIBE
bootstrap -> TePose sliding-window streaming (`StreamingEngine`) ->
optional Temporal SMPLify (`--run_smplify`) and 1-euro smoothing
(`--smooth`) -> mesh overlay with the native rasterizer -> output video.

  python -m tepose_tpu_torch.demo --vid_file video.mp4 [--model ckpt.npz]
      [--smooth] [--sideview] [--render_plain] [--save_pkl] [--save_obj]
      [--detections dets.npz | --tracking_method pose --staf_dir <jsons>]
      [--gpu 0|cpu]
  python -m tepose_tpu_torch.demo --synthetic     # generated video, seeded
                                                  # random weights
  python -m tepose_tpu_torch.demo --live --vid_file cam:0

The offline `main` is split at decode: `track` turns decoded RGB frames
into tracklets, `run_offline` runs every device step (engine, SMPLify,
smoothing) and the rendering on decoded frames and returns the results
and rendered frames, and `main` decodes, calls both and writes. Only
decoding, the motion detectors, --wireframe, --display, the video writer
and --save_pkl need OpenCV or joblib, imported where they are used.
The models run on `cuda:<gpu>` unless `--gpu cpu`. `--profile` belongs
with the port's profiling and raises.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import os.path as osp
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

MIN_NUM_FRAMES = 25


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--vid_file", type=str, default="",
                   help="input video path")
    p.add_argument("--tracking_method", type=str, default="bbox",
                   choices=["bbox", "pose"])
    p.add_argument("--model", type=str,
                   default="data/pretrained_models/tepose_wpw_3dpw_test.npz")
    p.add_argument("--detections", type=str, default="",
                   help="npz of precomputed detections/tracklets")
    p.add_argument("--staf_dir", type=str, default="",
                   help="OpenPose STAF install dir (runs the binary) or a "
                        "folder of precomputed keypoint JSONs")
    p.add_argument("--detector", type=str, default="auto",
                   choices=["auto", "motion", "stabilized", "none"],
                   help="built-in detector when no --detections are given: "
                        "'auto' = probe camera motion and pick; 'motion' = "
                        "background-subtraction proposals (static camera); "
                        "'stabilized' = global-motion-compensated background "
                        "subtraction (handheld/panning footage); 'none' = "
                        "single full-frame tracklet. The motion-based "
                        "detectors cannot see a motionless person: pass "
                        "--detections for static subjects")
    p.add_argument("--yolo_img_size", type=int, default=416,
                   help="ignored: the built-in detector replaces yolov3")
    p.add_argument("--tracker_batch_size", type=int, default=12,
                   help="ignored: the built-in IoU tracker is not batched")
    p.add_argument("--display", action="store_true",
                   help="show the rendered frames in a window while writing")
    p.add_argument("--precision", type=str, default="float32",
                   choices=["float32", "bf16"],
                   help="bf16 runs the ResNet-50 feature extractor in "
                        "bfloat16 (fine for the demo, not for metric eval)")
    p.add_argument("--serving", nargs="?", const="serving",
                   choices=["serving", "serving-joints"], default=None,
                   help="composed serving preset (bf16 backbone + f16 "
                        "output readbacks; 'serving-joints' ships joints "
                        "only, no meshes, so it excludes rendering and "
                        "--save_obj); see streaming.engine.ENGINE_PRESETS")
    p.add_argument("--save_pkl", action="store_true")
    p.add_argument("--save_obj", action="store_true")
    p.add_argument("--run_smplify", action="store_true")
    p.add_argument("--gender", type=str, default="neutral")
    p.add_argument("--wireframe", action="store_true")
    p.add_argument("--sideview", action="store_true")
    p.add_argument("--render_plain", action="store_true")
    p.add_argument("--smooth", action="store_true")
    p.add_argument("--smooth_min_cutoff", type=float, default=0.004)
    p.add_argument("--smooth_beta", type=float, default=0.7)
    p.add_argument("--gpu", type=str, default="0",
                   help="CUDA device index, or 'cpu'")
    p.add_argument("--output_folder", type=str, default="output/demo")
    p.add_argument("--synthetic", action="store_true",
                   help="smoke-run on a generated video with random weights")
    p.add_argument("--profile", type=str, default="",
                   help="not ported: a device trace goes with the port's "
                        "profiling")
    p.add_argument("--live", action="store_true",
                   help="frame-at-a-time causal mode: pose for frame t is "
                        "computed (and rendered) the moment frame t arrives. "
                        "--vid_file may be cam:<N> for a webcam")
    p.add_argument("--live_bootstrap", type=int, default=MIN_NUM_FRAMES,
                   help="frames buffered at stream start to build the "
                        "causal detector's background model")
    p.add_argument("--live_max_frames", type=int, default=0,
                   help="stop the live loop after N frames (0 = all)")
    p.add_argument("--live_streams", type=int, default=1,
                   help="live mode person slots: N>1 follows up to N people "
                        "concurrently in stable slots")
    return p.parse_args(argv)


def make_synthetic_video(path: str, n_frames: int = 40,
                         size=(240, 320)) -> None:
    """The JAX demo's generated clip: a circle swaying over a flat
    background with seeded noise."""
    import cv2

    h, w = size
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 25,
                             (w, h))
    rs = np.random.RandomState(0)
    for t in range(n_frames):
        frame = np.full((h, w, 3), 40, np.uint8)
        cx = int(w / 2 + 40 * np.sin(t / 8))
        cv2.circle(frame, (cx, h // 2), 40, (0, 180, 220), -1)
        frame += rs.randint(0, 10, frame.shape).astype(np.uint8)
        writer.write(frame)
    writer.release()


@dataclasses.dataclass
class DemoModels:
    smpl: object
    faces: np.ndarray
    gen: torch.nn.Module
    vibe: torch.nn.Module
    backbone: torch.nn.Module


def build_demo_models(args) -> DemoModels:
    """SMPL assets and the three nets on the demo's device. --synthetic
    draws TePose, VIBE and the ResNet-50 from torch.Generator seeds 0, 1
    and 2 (and, without SMPL assets, takes the synthetic SMPL model with
    convex-hull faces); otherwise they load the converted checkpoints."""
    from tepose_tpu_torch.config import BASE_DATA_DIR
    from tepose_tpu_torch.models.backbone import ResNet50, resnet50_init
    from tepose_tpu_torch.models.smpl import (
        hull_faces, load_smpl_assets, load_smpl_faces, synthetic_smpl_model)
    from tepose_tpu_torch.models.tepose import (
        TePose, TePoseConfig, Vibe, VibeConfig)
    from tepose_tpu_torch.weights import (
        load_checkpoint, state_dict_from_jax_tree)

    device = "cpu" if args.gpu == "cpu" else f"cuda:{int(args.gpu)}"
    mcfg = TePoseConfig(seqlen=6, n_layers=2, hidden_size=1024)
    vcfg = VibeConfig(seqlen=16, n_layers=2, hidden_size=1024,
                      add_linear=True)
    smpl_npz = osp.join(BASE_DATA_DIR, f"smpl_{args.gender}.npz")
    if osp.isfile(smpl_npz):
        smpl = load_smpl_assets(smpl_npz, device)
        faces = load_smpl_faces(smpl_npz)
    elif args.synthetic:
        smpl = synthetic_smpl_model(seed=0, device=device)
        faces = hull_faces(smpl)
    else:
        sys.exit(f"{smpl_npz} missing — convert your SMPL model with "
                 "tools/convert_smpl.py (or --synthetic to smoke-run)")

    gen = TePose(mcfg, generator=torch.Generator().manual_seed(0),
                 device=device)
    vibe = Vibe(vcfg, generator=torch.Generator().manual_seed(1),
                device=device)
    if args.synthetic:
        backbone = resnet50_init(torch.Generator().manual_seed(2), device)
    else:
        if not osp.isfile(args.model):
            sys.exit(f"{args.model} is not a pretrained model!")
        spin_npz = osp.join(BASE_DATA_DIR, "spin_model_checkpoint.npz")
        vibe_npz = osp.join(BASE_DATA_DIR, "vibe_wo_3dpw.npz")
        for pth in (spin_npz, vibe_npz):
            if not osp.isfile(pth):
                sys.exit(f"{pth} missing — run tools/convert_checkpoint.py")
        gen.load_state_dict(state_dict_from_jax_tree(
            load_checkpoint(args.model)[0]["gen"]))
        vibe.load_state_dict(state_dict_from_jax_tree(
            load_checkpoint(vibe_npz)[0]["gen"]))
        backbone = ResNet50(device=device)
        backbone.load_state_dict(state_dict_from_jax_tree(
            load_checkpoint(spin_npz)[0]["backbone"]))
    return DemoModels(smpl=smpl, faces=faces, gen=gen.eval(),
                      vibe=vibe.eval(), backbone=backbone.eval())


def track(frames: List[np.ndarray], args) -> Dict[int, Dict]:
    """Tracklets of the decoded frames, of at least MIN_NUM_FRAMES frames:
    from --detections, OpenPose JSONs (--tracking_method pose
    --staf_dir), the built-in detectors, or one full-frame tracklet."""
    from tepose_tpu_torch.streaming import tracker as TRK

    num_frames = len(frames)
    if args.detections:
        tracklets = TRK.load_detections_npz(args.detections, num_frames)
    elif args.tracking_method == "pose" and args.staf_dir:
        from glob import glob

        if glob(osp.join(args.staf_dir, "*.json")):
            tracklets = TRK.load_pose_tracklets(args.staf_dir)
        else:  # a STAF install dir: run the binary (pose_tracker.py:25-48)
            json_dir = osp.join(args.output_folder, "staf_json")
            tracklets = TRK.run_staf(args.vid_file, json_dir, args.staf_dir)
    elif args.detector in ("auto", "motion", "stabilized"):
        det = {"auto": TRK.detect_people_auto,
               "motion": TRK.detect_people_motion,
               "stabilized": TRK.detect_people_stabilized}[args.detector]
        tracklets = det(frames)
        print(f"{args.detector} detector found {len(tracklets)} tracklet(s)")
        if not tracklets:
            print("Nothing detected; falling back to a full-frame tracklet")
            tracklets = TRK.detect_people_simple(frames[0].shape, num_frames)
    else:
        print("Detector disabled; using a full-frame tracklet "
              "(pass --detections or --detector auto for multi-person)")
        tracklets = TRK.detect_people_simple(frames[0].shape, num_frames)
    tracklets = {k: v for k, v in tracklets.items()
                 if len(v["frames"]) >= MIN_NUM_FRAMES}
    print(f"Tracking yielded {len(tracklets)} tracklet(s)")
    return tracklets


def tracklet_crops(frames: List[np.ndarray], tracklet: Dict):
    """Square boxes (T, 4) of a tracklet and its raw uint8 crops
    (T, 3, 224, 224); the engine normalises on the device."""
    from tepose_tpu_torch.native import crop_normalize

    bboxes = tracklet["bbox"]
    side = np.maximum(bboxes[:, 2], bboxes[:, 3])
    sq = np.stack([bboxes[:, 0], bboxes[:, 1], side, side], axis=1)
    crops = np.stack([
        crop_normalize(frames[int(f)], sq[i:i + 1], normalize=False)[0]
        for i, f in enumerate(tracklet["frames"])])
    return sq, crops


class _Stages:
    """Per-stage wall time (ending in a device synchronise) and LBS
    skinning launches of one `run_offline` call."""

    def __init__(self, timer, device: torch.device):
        from collections import defaultdict

        self.timer, self.device = timer, device
        self.launches: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, name: str):
        from tepose_tpu_torch.ops import lbs_skinning

        before = lbs_skinning.LAUNCHES
        with self.timer.stage(name):
            yield
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        self.launches[name] += lbs_skinning.LAUNCHES - before


def _refine(models: DemoModels, pred_theta: np.ndarray, tr: Dict,
            sq: np.ndarray) -> Dict[str, np.ndarray]:
    """Temporal SMPLify of one tracklet against its tracked 2D keypoints
    (the JAX demo's working replacement for the reference's broken
    smplify_runner, demo_utils.py:89-165)."""
    from tepose_tpu_torch.data.kp_utils import convert_kps
    from tepose_tpu_torch.data.transforms import (
        normalize_2d_kp, transform_keypoints)
    from tepose_tpu_torch.models.smplify import smplify_refine
    from tepose_tpu_torch.ops.geometry import batch_rodrigues

    dev = models.smpl.v_template.device
    kp = convert_kps(tr["joints2d"], "staf", "spin")
    kp[..., :2] = normalize_2d_kp(transform_keypoints(kp[..., :2], sq))
    theta = torch.from_numpy(np.ascontiguousarray(pred_theta,
                                                  np.float32)).to(dev)
    with torch.no_grad():
        rotmat = batch_rodrigues(theta[:, 3:75].reshape(-1, 3)).reshape(
            -1, 24, 3, 3)
    refined = smplify_refine(models.smpl, rotmat, theta[:, 75:],
                             theta[:, :3], torch.from_numpy(kp).to(dev))
    return {k: v.cpu().numpy() for k, v in refined.items()}


def _smooth(models: DemoModels, pred_theta: np.ndarray, min_cutoff: float,
            beta: float):
    """1-euro-smoothed theta (host) and its mesh rebuilt on the device."""
    from tepose_tpu_torch.models.smpl import smpl_forward
    from tepose_tpu_torch.ops.filters import smooth_pose_params
    from tepose_tpu_torch.ops.geometry import batch_rodrigues

    dev = models.smpl.v_template.device
    pose_s, betas_s = smooth_pose_params(
        pred_theta[:, 3:75].astype(np.float64),
        pred_theta[:, 75:].astype(np.float64), min_cutoff, beta)
    with torch.no_grad():
        rot = batch_rodrigues(torch.as_tensor(
            pose_s.reshape(-1, 3), dtype=torch.float32,
            device=dev)).reshape(-1, 24, 3, 3)
        verts = smpl_forward(models.smpl, torch.as_tensor(
            betas_s, dtype=torch.float32, device=dev), rot)["verts"]
    theta = pred_theta.copy()
    theta[:, 3:75] = pose_s
    theta[:, 75:] = betas_s
    return theta, verts.cpu().numpy()


def run_offline(frames: List[np.ndarray], tracklets: Dict[int, Dict],
                models: DemoModels, args, timer=None,
                on_frame: Optional[Callable[[np.ndarray], None]] = None
                ) -> Dict:
    """Every step of the offline demo after decode and tracking.

    frames: decoded RGB uint8 frames; tracklets as `track` returns them.
    Runs the engine over all tracklets, then per tracklet --run_smplify
    (when it has 2D keypoints) and --smooth, and renders every frame
    (with --sideview, --wireframe and --render_plain) unless --serving
    serving-joints, calling `on_frame` on each rendered frame. Returns
    {"results": per-person dicts as the JAX demo saves them, "frames":
    rendered frames (None under serving-joints), "engine_outputs": the
    engine's outputs in tracklet order, "launches": LBS skinning launches
    per stage, "timer": the StageTimer}; stages are engine, smplify,
    smooth and render, each timed to a device synchronise.
    """
    from tepose_tpu_torch.streaming import demo_utils as D
    from tepose_tpu_torch.streaming.engine import StreamingEngine
    from tepose_tpu_torch.utils.profiling import StageTimer

    timer = timer if timer is not None else StageTimer()
    stage = _Stages(timer, models.smpl.v_template.device)
    orig_h, orig_w = frames[0].shape[:2]
    engine = StreamingEngine(
        models.smpl, models.gen, models.vibe, models.backbone,
        backbone_dtype=torch.bfloat16 if args.precision == "bf16" else None,
        preset=args.serving)

    stream_t0 = time.time()
    pids = list(tracklets.keys())
    squares, crops_list = {}, []
    # short videos ride the fused crops->verts path; long ones would hold
    # every raw crop in RAM, so they reduce to features per tracklet
    fused = sum(len(tracklets[p]["frames"])
                for p in pids) <= engine.max_frames_per_call
    with stage("engine"):
        for pid in pids:
            squares[pid], crops = tracklet_crops(frames, tracklets[pid])
            crops_list.append(crops if fused else
                              engine.extract_features_multi([crops])[0])
        outs = (engine.run_tracklets_from_crops(crops_list) if fused
                else engine.run_tracklets(crops_list))
    del crops_list
    total_pred_frames = sum(len(tracklets[p]["frames"]) for p in pids)

    results = {}
    for pid, out in zip(pids, outs):
        tr, sq = tracklets[pid], squares[pid]
        pred_theta = out["theta"]
        pred_verts = out.get("verts")  # absent under serving-joints
        kp_3d, kp_2d = out["kp_3d"], out.get("kp_2d")
        if args.run_smplify and "joints2d" in tr:
            with stage("smplify"):
                refined = _refine(models, pred_theta, tr, sq)
            pred_theta, pred_verts = refined["theta"], refined["verts"]
            kp_3d, kp_2d = refined["kp_3d"], refined["kp_2d"]
        elif args.run_smplify:
            print("--run_smplify needs 2D keypoints: use "
                  "--tracking_method pose --staf_dir <openpose jsons>")
        if args.smooth:
            with stage("smooth"):
                pred_theta, pred_verts = _smooth(
                    models, pred_theta, args.smooth_min_cutoff,
                    args.smooth_beta)

        cam = pred_theta[:, :3]
        bbox_ch = np.stack([sq[:, 0], sq[:, 1], sq[:, 2] * 1.2], axis=1)
        results[pid] = {
            "pred_cam": cam,
            "orig_cam": D.convert_crop_cam_to_orig_img(cam, bbox_ch, orig_w,
                                                       orig_h),
            "verts": pred_verts,
            "pose": pred_theta[:, 3:75],
            "betas": pred_theta[:, 75:],
            "joints3d": kp_3d,
            "kp_2d": kp_2d,
            "bboxes": bbox_ch,
            "frame_ids": tr["frames"],
        }
    stream_time = time.time() - stream_t0
    stages = ", ".join(f"{k} {v:.1f}s"
                       for k, v in sorted(engine.timings.items()))
    print(f"TePose FPS: {total_pred_frames / max(stream_time, 1e-9):.2f} "
          f"({stages})")
    for k, v in engine.timers.summary().items():
        timer.totals[k] += v["total_s"]
        timer.counts[k] += v["count"]
    res = {"results": results, "frames": None, "engine_outputs": outs,
           "launches": stage.launches, "timer": timer}
    if args.serving == "serving-joints":
        print("serving-joints: skipped rendering (no verts in outputs)")
        return res

    with stage("render"):
        res["frames"] = render_frames(frames, results, models.faces, args,
                                      on_frame)
    return res


def render_frames(frames: List[np.ndarray], results: Dict,
                  faces: np.ndarray, args,
                  on_frame: Optional[Callable[[np.ndarray], None]] = None
                  ) -> List[np.ndarray]:
    """Every frame with each person's mesh drawn at its `orig_cam`, nearest
    person last (--wireframe: edges only; --render_plain: on black; with
    --sideview the side view is joined on the right)."""
    from tepose_tpu_torch.native import render_mesh
    from tepose_tpu_torch.streaming import demo_utils as D

    frame_results = D.prepare_rendering_results(results, len(frames))
    rot90 = np.array([[0, 0, -1], [0, 1, 0], [1, 0, 0]], np.float32)
    out_frames = []
    for f_idx, frame in enumerate(frames):
        img = np.zeros_like(frame) if args.render_plain else frame.copy()
        # side view: one canvas per frame with every person, joined once
        # after the person loop (ref: demo.py:409-420)
        side_img = np.zeros_like(img) if args.sideview else None
        for pd in frame_results[f_idx].values():
            if args.wireframe:
                from tepose_tpu_torch.utils.vis import draw_wireframe

                img = draw_wireframe(img, pd["verts"], pd["cam"], faces)
            else:
                img = render_mesh(pd["verts"], faces, pd["cam"], img)
            if args.sideview:
                side_img = render_mesh(pd["verts"] @ rot90.T, faces,
                                       pd["cam"], side_img)
        if args.sideview:
            img = np.concatenate([img, side_img], axis=1)
        out_frames.append(img)
        if on_frame is not None:
            on_frame(img)
    return out_frames


def _display_callback(title: str):
    """A cv2 window showing each frame, or None when the environment has no
    display. 'q' closes it; the callback then returns True."""
    import cv2

    try:
        cv2.namedWindow(title, cv2.WINDOW_NORMAL)
    except cv2.error as e:
        print(f"--display unavailable (headless environment?): {e}")
        return None
    state = {"on": True}

    def show(img) -> bool:
        if state["on"]:
            cv2.imshow(title, cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
            if cv2.waitKey(1) & 0xFF == ord("q"):
                state["on"] = False
                cv2.destroyAllWindows()
                return True
        return False

    return show


def run_live(args, crop_size: int = 224):
    """Causal frame-at-a-time demo: detect -> crop -> LiveSession.push ->
    render, each step the moment its frame arrives (`--vid_file cam:<N>`
    reads a webcam; `--live_streams N` follows up to N people in stable
    slots, a slot's stream reset when a new person takes it). Prints the
    per-frame latency percentiles at the end."""
    import collections

    from tepose_tpu_torch.native import crop_normalize, render_mesh
    from tepose_tpu_torch.streaming import demo_utils as D
    from tepose_tpu_torch.streaming.live import LiveSession
    from tepose_tpu_torch.streaming.tracker import (
        CausalPeopleTracker, CausalPersonTracker)

    os.makedirs(args.output_folder, exist_ok=True)
    if args.synthetic and not args.vid_file:
        args.vid_file = osp.join(args.output_folder, "synthetic_input.mp4")
        make_synthetic_video(args.vid_file)

    cap = None
    if args.vid_file.startswith("cam:"):
        import cv2

        cap = cv2.VideoCapture(int(args.vid_file.split(":", 1)[1]))
        if not cap.isOpened():
            sys.exit(f"cannot open webcam {args.vid_file!r}")
        fps_in = cap.get(cv2.CAP_PROP_FPS) or 30.0

        def frames_iter():
            while True:
                ok, bgr = cap.read()
                if not ok:
                    return
                yield cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
    else:
        if not osp.isfile(args.vid_file):
            sys.exit(f"input video {args.vid_file!r} does not exist!")
        fps_in = D.video_fps(args.vid_file)

        def frames_iter():
            return D.read_video_frames(args.vid_file)

    models = build_demo_models(args)
    K = max(1, int(args.live_streams))
    session = LiveSession(
        models.smpl, models.gen, models.vibe, n_streams=K,
        backbone=models.backbone,
        outputs=(("theta", "kp_3d") if args.serving == "serving-joints"
                 else ("theta", "verts", "kp_3d")),
        backbone_dtype=torch.bfloat16 if args.precision == "bf16" else None,
        preset=args.serving)
    if K > 1:
        tracker = CausalPeopleTracker(slots=K, bootstrap=args.live_bootstrap)
        track_step, track_flush = tracker.update, tracker.flush
    else:
        tracker = CausalPersonTracker(bootstrap=args.live_bootstrap)

        def _as_slots(b):  # (k,4) -> ((k,1,4), present, fresh)
            k = len(b)
            return (b.reshape(k, 1, 4), np.ones((k, 1), bool),
                    np.zeros((k, 1), bool))

        track_step = lambda frame: _as_slots(tracker.update(frame))
        track_flush = lambda: _as_slots(tracker.flush())

    show = _display_callback("TePose live") if args.display else None

    base = osp.splitext(osp.basename(args.vid_file.replace("cam:", "cam")))[0]
    out_path = osp.join(args.output_folder, f"tepose_{base}_live_result.mp4")

    pending = collections.deque()
    lat_ms = []
    # result rows are kept only when they will be saved: a webcam session
    # must not grow its memory with stream length
    rows = ({s: {k: [] for k in ("theta", "verts", "joints3d", "orig_cam",
                                 "bboxes", "valid", "present")}
             for s in range(K)}
            if args.save_pkl else None)
    writer_box = {"w": None}
    stop = {"flag": False}

    def process(img, boxes_s, present_s, fresh_s):
        crops = crop_normalize(img, boxes_s, out_size=crop_size,
                               normalize=False)              # (K, 3, S, S)
        t0 = time.perf_counter()
        out = session.push(crops, reset=fresh_s if fresh_s.any() else None)
        lat_ms.append((time.perf_counter() - t0) * 1e3)
        bbox_ch = np.stack([boxes_s[:, 0], boxes_s[:, 1],
                            boxes_s[:, 2] * 1.2], axis=1)    # (K, 3)
        orig_cam = D.convert_crop_cam_to_orig_img(
            out["theta"][:, :3], bbox_ch, img.shape[1], img.shape[0])
        rendered = img.copy()
        for s in range(K):
            if rows is not None:
                r = rows[s]
                r["theta"].append(out["theta"][s])
                if "verts" in out:  # absent under --serving serving-joints
                    r["verts"].append(out["verts"][s])
                r["joints3d"].append(out["kp_3d"][s])
                r["orig_cam"].append(orig_cam[s])
                r["bboxes"].append(bbox_ch[s])
                r["valid"].append(bool(out["valid"][s]))
                r["present"].append(bool(present_s[s]))
            if present_s[s] and "verts" in out:
                rendered = render_mesh(out["verts"][s], models.faces,
                                       orig_cam[s], rendered)
        if writer_box["w"] is None:
            writer_box["w"] = D.StreamingVideoWriter(
                out_path, rendered.shape[1], rendered.shape[0], fps_in)
        writer_box["w"].write(rendered)
        if show is not None and show(rendered):
            stop["flag"] = True  # q ends the session, not just the view

    n_in = 0
    wall0 = time.time()
    try:
        # Ctrl-C on an endless webcam stream is the normal way out: finalize
        # (video close, pkl, latency report) instead of discarding the run
        try:
            for frame in frames_iter():
                if stop["flag"] or (args.live_max_frames
                                    and n_in >= args.live_max_frames):
                    break
                n_in += 1
                pending.append(frame)
                bs, ps, fs = track_step(frame)
                for i in range(len(bs)):
                    process(pending.popleft(), bs[i], ps[i], fs[i])
            if not stop["flag"]:
                bs, ps, fs = track_flush()  # stream shorter than bootstrap
                for i in range(len(bs)):
                    process(pending.popleft(), bs[i], ps[i], fs[i])
        except KeyboardInterrupt:
            print("\ninterrupted — finalizing live session")
    finally:
        if cap is not None:
            cap.release()
        if writer_box["w"] is not None:
            writer_box["w"].close()
    wall = time.time() - wall0
    n_out = writer_box["w"].n if writer_box["w"] is not None else 0
    if not n_out:
        sys.exit("live mode produced no frames (empty input?)")

    if rows is not None:
        import joblib

        pkl_path = osp.join(args.output_folder,
                            f"tepose_{base}_live_output.pkl")
        joblib.dump({s: {k: np.asarray(v) for k, v in r.items()}
                     for s, r in rows.items()}, pkl_path)
        print(f"Saved results to {pkl_path}")

    lat = np.asarray(lat_ms[1:] or lat_ms)  # drop the first, warm-up step
    print(f"Live frames: {n_out} (bootstrap delay "
          f"{min(args.live_bootstrap, n_in)} frames)")
    print(f"Per-frame latency ms: p50 {np.percentile(lat, 50):.1f} "
          f"p95 {np.percentile(lat, 95):.1f} (first step excluded)")
    print(f"Aggregate FPS incl. decode/detect/render: "
          f"{n_out / max(wall, 1e-9):.2f}")
    print(f"Saved result video to {osp.abspath(out_path)}")
    return {"frames": n_out, "lat_ms_p50": float(np.percentile(lat, 50)),
            "out_path": out_path}


def main(argv=None):
    args = parse_args(argv)
    if args.profile:
        raise SystemExit("--profile is not ported to tepose_tpu_torch yet; "
                         "a device trace goes with the port's profiling")
    if args.serving == "serving-joints":
        # joints-only serving computes no meshes at all
        blocked = [f for f in ("save_obj", "wireframe", "sideview",
                               "display") if getattr(args, f)]
        if blocked:
            sys.exit("--serving serving-joints ships joints only (no "
                     "meshes); drop " + ", ".join("--" + f for f in blocked))
        if not args.save_pkl and not args.live:
            sys.exit("--serving serving-joints skips rendering — pass "
                     "--save_pkl so the run produces an output")
    if args.live:
        return run_live(args)

    from tepose_tpu_torch.streaming import demo_utils as D
    from tepose_tpu_torch.utils.profiling import StageTimer

    total_time_start = time.time()
    timer = StageTimer()
    if args.synthetic and not args.vid_file:
        os.makedirs(args.output_folder, exist_ok=True)
        args.vid_file = osp.join(args.output_folder, "synthetic_input.mp4")
        make_synthetic_video(args.vid_file)
    if args.vid_file.startswith(("https://", "http://")):
        print(f"Downloading YouTube video {args.vid_file!r}")
        args.vid_file = D.download_youtube_clip(args.vid_file,
                                                args.output_folder)
        print(f"YouTube video has been downloaded to {args.vid_file}")
    if not osp.isfile(args.vid_file):
        sys.exit(f"input video {args.vid_file!r} does not exist!")

    with timer.stage("decode"):
        frames = list(D.read_video_frames(args.vid_file))
    num_frames = len(frames)
    fps_in = D.video_fps(args.vid_file)
    print(f"Input video {args.vid_file}: {num_frames} frames "
          f"{frames[0].shape[1]}x{frames[0].shape[0]} @ {fps_in:.1f} fps")
    with timer.stage("track"):
        tracklets = track(frames, args)
    models = build_demo_models(args)
    show = _display_callback("TePose") if args.display else None
    out = run_offline(frames, tracklets, models, args, timer=timer,
                      on_frame=show)
    results = out["results"]

    os.makedirs(args.output_folder, exist_ok=True)
    base = osp.splitext(osp.basename(args.vid_file))[0]
    if args.save_pkl:
        import joblib

        pkl_path = osp.join(args.output_folder, f"tepose_{base}_output.pkl")
        joblib.dump(results, pkl_path)
        print(f"Saved results to {pkl_path}")

    if out["frames"] is not None:
        if args.save_obj:
            obj_dir = osp.join(args.output_folder, f"{base}_obj")
            os.makedirs(obj_dir, exist_ok=True)
            for pid, pd in results.items():
                # every frame, as the reference does (ref: demo.py:395-398)
                for i, f_idx in enumerate(pd["frame_ids"]):
                    path = osp.join(obj_dir, f"p{pid}_f{int(f_idx):06d}.obj")
                    with open(path, "w") as f:
                        for v in pd["verts"][i]:
                            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
                        for tri in models.faces + 1:
                            f.write(f"f {tri[0]} {tri[1]} {tri[2]}\n")
        if show is not None:
            import cv2

            cv2.destroyAllWindows()
        out_path = osp.join(args.output_folder, f"tepose_{base}_result.mp4")
        with timer.stage("write_video"):
            D.write_video(out["frames"], out_path, fps_in)
        print(f"Saved result video to {osp.abspath(out_path)}")
    total = time.time() - total_time_start
    print(f"Total FPS (including model loading): {num_frames / total:.2f}")
    print(f"Stage timing: {timer.report()}")
    return out


if __name__ == "__main__":
    main()
