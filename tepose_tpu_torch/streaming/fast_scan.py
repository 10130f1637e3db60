"""The theta-feedback window scan on the lane-batched fast encoder.

Port of `tepose_tpu/streaming/fast_scan.py::fast_stream_scan`. It computes
what the plain loop of `TePose` windows computes (tests hold the two equal)
with two savings: the encoder's lanes are batched (`models.fast_encoder`),
and every frame's layer-0 feature projection is made once for the whole
clip, in one large GEMM, and sliced per window, instead of being made again
in each of the S windows that hold the frame.

The JAX `lax.scan` becomes a Python loop over windows (`_feedback_loop`,
the one place where the theta ring advances). On the CPU each window runs
its ops eagerly. On a CUDA device a window's body (the encoder window, the
three IEF steps, SMPL with the LBS kernel, the J14 joints when asked) is a
few hundred small kernels whose launches, one at a time from the host,
would leave the card idle most of the window; there the body is captured
once into a CUDA graph and each window is one replay: copy the window's
inputs into the graph's static buffers, launch the graph, copy out the
outputs. The graphs are cached on the encoder's pack (`TePose.fast_pack`),
so a new pack captures anew, keyed by everything a capture bakes in (see
`_graph_key`). `GRAPH_STATS` counts captures, replays and eager windows.
"""

from __future__ import annotations

import functools
import weakref
from typing import Callable, Dict, Optional, Sequence

import torch

from tepose_tpu_torch.models.fast_encoder import (
    fast_encoder_window, project_frame_features)
from tepose_tpu_torch.models.smpl import SmplModel
from tepose_tpu_torch.models.tepose import TePose
from tepose_tpu_torch.ops import lbs_skinning
from tepose_tpu_torch.utils.profiling import span

# Projecting every frame at once materialises a (B, T, 3, 3H) f32 tensor;
# above this many bytes each window projects its own frames instead. The JAX
# package's value is kept: 6 GiB is 7.5 % of the H100's 80 GB, and the
# serving engine's buckets stay far below it (max_frames_per_call = 4096
# frames make 151 MB at H = 1024), so the switch only turns precompute off
# for a direct caller with more than about 174k frames at full width.
PRECOMPUTE_PROJ_BYTES = 6 << 30

# Windows run as graph replays, graphs captured, and windows run eagerly,
# since the process started: bumped where each happens and nowhere else.
GRAPH_STATS = {"captures": 0, "replays": 0, "eager_windows": 0}


@torch.inference_mode()
def fast_stream_scan(gen: TePose, smpl: SmplModel, feats: torch.Tensor,
                     theta_buf0: torch.Tensor, num_windows: int,
                     j_regressor: Optional[torch.Tensor] = None,
                     outputs: Sequence[str] = ("theta", "kp_3d"),
                     precompute_projections: Optional[bool] = None
                     ) -> Dict[str, torch.Tensor]:
    """Run the theta-feedback stream over `num_windows` windows.

    feats (B, T, 2048); theta_buf0 (B, S-1, 85). Returns the per-window
    outputs named in `outputs`, each stacked to (B, W, ...). The encoder's
    weights come from `gen.fast_pack()`, whatever `gen.cfg.fast_encoder`
    says. `precompute_projections` projects every frame once before the
    loop; None decides by PRECOMPUTE_PROJ_BYTES. On a CUDA device each
    window is a replay of a captured CUDA graph (the module docstring).
    """
    return _fast_scan(gen, smpl, feats, theta_buf0, num_windows, j_regressor,
                      outputs, precompute_projections,
                      graphed=feats.device.type == "cuda")


def _fast_scan(gen, smpl, feats, theta_buf0, num_windows, j_regressor,
               outputs, precompute_projections, graphed: bool):
    """`fast_stream_scan` with its windows graphed or eager as `graphed`
    says; the tests' eager path on a CUDA device."""
    S = gen.cfg.seqlen
    B, T = feats.shape[:2]
    if not 1 <= num_windows <= T - S + 1:
        # slicing past T would silently drop the last windows, where JAX's
        # dynamic_slice would clamp and repeat one: make it loud
        raise ValueError(
            f"num_windows={num_windows} not in [1, T-S+1={T - S + 1}] "
            f"(T={T}, seqlen={S})")
    fast = gen.fast_pack()
    lane_dim = fast["layers"][0]["w_feat"].shape[0]            # 3 * 3H
    if precompute_projections is None:
        precompute_projections = (B * T * lane_dim * feats.element_size()
                                  <= PRECOMPUTE_PROJ_BYTES)
    # per frame: its projections (B, T, 3, 3H), or its features (B, T, 2048)
    # when each window projects its own
    frames = (project_frame_features(fast, feats) if precompute_projections
              else feats)

    def body(x, theta_fb):
        proj = x if precompute_projections else project_frame_features(fast, x)
        return gen.regressor(fast_encoder_window(fast, proj, theta_fb), smpl,
                             j_regressor=j_regressor)

    if graphed:
        key = _graph_key(gen, smpl, feats, j_regressor, outputs,
                         precompute_projections)
        graphs = fast.setdefault("window_graphs", {})
        if key not in graphs:
            # what the graph reads besides its own buffers and the pack,
            # kept alive while it can be replayed: the key's smpl and
            # j_regressor, and the storage of their and the regressor's
            # tensors (a `.to()` swaps a module's storage in place)
            held = (smpl, j_regressor, [t.detach() for t in (
                *gen.regressor.parameters(), *smpl.buffers())])
            graphs[key] = _WindowGraph(body, ("theta", *outputs), held)
        graph = graphs[key]

        def window(k, theta_fb):
            return graph(frames[:, k:k + S], theta_fb)
    else:
        def window(k, theta_fb):
            GRAPH_STATS["eager_windows"] += 1
            return body(frames[:, k:k + S], theta_fb)

    return _feedback_loop(window, theta_buf0, num_windows, outputs)


def _graph_key(gen: TePose, smpl: SmplModel, feats: torch.Tensor,
               j_regressor: Optional[torch.Tensor], outputs: Sequence[str],
               precompute_projections: bool) -> tuple:
    """What a captured window bakes in besides the pack's weights: B and S,
    the projection mode, the outputs it keeps, the device and dtype, the
    float32 precision flags that chose its kernels (a graph captured in
    strict float32 must not serve a TF32 call), and which SMPL model and J14
    regressor it reads. Not T nor the window count: one graph serves every
    length of a batch."""
    return (feats.shape[0], gen.cfg.seqlen, bool(precompute_projections),
            tuple(outputs), feats.device, feats.dtype,
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision(), id(smpl), id(j_regressor))


# The captured windows, by the handle the replay operator takes.
_GRAPHS: "weakref.WeakValueDictionary[int, _WindowGraph]" = (
    weakref.WeakValueDictionary())


@functools.cache
def _replay_op():
    """`tepose::replay_window_graph(x, graph)`, an operator of PyTorch's
    dispatcher that replays the captured window `_GRAPHS[graph]`; defined
    at first use. A profiler credits a kernel to the operator that was on
    the host's stack when it was launched, and a `record_function` span is
    none, so a bare replay's kernels would fall under no host event of the
    trace; as an operator's they fall under the spans around it, as an
    eager window's do."""
    lib = torch.library.Library("tepose", "FRAGMENT")
    lib.define("replay_window_graph(Tensor x, int graph) -> ()")
    lib.impl("replay_window_graph",
             lambda x, graph: _GRAPHS[graph].graph.replay(), "CUDA")
    return lib, torch.ops.tepose.replay_window_graph


class _WindowGraph:
    """One window body captured as a CUDA graph, replayed per window.

    `__call__(x, theta_fb)` copies the window's inputs into the static
    buffers, replays, and returns fresh copies of the outputs in `keep`.
    The first call captures: it runs its window eagerly on the capture's
    side stream, so that what the body makes lazily (the lane-step
    indices, cuBLAS's handle and workspace for that stream, the LBS
    library and its kernel) exists before capture, returns that window's
    outputs, and captures the body. So every window, captured or not,
    runs the skinning kernel once.
    """

    def __init__(self, body: Callable, keep: Sequence[str], held):
        self.body, self.keep, self.held = body, tuple(dict.fromkeys(keep)), held
        self.graph = None

    def _capture(self, x: torch.Tensor, theta_fb: torch.Tensor
                 ) -> Dict[str, torch.Tensor]:
        with span("scan.capture"):
            self.x = x.clone(memory_format=torch.contiguous_format)
            self.theta_fb = theta_fb.clone(
                memory_format=torch.contiguous_format)
            main = torch.cuda.current_stream(x.device)
            stream = torch.cuda.Stream(x.device)
            stream.wait_stream(main)
            with torch.cuda.stream(stream):
                first = self.body(self.x, self.theta_fb)
            first = {k: first[k] for k in self.keep}
            for v in first.values():
                v.record_stream(main)       # read there, made on the side
            launches = lbs_skinning.LAUNCHES
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=stream):
                out = self.body(self.x, self.theta_fb)
            # the capture ran nothing: each replay adds the launches it
            # recorded
            self.lbs_launches = lbs_skinning.LAUNCHES - launches
            lbs_skinning.LAUNCHES = launches
            self.out = {k: out[k] for k in self.keep}
            self.graph, self.body = graph, None
            _GRAPHS[id(self)] = self
            self.replay = _replay_op()[1]
            GRAPH_STATS["captures"] += 1
            GRAPH_STATS["eager_windows"] += 1
        return first

    def __call__(self, x: torch.Tensor, theta_fb: torch.Tensor
                 ) -> Dict[str, torch.Tensor]:
        if self.graph is None:
            return self._capture(x, theta_fb)
        self.x.copy_(x)
        self.theta_fb.copy_(theta_fb)
        self.replay(self.x, id(self))
        lbs_skinning.LAUNCHES += self.lbs_launches
        GRAPH_STATS["replays"] += 1
        return {k: v.clone() for k, v in self.out.items()}


@torch.inference_mode()
def plain_stream_scan(gen: TePose, smpl: SmplModel, feats: torch.Tensor,
                      theta_buf0: torch.Tensor, num_windows: int,
                      j_regressor: Optional[torch.Tensor] = None,
                      outputs: Sequence[str] = ("theta", "kp_3d")
                      ) -> Dict[str, torch.Tensor]:
    """The same stream through the plain `TemporalEncoder` forward, one
    [feat | theta] window at a time: the loop `fast_stream_scan`
    restructures, kept as its reference (tests, `chip_smoke.py` phase 7)."""
    S = gen.cfg.seqlen

    def window(k, theta_fb):
        x = torch.cat([feats[:, k:k + S], theta_fb], dim=-1)
        return gen.regressor(gen.encoder(x), smpl, j_regressor=j_regressor)

    return _feedback_loop(window, theta_buf0, num_windows, outputs)


def _feedback_loop(window, theta_buf0: torch.Tensor, num_windows: int,
                   outputs: Sequence[str]) -> Dict[str, torch.Tensor]:
    """Run `window(k, theta_feedback (B, S, 85))` for k < num_windows,
    feeding each window's theta into the next one's ring; the outputs named
    in `outputs`, stacked to (B, W, ...)."""
    zero_fb = torch.zeros_like(theta_buf0[:, :1])
    theta_buf = theta_buf0
    per_window = {k: [] for k in outputs}
    for k in range(num_windows):
        out = window(k, torch.cat([theta_buf, zero_fb], dim=1))
        theta_buf = torch.cat([theta_buf[:, 1:], out["theta"][:, None]],
                              dim=1)
        for key in outputs:
            per_window[key].append(out[key])
    return {k: torch.stack(v, dim=1) for k, v in per_window.items()}
