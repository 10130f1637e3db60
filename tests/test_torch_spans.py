"""The port's profiler spans (`utils.profiling.span`): which `tepose:` spans
the engine's paths and `vibe_demo_forward` record, in what order and
nesting, that a call records none without a profiler, and that the spans
change no output.

The modules are the port's own at tests/test_torch_serve.py's size: TePose
and VIBE 1 x 16, 64 vertices, 64 x 64 crops, fp32 on the CPU.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tepose_tpu_torch.models.backbone import normalize_crop, resnet50_init
from tepose_tpu_torch.models.smpl import synthetic_smpl_model
from tepose_tpu_torch.models.tepose import (
    TePose, TePoseConfig, Vibe, VibeConfig, vibe_demo_forward)
from tepose_tpu_torch.streaming.engine import StreamingEngine
from tepose_tpu_torch.utils import profiling


# k crop chunks staged and run through the backbone, one after another,
# and their features joined
def _chunks(k):
    return ["pack", "upload", "features"] * k + ["features"]


# a bucket of the fused crop path with k chunks (the pseudo-thetas packed
# and uploaded, the chunks, the features' placement), of the features
# path, and a drain
def _fused(k):
    return (["pack", "upload"] + _chunks(k)
            + ["features", "boot", "scan", "readback"])


STAGED = ["pack", "pack", "upload", "boot", "scan", "readback"]
DRAIN = ["wait", "unpack"]


def _at(depth, names):
    return [(depth, f"engine.{n}") for n in names]


# (depth under the outermost span, name) in the order the spans open
EXPECTED = {
    # lengths 8 and 20: buckets of 16 and 32 frames, one and three chunks
    # of 8 crops, the second dispatched before the first is drained
    "fused": [(0, "engine.run")] + _at(1, _fused(1) + _fused(3) + DRAIN
                                       + DRAIN),
    # lengths 8, 44 and 20 at max_frames_per_call 40: the 48-frame bucket
    # drains the pipeline, then takes the two-stage path (features in
    # super-chunks of 40 and 4 frames, five chunks and one, under their own
    # call, then the scan)
    "fallback": ([(0, "engine.run")] + _at(1, _fused(1) + DRAIN)
                 + [(1, "engine.run")]
                 + _at(2, _chunks(5) + ["readback"] + _chunks(1)
                       + ["readback", "unpack"])
                 + _at(1, STAGED + DRAIN + _fused(3) + DRAIN)),
    # features of lengths 14, 14 and 30: buckets of 16 (two rows) and 32
    "features": [(0, "engine.run")] + _at(1, STAGED + STAGED + DRAIN + DRAIN),
}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs six workers on this host's
    cores, and these tests' small ops gain nothing from more."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def m():
    g = torch.Generator().manual_seed(0)
    rs = np.random.RandomState(11)

    def u8(n):
        return (rs.rand(n, 3, 64, 64) * 255).astype(np.uint8)

    return dict(
        smpl=synthetic_smpl_model(0, 64),
        gen=TePose(TePoseConfig(6, 1, 16), generator=g, device="cpu").eval(),
        vibe=Vibe(VibeConfig(6, 1, 16), generator=g, device="cpu").eval(),
        bb=resnet50_init(g, "cpu").eval(),
        crops=[u8(8), u8(20)], long=[u8(8), u8(44), u8(20)],
        feats=[rs.randn(n, 2048).astype(np.float32) * 0.1
               for n in (14, 14, 30)],
        clip=torch.from_numpy(u8(12)))


def _call(m, path):
    """The engine call of `path`, as a function of no arguments."""
    kw = dict(max_frames_per_call=40) if path == "fallback" else {}
    eng = StreamingEngine(m["smpl"], m["gen"], m["vibe"], m["bb"],
                          crop_batch=8, window_bucket=16, **kw)
    if path == "features":
        return lambda: eng.run_tracklets(m["feats"])
    return lambda: eng.run_tracklets_from_crops(
        m["long"] if path == "fallback" else m["crops"])


def _vibe_call(m):
    def call():
        with torch.inference_mode():
            images = normalize_crop(m["clip"]).reshape(1, 12, 3, 64, 64)
            out = vibe_demo_forward(m["vibe"], m["bb"], m["smpl"], images)
        return [{k: v.numpy() for k, v in out.items()}]
    return call


def _spans(fn):
    """fn's result and its `tepose:` spans, (depth, name) in the order they
    opened, depth counting the `tepose:` spans around each."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        result = fn()
    events = sorted((e for e in prof.events()
                     if e.name.startswith("tepose:")),
                    key=lambda e: e.time_range.start)
    out = []
    for e in events:
        depth, p = 0, e.cpu_parent
        while p is not None:
            depth += p.name.startswith("tepose:")
            p = p.cpu_parent
        out.append((depth, e.name[len("tepose:"):]))
    return result, out


def _bit_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert set(x) == set(y)
        for k in x:
            assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]), k


@pytest.mark.parametrize("path", sorted(EXPECTED))
def test_engine_spans(m, path):
    """Each engine path records the spans of its work, nested under one
    `engine.run`, in pipeline order, and returns bit for bit what it
    returns with no profiler."""
    call = _call(m, path)
    plain = call()
    traced, spans = _spans(call)
    assert spans == EXPECTED[path]
    _bit_equal(traced, plain)


def test_vibe_demo_spans(m):
    call = _vibe_call(m)
    plain = call()
    traced, spans = _spans(call)
    assert spans == [(0, "vibe.backbone"), (0, "vibe.temporal")]
    _bit_equal(traced, plain)


def test_no_record_function_without_a_profiler(m, monkeypatch):
    """With no profiler recording, `span` is the shared no-op context and
    no call reaches `record_function`; under a profiler each does."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r})")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert profiling.span("x") is profiling.span("y")
    calls = [_call(m, "fused"), _call(m, "features"), _vibe_call(m)]
    for call in calls:
        call()
    for call in calls:
        with pytest.raises(AssertionError, match="record_function"):
            with profile(activities=[ProfilerActivity.CPU]):
                call()
