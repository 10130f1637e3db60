"""HMR 2.0 in the port (`models/vit.py`, `models/hmr2.py`) and its route
through `StreamingEngine`, held to the plain reference `tests/plain_hmr2.py`
on seeded random weights at a small size on the CPU: ViT width 64, 2
blocks of 4 heads, a decoder of width 64 with 2 layers of 4 heads of 32,
64 x 64 crops read at columns 8:-8 (the published 32:-32 scaled), 64
SMPL vertices, the decoders' Xavier gain 1 so the image reaches every
output. Also: the published widths on the meta device, the per-frame
route's counts and spans, and both engine routes held bit for bit to the
golden of `tools/make_torch_engine_golden.py`.

No JAX: HMR 2.0 has no counterpart in the JAX package.
"""

import os
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tepose_tpu_torch.models import hmr2 as H
from tepose_tpu_torch.models.backbone import normalize_crop
from tepose_tpu_torch.models.hmr2 import HMR2, HMR2Config
from tepose_tpu_torch.models.smpl import synthetic_smpl_model
from tepose_tpu_torch.models.vit import ViTConfig
from tepose_tpu_torch.parallel.mesh import make_mesh
from tepose_tpu_torch.streaming import engine as E
from tepose_tpu_torch.streaming.engine import StreamingEngine

TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, TESTS)
sys.path.insert(0, os.path.join(os.path.dirname(TESTS), "tools"))
import make_torch_engine_golden as golden  # noqa: E402
import plain_hmr2 as P  # noqa: E402

CFG = golden.hmr2_config()
PLAIN = dict(P.CONFIG, image_size=64, crop_margin=8, embed_dim=64, depth=2,
             num_heads=4, dim=64, head_depth=2, heads=4, dim_head=32,
             mlp_dim=64)
LENGTHS = golden.LENGTHS


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
    model = golden.hmr2_model()
    smpl = synthetic_smpl_model(0, 64)
    rs = np.random.RandomState(5)
    crops = [(rs.rand(n, 3, 64, 64) * 255).astype(np.uint8) for n in LENGTHS]
    plain_smpl = {k: getattr(smpl, k).clone() for k in (
        "v_template", "shapedirs", "posedirs", "j_regressor", "lbs_weights",
        "j_regressor_extra")}
    plain_smpl.update(parents=smpl.parents,
                      vertex_joint_ids=smpl.vertex_joint_ids,
                      joint_map=smpl.joint_map)
    return dict(model=model, smpl=smpl, crops=crops, plain_smpl=plain_smpl,
                w={k: v.clone() for k, v in model.state_dict().items()})


def _close(got, want, rel=1e-5):
    """Within `rel` of the reference's largest magnitude."""
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    assert got.shape == want.shape
    scale = float(want.abs().max())
    gap = float((got - want).abs().max())
    assert gap <= rel * scale, (gap, scale)


def _plain(m, crops, w=None):
    with torch.no_grad():
        return P.hmr2(w or m["w"], m["plain_smpl"], torch.from_numpy(crops),
                      PLAIN)


def _gap(a, b) -> float:
    return float((torch.as_tensor(a) - torch.as_tensor(b)).abs().max())


# ------------------------------------------------------------ the modules


def test_vit_block_matches_plain(m):
    x = torch.randn(3, CFG.vit.num_patches, 64,
                    generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = m["model"].backbone.blocks[1](x)
        want = P.vit_block(m["w"], "backbone.blocks.1.", x, PLAIN)
    _close(got, want)


def test_vit_matches_plain(m):
    x = P.normalize(torch.from_numpy(m["crops"][2]))[..., 8:56]
    with torch.no_grad():
        got = m["model"].backbone(x)
        want = P.vit(m["w"], x, PLAIN)
    assert got.shape == (9, 12, 64)
    _close(got, want)


def test_head_matches_plain(m):
    tokens = torch.randn(4, 12, 64, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        got = m["model"].smpl_head(tokens)
        want = P.head(m["w"], tokens, PLAIN)
    for g, w in zip(got, want):
        _close(g, w)


def test_state_dict_names_are_the_published_ones(m):
    keys = set(m["w"])
    for k in ("backbone.pos_embed", "backbone.patch_embed.proj.weight",
              "backbone.blocks.1.attn.qkv.bias", "backbone.blocks.1.mlp.fc2."
              "weight", "backbone.last_norm.bias",
              "smpl_head.transformer.to_token_embedding.weight",
              "smpl_head.transformer.pos_embedding",
              "smpl_head.transformer.transformer.layers.1.0.fn.to_qkv.weight",
              "smpl_head.transformer.transformer.layers.1.1.fn.to_kv.weight",
              "smpl_head.transformer.transformer.layers.1.1.fn.to_out.0.bias",
              "smpl_head.transformer.transformer.layers.1.2.fn.net.3.weight",
              "smpl_head.decpose.weight", "smpl_head.init_body_pose",
              "smpl_head.init_betas", "smpl_head.init_cam"):
        assert k in keys, k
    assert not any(k.endswith(("to_qkv.bias", "to_kv.bias", "to_q.bias"))
                   for k in keys)
    copy = HMR2(CFG, device="cpu")
    copy.load_state_dict(m["w"], strict=True)


def test_published_initialisation(m):
    """Truncated normal (std 0.02) ViT linears with zero biases, LayerNorm
    (1, 0), the decoders' Xavier gain, the mean parameters; at the
    published widths, one block and one decoder layer deep."""
    cfg = HMR2Config(vit=ViTConfig(depth=1), depth=1)
    w = HMR2(cfg, generator=torch.Generator().manual_seed(3),
             device="cpu").state_dict()
    qkv = w["backbone.blocks.0.attn.qkv.weight"]
    assert abs(float(qkv.std()) - 0.02) < 2e-4
    assert float(qkv.abs().max()) < 0.02 * 7
    assert not w["backbone.blocks.0.attn.qkv.bias"].any()
    assert (w["backbone.blocks.0.norm1.weight"] == 1).all()
    dec = w["smpl_head.decpose.weight"]
    assert float(dec.abs().max()) <= 0.01 * (6 / (1024 + 144)) ** 0.5
    kv = w["smpl_head.transformer.transformer.layers.0.1.fn.to_kv.weight"]
    assert 0.9 / 1280 ** 0.5 < float(kv.abs().max()) <= 1 / 1280 ** 0.5
    pose = w["smpl_head.init_body_pose"].reshape(24, 6)
    assert (pose == torch.tensor([1.0, 0, 0, 0, 1, 0])).all()
    assert torch.equal(w["smpl_head.init_cam"], torch.tensor([[0.9, 0, 0]]))
    again = HMR2(cfg, generator=torch.Generator().manual_seed(3),
                 device="cpu").state_dict()
    assert all(torch.equal(w[k], again[k]) for k in w)


def test_published_widths_on_meta():
    model = HMR2(device="meta")
    cfg = model.cfg
    assert cfg.vit.grid == (16, 12) and cfg.vit.num_patches == 192
    assert cfg.vit.head_dim == 80
    blocks = model.backbone.blocks
    assert len(blocks) == 32
    assert blocks[0].attn.qkv.weight.shape == (3840, 1280)
    assert blocks[0].mlp.fc1.weight.shape == (5120, 1280)
    assert blocks[0].norm1.eps == 1e-6
    n = sum(p.numel() for p in model.backbone.parameters())
    assert n == 630_912_000
    tokens = model.backbone(torch.empty(2, 3, 256, 192, device="meta"))
    assert tokens.shape == (2, 192, 1280)
    layers = model.smpl_head.transformer.transformer.layers
    assert len(layers) == 6
    sa, ca, ff = layers[0]
    assert sa.fn.to_qkv.weight.shape == (1536, 1024)
    assert ca.fn.to_kv.weight.shape == (1024, 1280)
    assert ca.fn.to_q.weight.shape == (512, 1024)
    assert ca.fn.to_out[0].weight.shape == (1024, 512)
    assert ff.fn.net[0].weight.shape == (1024, 1024)
    head = model.smpl_head
    assert head.transformer.to_token_embedding.weight.shape == (1024, 1)
    assert head.decpose.weight.shape == (144, 1024)
    assert head.decshape.weight.shape == (10, 1024)
    assert head.deccam.weight.shape == (3, 1024)
    pose, betas, cam = head(tokens)
    assert (pose.shape, betas.shape, cam.shape) == ((2, 144), (2, 10),
                                                    (2, 3))


def test_rot6d_rows_is_the_published_layout():
    x = torch.randn(7, 6, generator=torch.Generator().manual_seed(4))
    _close(H.rot6d_rows_to_rotmat(x), P.rot6d_rows(x))
    R = H.rot6d_rows_to_rotmat(x)
    _close(R[..., 0], x[:, :3] / x[:, :3].norm(dim=-1, keepdim=True))


# ------------------------------------------------------- the engine route


def _engine(m, **kw):
    kw.setdefault("crop_batch", 4)
    return StreamingEngine(m["smpl"], m["model"], **kw)


def _check_frames(m, outs, crops_list, rel=1e-5):
    for out, crops in zip(outs, crops_list):
        want = _plain(m, crops)
        T = len(crops)
        assert set(out) == set(E.ENGINE_OUTPUTS)
        theta = torch.from_numpy(out["theta"])
        assert out["theta"].shape == (T, 85)
        assert float((P.rodrigues(theta[:, 3:75].reshape(T, 24, 3))
                      - want["rotmat"]).abs().max()) < 1e-5
        _close(theta[:, :3], want["cam"], rel)
        _close(theta[:, 75:], want["betas"], rel)
        for k in ("verts", "kp_3d", "kp_2d"):
            _close(out[k], want[k], rel)


@pytest.mark.parametrize("max_frames", [7, 4096])
def test_engine_per_frame_matches_plain(m, max_frames):
    """Tracklets of 1 to 9 frames; at 7 frames a call the uploads split
    inside tracklets and the super-chunks pipeline."""
    outs = _engine(m, max_frames_per_call=max_frames
                   ).run_tracklets_from_crops(m["crops"])
    assert [len(o["kp_2d"]) for o in outs] == list(LENGTHS)
    _check_frames(m, outs, m["crops"])


def test_engine_per_frame_float_crops_and_mesh(m):
    """Normalised float crops give the uint8 path's outputs, and a mesh of
    two CPU devices gives one device's."""
    mean = np.array(P.IMAGENET_MEAN, np.float32).reshape(1, 3, 1, 1)
    std = np.array(P.IMAGENET_STD, np.float32).reshape(1, 3, 1, 1)
    norm = [((c / np.float32(255.0) - mean) / std).astype(np.float32)
            for c in m["crops"]]
    single = _engine(m).run_tracklets_from_crops(m["crops"])
    floats = _engine(m).run_tracklets_from_crops(norm)
    meshed = _engine(m, max_frames_per_call=6, mesh=make_mesh(
        devices=["cpu", "cpu"])).run_tracklets_from_crops(m["crops"])
    for a, b, c in zip(single, floats, meshed):
        for k in a:
            _close(b[k], a[k], 1e-5)
            _close(c[k], a[k], 1e-5)


def test_engine_per_frame_outputs_and_dtype(m):
    eng = _engine(m, outputs=("theta", "kp_3d"), output_dtype=torch.float16)
    outs = eng.run_tracklets_from_crops(m["crops"][:2])
    assert set(outs[1]) == {"theta", "kp_3d"}
    assert outs[1]["theta"].dtype == np.float32
    assert outs[1]["kp_3d"].dtype == np.float16
    assert eng.run_tracklets_from_crops([]) == []


def test_crop_margins_are_dropped_and_the_slice_matters(m):
    """Pixels outside columns 8:-8 change nothing; the reference reading
    another 48 columns, as a port that dropped the slice for a plain crop
    would, misses the port's outputs."""
    crops = m["crops"][1]
    other = crops.copy()
    other[..., :8] = 255 - other[..., :8]
    other[..., -8:] = 0
    eng = _engine(m)
    (a,), (b,) = (eng.run_tracklets_from_crops([c]) for c in (crops, other))
    for k in a:
        assert np.array_equal(a[k], b[k]), k
    shifted = np.concatenate([crops[..., 8:], crops[..., :8]], axis=-1)
    off = _plain(m, shifted)
    assert _gap(a["kp_3d"], off["kp_3d"]) > 1e-3 * float(
        off["kp_3d"].abs().max())


def test_class_token_position_is_added(m):
    """The reference with `pos_embed[:, :1]` left out misses the port."""
    out = _engine(m).run_tracklets_from_crops([m["crops"][1]])[0]
    w = dict(m["w"])
    pos = w["backbone.pos_embed"].clone()
    pos[:, :1] = 0.0
    w["backbone.pos_embed"] = pos
    off = _plain(m, m["crops"][1], w)
    assert _gap(out["kp_3d"], off["kp_3d"]) > 1e-3 * float(
        off["kp_3d"].abs().max())


def test_counts_real_crops_and_records_spans(m):
    """`HMR2_STATS` counts the crops and chunks run, no padding: 20 crops
    over super-chunks of 12 and 8 at 4 a chunk; the spans nest under the
    engine's, in pipeline order, each chunk staged (packed into the ring
    and its copy launched) before it runs."""
    eng = _engine(m, max_frames_per_call=12)
    before = dict(H.HMR2_STATS)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.run_tracklets_from_crops(m["crops"])
    assert H.HMR2_STATS["crops"] - before["crops"] == sum(LENGTHS)
    assert H.HMR2_STATS["chunks"] - before["chunks"] == 3 + 2
    events = sorted((e for e in prof.events()
                     if e.name.startswith("tepose:")),
                    key=lambda e: e.time_range.start)
    names = [e.name[len("tepose:"):] for e in events]
    chunk = ["engine.pack", "engine.upload", "hmr2.backbone", "hmr2.head"]
    assert names == (["engine.run"] + chunk * 3
                     + ["engine.readback"] + chunk * 2
                     + ["engine.readback", "engine.wait", "engine.unpack",
                        "engine.wait", "engine.unpack"])
    for e in events[1:]:
        p = e.cpu_parent
        while p is not None and not p.name.startswith("tepose:"):
            p = p.cpu_parent
        assert p is not None, e.name
    assert set(eng.timings) == {"frames"}


def test_per_frame_route_never_enters_the_window_scan(m, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the per-frame route entered the window scan")

    monkeypatch.setattr(StreamingEngine, "_boot_and_scan", refuse)
    monkeypatch.setattr(E, "fast_stream_scan", refuse)
    outs = _engine(m).run_tracklets_from_crops(m["crops"][:2])
    assert len(outs) == 2


def test_per_frame_rejections(m):
    eng = _engine(m)
    feats = np.zeros((8, 2048), np.float32)
    for call in (lambda: eng.run_tracklets([feats]),
                 lambda: eng.run_tracklet(feats),
                 lambda: eng.extract_features(m["crops"][0]),
                 lambda: eng.extract_features_multi(m["crops"])):
        with pytest.raises(ValueError, match="per-frame model"):
            call()
    with pytest.raises(ValueError, match=r"\(T >= 1, 3, 64, 64\)"):
        eng.run_tracklets_from_crops([m["crops"][0][:0]])
    with pytest.raises(ValueError, match=r"\(T >= 1, 3, 64, 64\)"):
        eng.run_tracklets_from_crops([m["crops"][0][..., :48]])
    with pytest.raises(ValueError, match="theta_pseu_list"):
        eng.run_tracklets_from_crops(m["crops"][:1], [None])
    with pytest.raises(ValueError, match="backbone=None"):
        StreamingEngine(m["smpl"], m["model"], None,
                        synthetic_smpl_model(0, 64))
    with pytest.raises(ValueError, match="float32 only"):
        _engine(m, preset="serving")


# ------------------------------------------------------ the golden routes


@pytest.fixture(scope="module")
def route_setup():
    return golden.setup()


@pytest.fixture(scope="module")
def route_golden(route_setup):
    with np.load(golden.GOLDEN_PATH) as f:
        want = {k: f[k] for k in f.files}
    return want, golden.outputs(route_setup)


@pytest.mark.parametrize("call", golden.CALLS)
def test_engine_route_is_bit_identical(route_golden, call):
    """Both routes' outputs, bit for bit, as the engine gave them: the
    TePose route's first four calls from before it gained the per-frame
    route, the rest from before its two routes shared one pipeline."""
    want, got = route_golden
    keys = sorted(k for k in want if k.startswith(call + "/"))
    assert keys and keys == sorted(k for k in got if k.startswith(call + "/"))
    for k in keys:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k


def _layout(a: np.ndarray, layout: str) -> np.ndarray:
    """A tracklet's crops as a caller might hold them: its own array
    ("separate"), a view with every other frame of a larger array
    ("strided"), or ImageNet-normalised on the host ("float32")."""
    if layout == "strided":
        big = np.zeros((2 * len(a),) + a.shape[1:], a.dtype)
        big[::2] = a
        return big[::2]
    if layout == "float32":
        return normalize_crop(torch.from_numpy(a)).numpy()
    return a


def _laid_out(s, layout: str):
    """The golden's inputs with every tracklet's crops in `layout`, or, for
    "views", each list of tracklets as views of one flat array."""
    out = dict(s)
    for key in ("crops", "long", "frames"):
        if layout == "views":
            starts = np.cumsum([0] + [len(c) for c in s[key]])
            flat = np.concatenate(s[key])
            out[key] = [flat[a:b] for a, b in zip(starts, starts[1:])]
        else:
            out[key] = [_layout(c, layout) for c in s[key]]
    return out


# (golden call, crops' layout, engine arguments replaced, the frames of
# each replica block staged, in order). The fused and fallback routes give
# the golden's outputs at other chunk sizes too; extract's super-chunks of
# 4 hold at most 4 frames, so one super-chunk of 11 at 4 a chunk stages
# the same chunks, the second straddling the two tracklets
STAGING = [
    ("fused", "views", {}, [8, 20]),
    ("fused", "strided", {}, [8, 20]),
    ("fused", "float32", {}, [8, 20]),
    ("fused", "separate", {"crop_batch": 3}, [8, 20]),
    ("fused", "separate", {"crop_batch": 16}, [8, 20]),
    ("fallback", "views", {"crop_batch": 5}, [8, 40, 4, 20]),
    ("fallback", "float32", {}, [8, 40, 4, 20]),
    ("extract", "views", {}, [4, 4, 3]),
    ("extract", "float32", {}, [4, 4, 3]),
    ("extract", "strided", {"crop_batch": 4, "max_frames_per_call": 11},
     [11]),
    ("fused_mesh", "views", {}, [8, 20]),
    ("extract_mesh", "strided", {}, [2, 2, 2, 2, 1, 2]),
    ("frames", "views", {}, [7, 7, 6]),
    ("frames", "strided", {}, [7, 7, 6]),
    ("frames", "float32", {}, [7, 7, 6]),
    ("frames_mesh", "views", {}, [3, 4, 3, 4, 3, 3]),
]


@pytest.mark.parametrize("call,layout,kw,blocks", STAGING, ids=[
    f"{c}-{lay}" + "".join(f"-{k}{v}" for k, v in kw.items())
    for c, lay, kw, _ in STAGING])
def test_staged_route_is_bit_identical(route_golden, route_setup, call,
                                       layout, kw, blocks):
    """Crops staged chunk by chunk through the ring, whatever their layout
    or dtype, at other chunk sizes, straddling tracklets and over a
    two-replica mesh, give the golden's outputs bit for bit, twice on one
    engine; `STAGING_STATS` counts ceil(frames / crop_batch) chunks a
    replica block, and the second call allocates nothing in the ring."""
    want, _ = route_golden
    run = golden.engine_call(_laid_out(route_setup, layout), call, **kw)
    size = kw.get("crop_batch", 4 if call.startswith("frames") else 8)
    frame = 3 * 64 * 64 * (4 if layout == "float32" else 1)
    for n in range(2):
        before = dict(E.STAGING_STATS)
        outs = run()
        grew = {k: E.STAGING_STATS[k] - before[k] for k in before}
        assert grew["chunks"] == sum(-(-b // size) for b in blocks)
        assert grew["bytes"] == sum(blocks) * frame
        if n:
            assert grew["ring_allocs"] == 0
        got = {f"{call}/{i}/{k}": v for i, out in enumerate(outs)
               for k, v in out.items()}
        assert got.keys() == {k for k in want if k.startswith(call + "/")}
        for k, v in got.items():
            assert v.dtype == want[k].dtype and np.array_equal(v, want[k]), k


@pytest.mark.parametrize("size,layout,dtype", [
    (1, "separate", np.uint8), (3, "views", np.uint8),
    (4, "strided", np.float32), (8, "separate", np.float32),
    (64, "views", np.uint8)])
def test_staged_chunks_are_the_frames_in_order(m, size, layout, dtype):
    """`_staged` yields each frame of its pieces once, in order, in chunks
    of `crop_batch` (the last shorter), copies that later chunks through
    the same ring slots leave as they were, from any layout of the
    tracklets' arrays."""
    rs = np.random.RandomState(size)
    arrays = [(rs.rand(n, 3, 5, 4) * 255).astype(dtype) for n in (6, 1, 9)]
    if layout == "views":
        flat = np.concatenate(arrays)
        arrays = [flat[0:6], flat[6:7], flat[7:16]]
    elif layout == "strided":
        arrays = [_layout(a, "strided") for a in arrays]
    pieces = [(arrays[0], 2, 6), (arrays[1], 0, 1), (arrays[2], 0, 9)]
    eng = _engine(m, crop_batch=size)
    chunks = list(eng._staged(0, pieces))
    want = np.concatenate([a[lo:hi] for a, lo, hi in pieces])
    assert [len(c) for c in chunks] == [
        min(size, len(want) - a) for a in range(0, len(want), size)]
    assert np.array_equal(torch.cat(chunks).numpy(), want)
    assert list(eng._staged(0, [(arrays[0], 3, 3)])) == []


def test_replicas_stage_their_chunks_in_turns(m):
    """On a mesh `_round_robin` stages chunk k of every replica's block
    before chunk k+1 of any, so no device waits for another's whole block,
    and returns each block's results in its own order; a block with no
    frames gives none."""
    from tepose_tpu_torch.parallel.mesh import make_mesh

    rs = np.random.RandomState(5)
    a, b = ((rs.rand(n, 3, 5, 4) * 255).astype(np.uint8) for n in (5, 3))
    eng = _engine(m, crop_batch=2, mesh=make_mesh(devices=["cpu", "cpu"]))
    order = []

    def run(r, x):
        order.append((r, len(x)))
        return r, x.numpy().copy()

    done = eng._round_robin([(0, [(a, 0, 5)]), (1, [(b, 0, 2), (b, 2, 3)]),
                             (1, [])], run)
    assert order == [(0, 2), (1, 2), (0, 2), (1, 1), (0, 1)]
    assert [[r for r, _ in d] for d in done] == [[0, 0, 0], [1, 1], []]
    assert np.array_equal(np.concatenate([x for _, x in done[0]]), a)
    assert np.array_equal(np.concatenate([x for _, x in done[1]]), b)


# ------------------------------------------------------------- the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.requires_cuda
def test_engine_per_frame_on_cuda_matches_cpu(m, cuda):
    """The per-frame route on the card (SDPA's CUDA kernels, cuBLAS in
    strict float32, the skinning kernel) against the same on the CPU."""
    import copy

    from tepose_tpu_torch.ops import lbs_skinning

    eng = StreamingEngine(synthetic_smpl_model(0, 64, device=cuda),
                          copy.deepcopy(m["model"]).to(cuda), crop_batch=4,
                          max_frames_per_call=7)
    launches = lbs_skinning.LAUNCHES
    got = eng.run_tracklets_from_crops(m["crops"])
    assert lbs_skinning.LAUNCHES > launches
    want = _engine(m, max_frames_per_call=7).run_tracklets_from_crops(
        m["crops"])
    for g, w in zip(got, want):
        for k in w:
            _close(g[k], w[k], 1e-5)
