"""Port parity of the lane-batched fast encoder and the fast window scan.

`models/fast_encoder.py` and `streaming/fast_scan.py` against their JAX
counterparts and against the port's plain `TemporalEncoder` / `TePose`
window loop, on the same numpy inputs with the JAX params loaded
`strict=True`. Small widths (hidden 16-48, 1-3 layers, 64 vertices), fp32 on
the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tepose_tpu.models import fast_encoder as JF
from tepose_tpu.models.smpl import synthetic_smpl_model as jax_smpl
from tepose_tpu.models.temporal import temporal_encoder_init
from tepose_tpu.models.tepose import TePoseConfig as JaxTePoseConfig
from tepose_tpu.models.tepose import tepose_init
from tepose_tpu.streaming.fast_scan import fast_stream_scan as jax_scan
from tepose_tpu_torch.models.fast_encoder import (
    fast_encoder_window, pack_fast_encoder, project_frame_features)
from tepose_tpu_torch.models.smpl import synthetic_smpl_model
from tepose_tpu_torch.models.temporal import TemporalEncoder
from tepose_tpu_torch.models.tepose import TePose, TePoseConfig
from tepose_tpu_torch.streaming.fast_scan import (
    fast_stream_scan, plain_stream_scan)
from tepose_tpu_torch.weights import state_dict_from_jax_tree

ATOL = 3e-5          # tests/test_fast_encoder.py's bar for the JAX pair
SCAN_ATOL = 5e-4     # tests/test_fast_scan.py's: theta feedback compounds
jax_scan_jit = jax.jit(jax_scan, static_argnums=(4, 5),
                       static_argnames=("outputs", "precompute_projections"))


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs six workers on this host's
    cores, and these tests' small ops gain nothing from more."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _encoder(n_layers, hidden):
    enc = jax.device_get(temporal_encoder_init(jax.random.PRNGKey(0),
                                               n_layers, hidden))
    port = TemporalEncoder(n_layers, hidden, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    port.load_state_dict(state_dict_from_jax_tree(enc), strict=True)
    return enc, port.eval()


def _window(rng, B, S):
    feats = rng.randn(B, S, 2048).astype(np.float32) * 0.3
    thetas = rng.randn(B, S, 85).astype(np.float32) * 0.3
    thetas[:, -1] = 0.0   # the last frame carries no feedback
    return feats, thetas


def test_pack_matches_jax():
    enc, port = _encoder(2, 16)
    want = JF.pack_fast_encoder(enc, 2)
    got = pack_fast_encoder(port)
    H = 16
    assert got["hidden"] == H
    for li, (g, w) in enumerate(zip(got["layers"], want["layers"])):
        for k in w:
            gk = g[k]
            if k in ("w_feat", "w_theta"):   # flat (9H, F) for one GEMM
                gk = gk.reshape(3, 3 * H, -1)
            np.testing.assert_array_equal(gk.numpy(), np.asarray(w[k]),
                                          err_msg=f"layer {li} {k}")
    for name in ("linear_fwd", "linear_rec"):
        np.testing.assert_array_equal(got[name][0].numpy(),
                                      want[name]["weight"])
        np.testing.assert_array_equal(got[name][1].numpy(), want[name]["bias"])


def test_pack_is_a_snapshot():
    """The pack is a copy made once: loading new weights into the encoder
    does not reach it (the docstring's contract)."""
    _, port = _encoder(1, 16)
    fast = pack_fast_encoder(port)
    before = fast["layers"][0]["w_hh"].clone()
    with torch.no_grad():
        port.gru_fwd.weight_hh_l0.add_(1.0)
    assert torch.equal(fast["layers"][0]["w_hh"], before)


@pytest.mark.parametrize("n_layers", [1, 2, 3])
@pytest.mark.parametrize("train", [False, True])
def test_fast_encoder_matches_jax_and_plain(rng, n_layers, train):
    hidden, S, B = 48, 6, 4
    enc, port = _encoder(n_layers, hidden)
    feats, thetas = _window(rng, B, S)

    jfast = JF.pack_fast_encoder(enc, n_layers)
    want = np.asarray(JF.fast_encoder_window(
        jfast, JF.project_frame_features(jfast, jnp.asarray(feats)),
        jnp.asarray(thetas), train=train))
    fast = pack_fast_encoder(port)
    with torch.inference_mode():
        got = fast_encoder_window(
            fast, project_frame_features(fast, torch.from_numpy(feats)),
            torch.from_numpy(thetas), train=train)
        plain = port(torch.from_numpy(np.concatenate([feats, thetas], -1)),
                     train=train)
    assert got.shape == ((B, 2, 2048) if train else (B, 2048))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=ATOL, rtol=0)


def _tepose(n_layers, hidden, fast_encoder=False, seed=0):
    jcfg = JaxTePoseConfig(seqlen=6, n_layers=n_layers, hidden_size=hidden)
    jgen = jax.device_get(tepose_init(jax.random.PRNGKey(seed), jcfg))
    gen = TePose(TePoseConfig(6, n_layers, hidden, fast_encoder=fast_encoder),
                 generator=torch.Generator().manual_seed(0), device="cpu")
    gen.load_state_dict(state_dict_from_jax_tree(jgen), strict=True)
    return jcfg, jgen, gen.eval()


@pytest.mark.parametrize("n_layers", [1, 2])
def test_tepose_fast_encoder_matches_plain(rng, n_layers):
    """TePose(fast_encoder=True) computes what the plain forward does."""
    _, jgen, plain = _tepose(n_layers, 32)
    _, _, fast = _tepose(n_layers, 32, fast_encoder=True)
    smpl = synthetic_smpl_model(0, 64)
    feats, thetas = _window(rng, 3, 6)
    x = torch.from_numpy(np.concatenate([feats, thetas], -1))
    with torch.inference_mode():
        a, b = plain(x, smpl), fast(x, smpl)
    assert fast._fast is not None and plain._fast is None
    for k in ("theta", "verts", "kp_2d", "kp_3d", "rotmat"):
        np.testing.assert_allclose(b[k].numpy(), a[k].numpy(), atol=ATOL,
                                   rtol=0, err_msg=k)


@pytest.fixture(scope="module")
def scan_setup():
    rng = np.random.RandomState(3)
    jcfg, jgen, gen = _tepose(2, 32)
    B, T = 2, 16
    return dict(
        jcfg=jcfg, jgen=jgen, gen=gen, W=T - jcfg.seqlen + 1,
        smpl=synthetic_smpl_model(0, 64), jsmpl=jax_smpl(0, 64),
        feats=rng.randn(B, T, 2048).astype(np.float32) * 0.1,
        buf0=rng.randn(B, 5, 85).astype(np.float32) * 0.1,
        jreg=rng.rand(17, 64).astype(np.float32))


@pytest.mark.parametrize("precompute", [True, False])
@pytest.mark.parametrize("use_jreg", [False, True])
def test_fast_stream_scan_matches_jax(scan_setup, precompute, use_jreg):
    s = scan_setup
    outputs = ("theta", "kp_3d", "verts")
    jreg = s["jreg"] if use_jreg else None
    want = jax_scan_jit(s["jgen"], s["jsmpl"], jnp.asarray(s["feats"]),
                        jnp.asarray(s["buf0"]), s["jcfg"], s["W"],
                        None if jreg is None else jnp.asarray(jreg),
                        outputs=outputs, precompute_projections=precompute)
    got = fast_stream_scan(
        s["gen"], s["smpl"], torch.from_numpy(s["feats"]),
        torch.from_numpy(s["buf0"]), s["W"],
        j_regressor=None if jreg is None else torch.from_numpy(jreg),
        outputs=outputs, precompute_projections=precompute)
    assert got["kp_3d"].shape == (2, s["W"], 14 if use_jreg else 49, 3)
    for k in outputs:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-5, rtol=0, err_msg=k)


def test_fast_stream_scan_matches_plain_loop(scan_setup):
    s = scan_setup
    args = (s["gen"], s["smpl"], torch.from_numpy(s["feats"]),
            torch.from_numpy(s["buf0"]), s["W"])
    fast = fast_stream_scan(*args, outputs=("theta", "kp_3d"))
    plain = plain_stream_scan(*args, outputs=("theta", "kp_3d"))
    for k in ("theta", "kp_3d"):
        np.testing.assert_allclose(fast[k].numpy(), plain[k].numpy(),
                                   atol=SCAN_ATOL, rtol=0, err_msg=k)


def test_precompute_switch_branches_agree(scan_setup, monkeypatch):
    """Both branches of the projection switch give the same outputs (the
    same GEMM, over the whole clip or per window), and None picks by the
    byte budget."""
    import tepose_tpu_torch.streaming.fast_scan as FS

    s = scan_setup
    args = (s["gen"], s["smpl"], torch.from_numpy(s["feats"]),
            torch.from_numpy(s["buf0"]), s["W"])
    pre = fast_stream_scan(*args, precompute_projections=True)
    rec = fast_stream_scan(*args, precompute_projections=False)
    for k in pre:
        np.testing.assert_allclose(pre[k].numpy(), rec[k].numpy(),
                                   atol=1e-6, rtol=0, err_msg=k)

    calls = []
    real = FS.project_frame_features
    def counted(fast, x):
        calls.append(x.shape[1])
        return real(fast, x)

    monkeypatch.setattr(FS, "project_frame_features", counted)
    fast_stream_scan(*args)                      # 2 x 16 x 288 x 4 B: fits
    assert calls == [16]
    calls.clear()
    monkeypatch.setattr(FS, "PRECOMPUTE_PROJ_BYTES", 1024)
    fast_stream_scan(*args)                      # over budget: per window
    assert calls == [6] * s["W"]


def test_fast_stream_scan_window_guard(scan_setup):
    s = scan_setup
    args = (s["gen"], s["smpl"], torch.from_numpy(s["feats"]),
            torch.from_numpy(s["buf0"]))
    with pytest.raises(ValueError, match="num_windows"):
        fast_stream_scan(*args, s["W"] + 1)
    with pytest.raises(ValueError, match="num_windows"):
        fast_stream_scan(*args, 0)
    out = fast_stream_scan(*args, 3, outputs=("theta",))
    assert out["theta"].shape == (2, 3, 85)


def test_fast_stream_scan_runs_eager_windows_on_the_cpu(scan_setup):
    """On the CPU every window runs its ops eagerly: no graph is captured,
    replayed or cached on the pack."""
    import tepose_tpu_torch.streaming.fast_scan as FS

    s = scan_setup
    before = dict(FS.GRAPH_STATS)
    fast_stream_scan(s["gen"], s["smpl"], torch.from_numpy(s["feats"]),
                     torch.from_numpy(s["buf0"]), s["W"])
    assert FS.GRAPH_STATS == {**before,
                              "eager_windows": before["eager_windows"]
                              + s["W"]}
    assert "window_graphs" not in s["gen"].fast_pack()


class _EagerGraph:
    """Stands in for `_WindowGraph` on the CPU: runs the body it was given
    eagerly and keeps what a graph would keep."""

    def __init__(self, body, keep, held):
        self.body, self.keep = body, keep

    def __call__(self, x, theta_fb):
        out = self.body(x, theta_fb)
        return {k: out[k] for k in self.keep}


# (what changes from the first call, whether the graph key changes with it)
_KEY_CASES = [
    ("T", False), ("num_windows", False), ("B", True), ("outputs", True),
    ("precompute", True), ("j_regressor", True), ("matmul_tf32", True),
    ("cudnn_tf32", True), ("matmul_precision", True)]


@pytest.mark.parametrize("change,recaptures", _KEY_CASES,
                         ids=[c for c, _ in _KEY_CASES])
def test_graph_cache_key(scan_setup, monkeypatch, change, recaptures):
    """The graphed path's cache, run on the CPU with a stand-in for the
    capture: a second call makes a second graph exactly when it changes
    what a capture bakes in (B, the outputs, the projection mode, the J14
    regressor, each float32 precision flag), and reuses the first when only
    T or the window count change. Its outputs are the eager path's."""
    import tepose_tpu_torch.streaming.fast_scan as FS

    monkeypatch.setattr(FS, "_WindowGraph", _EagerGraph)
    s = scan_setup
    gen = _tepose(2, 32)[2]
    feats = torch.from_numpy(s["feats"])
    buf0 = torch.from_numpy(s["buf0"])
    base = dict(feats=feats, buf0=buf0, W=s["W"], jreg=None,
                outputs=("theta", "kp_3d"), pre=True)
    other = dict(base)
    if change == "T":
        other.update(feats=feats[:, :12], W=7)
    elif change == "num_windows":
        other.update(W=3)
    elif change == "B":
        other.update(feats=feats[:1], buf0=buf0[:1])
    elif change == "outputs":
        other.update(outputs=("theta", "kp_3d", "verts"))
    elif change == "precompute":
        other.update(pre=False)
    elif change == "j_regressor":
        other.update(jreg=torch.from_numpy(s["jreg"]))
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())

    def run(a, graphed):
        return FS._fast_scan(gen, s["smpl"], a["feats"], a["buf0"], a["W"],
                             a["jreg"], a["outputs"], a["pre"],
                             graphed=graphed)

    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        run(base, graphed=True)
        if change == "matmul_tf32":
            torch.backends.cuda.matmul.allow_tf32 = True
        elif change == "cudnn_tf32":
            torch.backends.cudnn.allow_tf32 = True
        elif change == "matmul_precision":
            torch.set_float32_matmul_precision("medium")
        got = run(other, graphed=True)
        want = run(other, graphed=False)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flags[0]
        torch.backends.cudnn.allow_tf32 = flags[1]
        torch.set_float32_matmul_precision(flags[2])
    assert len(gen.fast_pack()["window_graphs"]) == (2 if recaptures else 1)
    assert got.keys() == want.keys() == set(other["outputs"])
    for k in want:
        torch.testing.assert_close(got[k], want[k], atol=0, rtol=0)
    gen.drop_fast_pack()
    assert "window_graphs" not in gen.fast_pack()


def test_copies_of_tepose_pack_their_own_weights(scan_setup, monkeypatch):
    """A deep copy or a pickle of a TePose whose pack holds window graphs
    (a mesh replicates the model by deep copy) leaves the pack out, graphs
    and all; the original keeps its own."""
    import copy
    import pickle

    import tepose_tpu_torch.streaming.fast_scan as FS

    monkeypatch.setattr(FS, "_WindowGraph", _EagerGraph)
    s = scan_setup
    gen = _tepose(2, 32)[2]
    FS._fast_scan(gen, s["smpl"], torch.from_numpy(s["feats"]),
                  torch.from_numpy(s["buf0"]), 3, None, ("theta",), True,
                  graphed=True)
    pack = gen.fast_pack()
    assert len(pack["window_graphs"]) == 1
    for other in (copy.deepcopy(gen), pickle.loads(pickle.dumps(gen))):
        assert other._fast is None
        for a, b in zip(other.state_dict().values(),
                        gen.state_dict().values()):
            assert torch.equal(a, b)
    assert gen.fast_pack() is pack
