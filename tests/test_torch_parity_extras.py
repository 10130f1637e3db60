"""Port parity of the functions tests/test_parity_extras.py holds on the JAX
side: the soft temporal attention scorer, the pinhole projection and VIBE
over image crops (`vibe_demo_forward` against `vibe_demo_apply`).

Same numpy inputs from a seed through the JAX function and the port's, the
JAX params loaded into the port's modules with `strict=True`, fp32 on the
CPU. Bars: 1e-6 for the attention scores, 1e-5 relative for the
projection, rtol/atol 1e-4 where crops go through the random He-init
ResNet-50 (tests/test_torch_serve.py's bar: its features are in the
hundreds).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tepose_tpu.models.backbone import resnet50_init as jax_resnet50_init
from tepose_tpu.models.regressor import (
    perspective_projection as jax_perspective_projection)
from tepose_tpu.models.smpl import synthetic_smpl_model as jax_smpl
from tepose_tpu.models.temporal import (
    temporal_attention_apply, temporal_attention_init)
from tepose_tpu.models.tepose import (
    VibeConfig as JaxVibeConfig, vibe_demo_apply, vibe_init)
from tepose_tpu_torch.models.backbone import ResNet50
from tepose_tpu_torch.models.regressor import perspective_projection
from tepose_tpu_torch.models.smpl import synthetic_smpl_model
from tepose_tpu_torch.models.temporal import TemporalAttention
from tepose_tpu_torch.models.tepose import Vibe, VibeConfig, vibe_demo_forward
from tepose_tpu_torch.weights import state_dict_from_jax_tree

CROPS_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs six workers on this host's
    cores, and these tests' small ops gain nothing from more."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("non_linearity", ["tanh", "relu"])
def test_temporal_attention_matches_jax(non_linearity):
    """tests/test_parity_extras.py's size: attention_size 128, seq_len 6,
    x (3, 6, 128)."""
    params = jax.device_get(temporal_attention_init(
        jax.random.PRNGKey(0), 128, 6))
    x = np.random.RandomState(0).randn(3, 6, 128).astype(np.float32)
    want = np.asarray(temporal_attention_apply(params, jnp.asarray(x),
                                               non_linearity))
    att = TemporalAttention(128, 6, non_linearity,
                            generator=torch.Generator().manual_seed(0),
                            device="cpu")
    att.load_state_dict(state_dict_from_jax_tree(params), strict=True)
    with torch.no_grad():
        got = att(torch.from_numpy(x)).numpy()
    assert got.shape == (3, 6)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.sum(1), 1.0, atol=1e-6)


@pytest.mark.parametrize("focal_length", [5000.0, 1000.0])
def test_perspective_projection_matches_jax(focal_length):
    rs = np.random.RandomState(1)
    points = rs.randn(2, 49, 3).astype(np.float32)
    translation = np.concatenate(
        [rs.randn(2, 2), 10.0 + rs.rand(2, 1) * 40.0], 1).astype(np.float32)
    want = np.asarray(jax_perspective_projection(
        jnp.asarray(points), jnp.asarray(translation), focal_length))
    got = perspective_projection(torch.from_numpy(points),
                                 torch.from_numpy(translation),
                                 focal_length).numpy()
    assert got.shape == (2, 49, 2)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_vibe_demo_forward_matches_jax():
    """tests/test_parity_extras.py's size: 64 vertices, 1 x 4 crops of
    64 x 64, VIBE seqlen 4, one layer, hidden 16, add_linear."""
    jcfg = JaxVibeConfig(seqlen=4, n_layers=1, hidden_size=16,
                         add_linear=True)
    jvibe = jax.device_get(vibe_init(jax.random.PRNGKey(3), jcfg))
    jbb = jax.device_get(jax_resnet50_init(jax.random.PRNGKey(2)))
    images = np.random.RandomState(2).randn(1, 4, 3, 64, 64).astype(
        np.float32)
    want = jax.device_get(vibe_demo_apply(jvibe, jbb, jax_smpl(1, 64),
                                          jnp.asarray(images), jcfg))

    vibe = Vibe(VibeConfig(4, 1, 16), generator=torch.Generator(),
                device="cpu")
    vibe.load_state_dict(state_dict_from_jax_tree(jvibe), strict=True)
    bb = ResNet50(device="cpu")
    bb.load_state_dict(state_dict_from_jax_tree(jbb), strict=True)
    with torch.no_grad():
        got = vibe_demo_forward(vibe.eval(), bb.eval(),
                                synthetic_smpl_model(1, 64),
                                torch.from_numpy(images))
    assert set(got) == set(want)
    assert got["theta"].shape == (1, 4, 85)
    for k, w in want.items():
        g = got[k].numpy()
        assert g.shape == w.shape, k
        np.testing.assert_allclose(g, w, err_msg=k, **CROPS_TOL)
