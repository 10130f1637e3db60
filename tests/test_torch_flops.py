"""The port's FLOP accounting (`tepose_tpu_torch/utils/flops.py`).

The analytic formulas are copies of `tepose_tpu/utils/flops.py` (equal for
the same arguments) and are held within the band of tests/test_flops.py
(+-6 %) of `torch.utils.flop_counter`'s count for the port's modules on
the CPU; `peak_flops` picks the H100 entry by longest name prefix and is
None on the CPU.
"""

import numpy as np
import pytest
import torch

from tepose_tpu.utils import flops as JF
from tepose_tpu_torch.models.backbone import resnet50_init
from tepose_tpu_torch.models.regressor import Regressor
from tepose_tpu_torch.models.smpl import synthetic_smpl_model
from tepose_tpu_torch.models.temporal import TemporalEncoder
from tepose_tpu_torch.utils import flops as F


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs six workers on this host's
    cores, and these tests' small ops gain nothing from more."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _within(analytic, counted, rel=0.06):
    assert counted * (1 - rel) <= analytic <= counted * (1 + rel), \
        f"analytic {analytic:.4e} vs counted {counted:.4e}"


@pytest.mark.parametrize("name,args", [
    ("conv2d_flops", (56, 56, 64, 256, 1, 1)),
    ("resnet50_flops", ()),
    ("resnet50_flops", (64, 96)),
    ("gru_flops", (7, 96, 64, 2, True)),
    ("gru_flops", (16, 2048, 1024, 2, False)),
    ("encoder_window_flops", (6, 2, 1024)),
    ("encoder_window_flops", (8, 1, 64, 300)),
    ("fast_scan_window_flops", ()),
    ("fast_scan_window_flops", (8, 3, 256)),
    ("regressor_ief_flops", ()),
    ("regressor_ief_flops", (5,)),
    ("smpl_flops", ()),
    ("smpl_flops", (700, 24, 49)),
    ("streaming_flops_per_call", (4, 128)),
    ("streaming_flops_per_call", (2, 32, 8, 1, 256, 700, 96)),
    ("train_iter_flops", (32,)),
    ("train_iter_flops", (8, 6, 2, 64, 1.5e9, 2.5e8)),
    ("model_flops_per_frame", ()),
    ("model_flops_per_frame", (8, 1, 256, 700)),
])
def test_formulas_equal_the_jax_module(name, args):
    assert getattr(F, name)(*args) == getattr(JF, name)(*args)


def test_streaming_flops_rejects_no_windows():
    with pytest.raises(ValueError, match="no windows"):
        F.streaming_flops_per_call(1, 5, seqlen=6)


@pytest.mark.parametrize("hw", [64, 96])
def test_resnet50_flops_vs_counted(hw):
    bb = resnet50_init(torch.Generator().manual_seed(0), "cpu")
    with torch.no_grad():
        counted = F.counted_flops(bb, torch.zeros(1, 3, hw, hw))
    _within(F.resnet50_flops(hw, hw), counted)


def test_gru_flops_vs_counted():
    T, B, IN, H, NL = 7, 1, 96, 64, 2
    gru = torch.nn.GRU(IN, H, NL, bidirectional=True)
    with torch.no_grad():
        counted = F.counted_flops(gru, torch.zeros(T, B, IN))
    _within(F.gru_flops(T, IN, H, NL, True), counted)


def test_cudnn_rnn_formula_is_the_gru_formula():
    """cuDNN's fused RNN has no FlopCounterMode formula; `counted_flops`
    maps `aten._cudnn_rnn` (GRU mode 3, sequence- or batch-first) onto
    `gru_flops` times the batch. Its arguments as the counter passes them:
    shapes for tensors."""
    T, B, IN, H, NL = 6, 5, 2133, 64, 2
    for batch_first, shape in ((False, (T, B, IN)), (True, (B, T, IN))):
        for bidir in (False, True):
            got = F._cudnn_rnn_flops(
                torch.Size(shape), [], 4, None, torch.Size([NL, B, H]), None,
                3, H, 0, NL, batch_first, 0.0, False, bidir, [], None,
                out_shape=None)
            assert got == B * F.gru_flops(T, IN, H, NL, bidir)


def test_encoder_window_flops_vs_counted():
    S, NL, H = 6, 2, 64
    enc = TemporalEncoder(NL, H, generator=torch.Generator().manual_seed(0),
                          device="cpu")
    with torch.no_grad():
        counted = F.counted_flops(enc, torch.zeros(1, S, 2048 + 85))
    _within(F.encoder_window_flops(S, NL, H), counted)


def test_ief_and_smpl_flops_vs_counted():
    """The 3-step IEF head and one full-size SMPL forward (the plain
    einsum skins on the CPU)."""
    smpl = synthetic_smpl_model(0)
    reg = Regressor(generator=torch.Generator().manual_seed(0), device="cpu")
    with torch.no_grad():
        counted = F.counted_flops(reg, torch.zeros(1, 2048), smpl)
    _within(F.regressor_ief_flops() + F.smpl_flops(smpl.num_verts), counted)


def test_peak_flops_table():
    sxm, pcie, nvl = (F.H100_PEAK_FLOPS[k] for k in (
        "NVIDIA H100 80GB HBM3", "NVIDIA H100 PCIe", "NVIDIA H100 NVL"))
    assert F.peak_flops_for("NVIDIA H100 80GB HBM3") == sxm["float32"] == 67e12
    assert F.peak_flops_for("NVIDIA H100 80GB HBM3", "tf32") == sxm["tf32"]
    assert F.peak_flops_for("NVIDIA H100 80GB HBM3",
                            torch.bfloat16) == sxm["bfloat16"]
    assert F.peak_flops_for("NVIDIA H100 80GB HBM3",
                            torch.float16) == sxm["bfloat16"]
    assert F.peak_flops_for("NVIDIA H100 PCIe") == pcie["float32"]
    assert F.peak_flops_for("NVIDIA H100 NVL", torch.bfloat16) == \
        nvl["bfloat16"]
    for kind in ("NVIDIA A100-SXM4-80GB", "cpu", ""):
        assert F.peak_flops_for(kind) is None
    assert F.peak_flops("cpu") is None
    assert F.peak_flops(torch.device("cpu"), torch.bfloat16) is None
    with pytest.raises(ValueError, match="no peak rate"):
        F.peak_flops_for("NVIDIA H100 PCIe", torch.int8)
    # every card's rates rise from the CUDA cores to TF32 to bf16
    for peaks in F.H100_PEAK_FLOPS.values():
        assert peaks["float32"] < peaks["tf32"] < peaks["bfloat16"]


def test_peak_flops_longest_prefix(monkeypatch):
    """With a shorter key that prefixes both (a generic H100 entry), each
    card still takes its own entry: PCIe must not match SXM's."""
    table = dict(F.H100_PEAK_FLOPS)
    table["NVIDIA H100"] = {"float32": 1.0, "tf32": 2.0, "bfloat16": 3.0}
    monkeypatch.setattr(F, "H100_PEAK_FLOPS", table)
    assert F.peak_flops_for("NVIDIA H100 PCIe") == 51e12
    assert F.peak_flops_for("NVIDIA H100 80GB HBM3") == 67e12
    assert F.peak_flops_for("NVIDIA H100 SXM5 94GB") == 1.0


def test_kernel_timing_takes_the_sxm_fp32_peak():
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools"))
    import kernel_timing

    assert kernel_timing.PEAK_FP32_FLOPS == 67e12 == \
        F.H100_PEAK_FLOPS["NVIDIA H100 80GB HBM3"]["float32"]


def test_model_flops_per_frame_composition():
    parts = F.model_flops_per_frame()
    assert parts["total"] == pytest.approx(
        parts["backbone"] + parts["encoder_window"] + parts["ief"]
        + parts["smpl"])
    assert parts["backbone"] > 0.7 * parts["total"]
    assert np.isfinite(parts["total"]) and parts["total"] > 8e9
