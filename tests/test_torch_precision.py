"""Port parity: precision policies and panel casts (mpf_tpu_torch.precision
against mpf_tpu.precision), bit for bit."""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

import mpf_tpu.precision as JP  # noqa: E402
import mpf_tpu_torch.precision as TP  # noqa: E402

NAMES = sorted(JP.POLICIES)

# fp16 saturation / flush edges (reference fp16_utils.h:15-23) plus specials
EDGES = np.array([
    0.0, -0.0, 1.0, -1.0, 65504.0, -65504.0, 65519.0, 65520.0, 1e5, -1e5,
    6.103515625e-05, 6.1e-05, -6.1e-05, 6.0e-05, 5.96e-08, 1e-30, -1e-30,
    3.4e38, -3.4e38, 1.1754944e-38, 1e-39, np.inf, -np.inf, np.nan,
], dtype=np.float32)


def _bits(x):
    a = np.asarray(x)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


def _torch_bits(t):
    if t.dtype in (torch.bfloat16, torch.float16):
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("name", NAMES)
def test_policy_fields_match(name):
    pj, pt = JP.POLICIES[name], TP.POLICIES[name]
    for field in ("working", "panel", "gemm_in", "accum", "residual"):
        assert jnp.dtype(getattr(pj, field)).name == str(getattr(pt, field)).removeprefix("torch.")
    assert pj.saturate_panel == pt.saturate_panel
    assert pt.name == name


@pytest.mark.parametrize("name", NAMES)
def test_cast_to_panel_bitexact(name):
    """Random values over many binades plus the edge values: identical
    bits (NaN compared as NaN)."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(4096) * 10.0 ** rng.integers(-12, 12, 4096)).astype(np.float32)
    x = np.concatenate([x, EDGES])
    pj, pt = JP.POLICIES[name], TP.POLICIES[name]
    yj = np.asarray(JP.cast_to_panel(jnp.asarray(x), pj))
    yt = TP.cast_to_panel(torch.from_numpy(x), pt)
    nan_j = np.isnan(yj.astype(np.float32))
    nan_t = torch.isnan(yt.float()).numpy()
    np.testing.assert_array_equal(nan_j, nan_t)
    np.testing.assert_array_equal(_bits(yj)[~nan_j], _torch_bits(yt)[~nan_t])


def test_fp16_saturation_edges():
    """MPF_FP16 clamps to +-65504 and flushes below the smallest normal to
    +0 — the reference's explicit cast."""
    x = torch.tensor([1e5, -1e5, np.inf, 6.0e-05, -6.0e-05, 6.103515625e-05])
    y = TP.cast_to_panel(x, TP.MPF_FP16).float()
    assert y.tolist()[:5] == [65504.0, -65504.0, 65504.0, 0.0, 0.0]
    assert not torch.signbit(y[4])
    assert y[5].item() == pytest.approx(6.103515625e-05)


def test_widen_and_identity_cast():
    x = torch.randn(8, dtype=torch.bfloat16)
    assert TP.cast_to_panel(x, TP.ALL_BF16) is x
    assert TP.widen_from_panel(x, TP.MPF_BF16).dtype == torch.float32
    assert "mpf_bf16" in repr(TP.MPF_BF16)
