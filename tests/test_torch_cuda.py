"""The Hopper kernels against their plain PyTorch versions on a CUDA card.

Marked ``gpu``; every test skips (inside the ``cuda`` fixture, never at
import) when ``torch.cuda.is_available()`` is False.  On the card:

    python -m pytest tests/test_torch_cuda.py -q -m gpu
"""

import numpy as np
import pytest
import torch

from mpf_tpu_torch import MPF_BF16, MPF_REF, PURE_FP32, mpf_factorize
from mpf_tpu_torch.ops import _lib
from mpf_tpu_torch.ops.blas3 import _leaves, tri_inv_leaves, tri_inv_leaves_plain
from mpf_tpu_torch.ops.exchange import rows_exchange, rows_exchange_plain
from mpf_tpu_torch.ops.panel_fused import (
    panel_apply_update_trim, panel_apply_update_trim_plain, rowblock_assemble,
    rowblock_assemble_plain, trailing_gemm_sub, trailing_gemm_sub_plain)
from mpf_tpu_torch.ops.panel_strip import strip_panel_pivots, strip_panel_pivots_plain
from mpf_tpu_torch.utils import matgen
from mpf_tpu_torch.utils.oracle import check_factorization_device

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def _hpl(n, seed, dev):
    return torch.from_numpy(matgen.hpl_ai_matrix(n, seed=seed)).to(dev)


@pytest.mark.parametrize("pdt", [torch.bfloat16, torch.float32])
def test_strip_pivots_kernel_exact(cuda, pdt):
    """Exact piv / pos / glist, panel at jj0 = 128 of a 2048 x 512 slab."""
    slab = _hpl(2048, 1, cuda)[:, :512].contiguous()
    pos = torch.randperm(2048, generator=torch.Generator().manual_seed(0)).to(
        torch.int32).to(cuda)
    got = strip_panel_pivots(slab, 128, pos, pdt, jj0=128, r=64)
    ref = strip_panel_pivots_plain(slab, 128, pos, pdt, jj0=128, r=64)
    for x, y in zip(got, ref):
        assert torch.equal(x, y)


def test_rowblock_kernel(cuda):
    """Within 1e-5 relative (back substitution and U12 sum in another
    order); info exact, including an exactly-zero second pivot."""
    slab = _hpl(1024, 2, cuda)[:, :256].contiguous()
    glist = torch.arange(64, 128, dtype=torch.int32, device=cuda)
    k = rowblock_assemble(slab, glist, 64)
    p = rowblock_assemble_plain(slab, glist, 64)
    for x, y in zip(k[:2], p[:2]):
        assert float((x - y).abs().max() / y.abs().max()) <= 1e-5
    assert int(k[2]) == int(p[2]) == 0
    slab[65, 64:128] = slab[64, 64:128]
    assert int(rowblock_assemble(slab, glist, 64)[2]) == 2


@pytest.mark.parametrize("gemm_bf16", [False, True])
def test_panel_update_kernel(cuda, gemm_bf16):
    rng = np.random.default_rng(3)
    m, bc, r = 1024, 512, 64
    slab = torch.from_numpy(rng.standard_normal((m, bc)).astype(np.float32)).to(cuda)
    pos = torch.from_numpy(rng.permutation(m).astype(np.int32)).to(cuda)
    rb = torch.from_numpy(rng.standard_normal((r, bc)).astype(np.float32)).to(cuda)
    ui = torch.triu(torch.from_numpy(rng.standard_normal((r, r)).astype(np.float32))).to(cuda)
    a, b = slab.clone(), slab.clone()
    panel_apply_update_trim(a, pos, rb, ui, 128, 128, gemm_bf16)
    panel_apply_update_trim_plain(b, pos, rb, ui, 128, 128, gemm_bf16)
    assert float((a - b).abs().max() / b.abs().max()) <= 1e-5
    frozen = pos < 128 + r
    assert torch.equal(a[frozen], slab[frozen])


def test_rows_exchange_kernel(cuda):
    a = _hpl(1024, 3, cuda)
    src = torch.randperm(768, generator=torch.Generator().manual_seed(1))[:128]
    src = (src + 256).to(torch.int32).to(cuda)
    x, y = a.clone(), a.clone()
    assert torch.equal(rows_exchange(x, 256, src, src), rows_exchange_plain(y, 256, src, src))
    assert torch.equal(x, y)


def test_tri_inv_kernel_bitexact(cuda):
    rng = np.random.default_rng(4)
    l = torch.tril(torch.from_numpy(rng.uniform(-0.5, 0.5, (384, 384)).astype(np.float32)),
                   -1).to(cuda)
    leaves = _leaves(384, 128)
    k, p = tri_inv_leaves(l, leaves), tri_inv_leaves_plain(l, leaves)
    for o, s in leaves:
        assert torch.equal(k[o:o + s, o:o + s], p[o:o + s, o:o + s])


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
def test_trailing_kernel(cuda, dt):
    """Ragged edges (M, N, K not tile multiples); rel 1e-6 of max |a|."""
    a = _hpl(1000, 5, cuda)
    l21 = (torch.rand((900, 72), device=cuda) - 0.5).to(dt)
    u12 = (torch.rand((72, 700), device=cuda) - 0.5).to(dt)
    x, y = a.clone(), a.clone()
    trailing_gemm_sub(x, l21, u12, 100, ncols=700)
    trailing_gemm_sub_plain(y, l21, u12, 100, ncols=700)
    assert float((x - y).abs().max() / y.abs().max()) <= 1e-6
    assert torch.equal(x[:100], a[:100]) and torch.equal(x[:, 800:], a[:, 800:])


@pytest.mark.parametrize("policy", [MPF_BF16, MPF_REF, PURE_FP32])
def test_factorize_on_card(cuda, policy):
    """The main path through the kernels only; oracle on the device."""
    n = 2048
    a = _hpl(n, 6, cuda)
    _lib.reset_counts()
    res = mpf_factorize(a, r=128, policy=policy)
    assert all(v > 0 for v in _lib.launches.values()) and not any(_lib.plain_calls.values())
    tol = 1e-3 if policy is MPF_BF16 else 1e-5
    assert check_factorization_device(a, res.lu, res.ipiv, nbe_tol=tol).ok
    cpu = mpf_factorize(a.cpu(), r=128, policy=policy)
    assert torch.equal(cpu.ipiv, res.ipiv.cpu()) and torch.equal(cpu.perm, res.perm.cpu())
