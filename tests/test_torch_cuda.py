"""The Hopper kernels against their plain PyTorch versions on a CUDA card.

Marked ``gpu``; every test skips (inside the ``cuda`` fixture, never at
import) when ``torch.cuda.is_available()`` is False.  On the card:

    python -m pytest tests/test_torch_cuda.py -q -m gpu
"""

import numpy as np
import pytest
import torch

from mpf_tpu_torch import MPF_BF16, MPF_FP16, MPF_REF, PURE_FP32, make_mpf, mpf_factorize
from mpf_tpu_torch.ops import _lib
from mpf_tpu_torch.ops.blas3 import _leaves, tri_inv_leaves, tri_inv_leaves_plain
from mpf_tpu_torch.ops.exchange import rows_exchange, rows_exchange_plain
from mpf_tpu_torch.ops.panel_fused import (
    panel_apply_update_trim, panel_apply_update_trim_plain, rowblock_assemble,
    rowblock_assemble_plain, trailing_gemm_sub, trailing_gemm_sub_plain)
from mpf_tpu_torch.ops.panel_pallas import (
    getf2_npv_block, getf2_npv_inv_block, getf2_npv_inv_plain, hgetf2_panel_plain,
    hgetf2_panel_swaps, laswp_apply, laswp_plain)
from mpf_tpu_torch.ops.panel_strip import strip_panel_pivots, strip_panel_pivots_plain
from mpf_tpu_torch.precision import cast_to_panel
from mpf_tpu_torch.utils import matgen
from mpf_tpu_torch.utils.oracle import check_factorization_device

pytestmark = pytest.mark.gpu

_FUSED = ("strip_pivots", "rowblock", "panel_update", "rows_exchange", "tri_inv",
          "trailing_sub")
_MASKED = ("tri_inv", "trailing_sub", "hgetf2", "npv_inv", "laswp")


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
    """The fused main path through its kernels (1-6) only; oracle on the
    device."""
    n = 2048
    a = _hpl(n, 6, cuda)
    _lib.reset_counts()
    res = mpf_factorize(a, r=128, policy=policy)
    assert all(_lib.launches[k] > 0 for k in _FUSED) and not any(_lib.plain_calls.values())
    assert not any(_lib.launches[k] for k in _lib.KERNELS if k not in _FUSED)
    tol = 1e-3 if policy is MPF_BF16 else 1e-5
    assert check_factorization_device(a, res.lu, res.ipiv, nbe_tol=tol).ok
    cpu = mpf_factorize(a.cpu(), r=128, policy=policy)
    assert torch.equal(cpu.ipiv, res.ipiv.cpu()) and torch.equal(cpu.perm, res.perm.cpu())


@pytest.mark.parametrize("pdt", [torch.bfloat16, torch.float32, torch.float16])
@pytest.mark.parametrize("m,r,off", [(96, 16, 5), (1000, 12, 3), (4096, 128, 1000)])
def test_hgetf2_kernel_exact(cuda, pdt, m, r, off):
    """Kernel 7: piv, perm, composed perm and srcs exact against the plain
    version, on the uniform panel (fp16: saturated first, as MPF_FP16)."""
    pan = torch.from_numpy(matgen.random_dense(m, seed=m)[:, :r].copy()).to(cuda)
    if pdt == torch.float16:
        pan = cast_to_panel(pan, MPF_FP16).contiguous()
    prev = torch.randperm(m, generator=torch.Generator().manual_seed(0)).to(torch.int32).to(cuda)
    got = hgetf2_panel_swaps(pan, off, prev, panel_dtype=pdt)
    ref = hgetf2_panel_plain(pan, off, prev, panel_dtype=pdt)
    for x, y in zip(got, ref):
        assert torch.equal(x, y)


@pytest.mark.parametrize("r", [8, 48, 128, 256])
def test_npv_kernels(cuda, r):
    """Kernels 8 and 8b: LU bit-exact, inverses within 1e-5 of their largest
    entry, info exact (including a zero pivot); r = 256 runs the
    global-memory instance."""
    blk = torch.from_numpy((np.random.default_rng(r).random((r, r)) + r * np.eye(r))
                           .astype(np.float32)).to(cuda)
    k, p = getf2_npv_inv_block(blk), getf2_npv_inv_plain(blk)
    assert torch.equal(k[0], p[0]) and int(k[3]) == int(p[3]) == 0
    for x, y in zip(k[1:3], p[1:3]):
        assert float((x - y).abs().max() / y.abs().max()) <= 1e-5
    lu, info = getf2_npv_block(blk)
    assert torch.equal(lu, p[0]) and int(info) == 0
    blk[1] = blk[0]
    assert int(getf2_npv_inv_block(blk)[3]) == int(getf2_npv_block(blk)[1]) == 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_laswp_kernel_exact(cuda, dtype):
    """Kernel 9 on a strided column window, with duplicate cand entries."""
    a = torch.rand((2048, 1000), device=cuda).to(dtype)
    cand = torch.tensor([0, 1, 2, 3, 700, 33, 2, 5], dtype=torch.int32, device=cuda)
    src = torch.tensor([700, 33, 5, 3, 0, 1, 5, 2], dtype=torch.int32, device=cuda)
    x, y = a.clone(), a.clone()
    laswp_apply(x[:, 13:517], cand, src)
    laswp_plain(y[:, 13:517], cand, src)
    assert torch.equal(x, y)


@pytest.mark.parametrize("policy,pivot,r,block,tol", [
    (MPF_FP16, True, 128, 256, 5e-4), (MPF_BF16, True, 48, 200, 1e-3),
    (MPF_REF, True, 12, 96, 1e-5), (PURE_FP32, False, 128, 256, 1e-5)])
def test_masked_factorize_on_card(cuda, policy, pivot, r, block, tol):
    """One masked factorization per policy: kernels 5, 6, 7 (with pivoting),
    8 and 9 (with pivoting) launched, no fused kernel, no plain version;
    device oracle."""
    n = 1024
    a = _hpl(n, 7, cuda) if not pivot else torch.from_numpy(
        matgen.random_dense(n, seed=7)).to(cuda)
    _lib.reset_counts()
    res = mpf_factorize(a, r=r, policy=policy, block=block, pivot=pivot)
    want = _MASKED if pivot else ("tri_inv", "trailing_sub", "npv_inv")
    assert all(_lib.launches[k] > 0 for k in want), _lib.launches
    assert not any(_lib.launches[k] for k in _lib.KERNELS if k not in want)
    assert not any(_lib.plain_calls.values())
    assert check_factorization_device(a, res.lu, res.ipiv, nbe_tol=tol).ok
    assert int(res.info) == 0


def test_numpy_input_lands_on_cuda(cuda):
    """A numpy matrix goes to cuda:0 by default, for both entry points."""
    a = matgen.hpl_ai_matrix(256, seed=8)
    res = mpf_factorize(a, r=32, policy=MPF_FP16)
    assert res.lu.device.type == "cuda" and res.ipiv.device.type == "cuda"
    res2 = make_mpf(256, r=32, policy=MPF_FP16)(a)
    assert res2.lu.device.type == "cuda" and torch.equal(res2.ipiv, res.ipiv)
