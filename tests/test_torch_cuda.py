"""The Hopper kernels against their plain PyTorch versions on a CUDA card.

Marked ``gpu``; every test skips (inside the ``cuda`` fixture, never at
import) when ``torch.cuda.is_available()`` is False.  On the card:

    python -m pytest tests/test_torch_cuda.py -q -m gpu
"""

import numpy as np
import pytest
import torch

import mpf_tpu_torch.models.mpf as mpf_loop
from mpf_tpu_torch import (
    ALL_BF16, MPF_BF16, MPF_FP16, MPF_REF, PURE_FP32, make_mpf, mpf_factorize)
from mpf_tpu_torch.ops import _lib
from mpf_tpu_torch.ops.blas3 import (
    _leaves, matmul_in, tri_inv_leaves, tri_inv_leaves_plain, u12_product,
    u12_product_plain, unit_lower_inv_blocked)
from mpf_tpu_torch.ops.exchange import (
    copy_rows_block, copy_rows_block_plain, flush_overflow, flush_overflow_plain, rows_exchange,
    rows_exchange_plain)
from mpf_tpu_torch.ops.gemmx import gemm_trailing, gemm_trailing_plain
from mpf_tpu_torch.ops.panel_fused import (
    l21_trim, l21_trim_plain, panel_apply_update, panel_apply_update_plain,
    panel_apply_update_trim, panel_apply_update_trim_plain,
    rowblock_assemble, rowblock_assemble_plain, rows_gather, rows_gather_plain,
    rows_scatter_from_band, rows_scatter_from_band_plain, rows_scatter_inplace,
    rows_scatter_inplace_plain, _trailing_launch, trailing_gemm_sub, trailing_gemm_sub_plain,
    trailing_staged, upd_wide, upd_wide_plain)
from mpf_tpu_torch.ops.panel_pallas import (
    getf2_npv_block, getf2_npv_inv_block, getf2_npv_inv_plain, hgetf2_panel_plain,
    hgetf2_panel_swaps, laswp_apply, laswp_plain)
from mpf_tpu_torch.ops.pair3d import (
    band_write_rows, band_write_rows_plain, slab_extract, slab_extract_plain, slab_writeback,
    slab_writeback_plain, u12_transform, u12_transform_plain)
from mpf_tpu_torch.ops.panel_strip import (
    SENT, exchange_polls, strip_panel_pivots, strip_panel_pivots_plain)
from mpf_tpu_torch.precision import cast_to_panel
from mpf_tpu_torch.utils import matgen
from mpf_tpu_torch.utils.oracle import (
    check_factorization_device, sum_slack, tri_inv_slack, within_bf16_ulp, within_ulp)

pytestmark = pytest.mark.gpu

_FUSED = ("strip_pivots", "rowblock", "panel_update", "rows_exchange", "tri_inv",
          "trailing_sub")
_FUSED_BF16 = ("strip_pivots", "rowblock", "l21_trim", "upd_wide", "rows_exchange",
               "tri_inv", "trailing_sub", "u12_product")
_MASKED = ("tri_inv", "trailing_sub", "hgetf2", "npv_inv", "laswp")
BF = torch.bfloat16


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


def _close_to_plain(x, y, a, reg, l21, u12):
    """fp32 C within 1e-6 of max |a|; bf16 C within one bf16 ulp plus the
    fp32 sum-order bound; everything outside ``reg`` untouched."""
    if x.dtype == BF:
        ok = within_bf16_ulp(x[reg], y[reg], sum_slack(a[reg], l21, u12)).ok
    else:
        ok = float((x - y).abs().max() / y.abs().max()) <= 1e-6
    outside = torch.ones(a.shape, dtype=torch.bool, device=a.device)
    outside[reg] = False
    return ok and torch.equal(x[outside], a[outside])


@pytest.mark.parametrize("cdt", [torch.float32, BF])
@pytest.mark.parametrize("m,w,kk", [(300, 700, 1), (300, 700, 48), (300, 700, 72),
                                    (1000, 900, 1000), (200, 300, 72), (9000, 8000, 136)],
                         ids=["k1", "k48", "k72", "k1000", "fewer_tiles_than_sms",
                              "many_tiles"])
def test_trailing_sm90_shapes(cuda, cdt, m, w, kk):
    """Kernel 6's bf16-operand instances (the Hopper TMA + wgmma routine) at
    M, N and K that are no tile multiples, K in {1, 48, 72, 1000}, 4 tiles
    (fewer than the SMs) and 2272 (17 times the SMs), operands that are
    views of wider matrices (no copy): against the plain version."""
    ko = 40
    a = _hpl(ko + max(m, w) + 24, 21, cuda).to(cdt)
    gen = _gen(cuda, 22)
    wide = lambda c: -(-c // 8) * 8 + 64      # 16-byte rows, wider than the operand
    l21 = (torch.rand((m, wide(kk)), generator=gen, device=cuda) - 0.5).to(BF)[:, :kk]
    u12 = (torch.rand((kk, wide(w)), generator=gen, device=cuda) - 0.5).to(BF)[:, :w]
    x, y = a.clone(), a.clone()
    _lib.reset_counts()
    trailing_gemm_sub(x, l21, u12, ko, ncols=w)
    assert _lib.launches["trailing_sub"] == 1 and _lib.copies["gemm_operand"] == 0
    trailing_gemm_sub_plain(y, l21, u12, ko, ncols=w)
    assert _close_to_plain(x, y, a, (slice(ko, ko + m), slice(ko, ko + w)), l21, u12)


@pytest.mark.parametrize("cdt", [torch.float32, BF])
def test_trailing_sm90_unaligned(cuda, cdt):
    """U12 with N = 700 (1400-byte rows) and L21 at an odd column offset are
    copied into padded buffers (two copies counted); C at an odd offset of a
    1001-wide matrix, so its rows alternate in alignment: against the plain
    version."""
    a = _hpl(1001, 23, cuda).to(cdt)
    gen = _gen(cuda, 24)
    l21 = (torch.rand((900, 73), generator=gen, device=cuda) - 0.5).to(BF)[:, 1:]
    u12 = (torch.rand((72, 700), generator=gen, device=cuda) - 0.5).to(BF)
    x, y = a.clone(), a.clone()
    _lib.reset_counts()
    trailing_gemm_sub(x, l21, u12, 101, ncols=700)
    assert _lib.launches["trailing_sub"] == 1 and _lib.copies["gemm_operand"] == 2
    trailing_gemm_sub_plain(y, l21, u12, 101, ncols=700)
    assert _close_to_plain(x, y, a, (slice(101, 1001), slice(101, 801)), l21, u12)


def _k6_operands(cuda, seed, m, w, kk):
    """L21 (m, kk) and U12 (kk, w) bf16 in [-0.5, 0.5), views of buffers
    with 16-byte rows (no copy)."""
    gen = _gen(cuda, seed)
    l21 = (torch.rand((m, -(-kk // 8) * 8), generator=gen, device=cuda) - 0.5).to(BF)[:, :kk]
    u12 = (torch.rand((kk, -(-w // 8) * 8), generator=gen, device=cuda) - 0.5).to(BF)[:, :w]
    return l21, u12


@pytest.mark.parametrize("kk", [64, 1000, 1024])
@pytest.mark.parametrize("n,e,w,m", [(1016, 104, 912, None), (4024, 1024, 3000, None),
                                     (4024, 1024, 3000, 1000), (1016, 104, 900, None),
                                     (4100, 1, 4096, None)],
                         ids=["ragged", "more_tiles_than_sms", "rows_below_c",
                              "width_not_16_bytes", "misaligned"])
def test_trailing_staged_bitwise(cuda, n, e, w, m, kk):
    """Kernel 6's bf16-C instances on C = a[e:e + m, e:e + w] of an n x n
    bf16 matrix (m = n - e, or 1000 with rows of the matrix below C), M
    and N no tile multiples (M = 912, 3000 and 1000: 32, 288 and 32 tiles,
    against 132 SMs), K in {64, 1000, 1024}.  Where C qualifies (a 16-byte
    base, row stride and width) the wrapper takes C through shared memory,
    and that instance and the register epilogue are bitwise equal.  Where it does not (a width of 1800 bytes; a base 2 bytes
    off in a 4100-wide matrix) the wrapper takes the register epilogue and
    the C call refuses the staged one; the misaligned C's entries are
    bitwise those of the same update through shared memory on an aligned
    copy.  Within one bf16 ulp plus the fp32 sum-order bound of the plain
    version; outside C untouched, the columns right of it and the rows
    below it (a TMA store writes whole 16-byte pieces of a row)."""
    a = _hpl(n, 31, cuda).to(BF)
    m = n - e if m is None else m
    l21, u12 = _k6_operands(cuda, 32, m, w, kk)
    reg = (slice(e, e + m), slice(e, e + w))
    x, y = a.clone(), a.clone()
    _lib.reset_counts()
    trailing_gemm_sub(x, l21, u12, e, ncols=w)
    staged = trailing_staged(a[reg])
    assert staged == (w % 8 == 0 and e != 1)
    assert _lib.trailing_instances == {"staged": int(staged), "registers": int(not staged),
                                       "ffma": 0}
    assert _lib.launches["trailing_sub"] == 1 and _lib.copies["gemm_operand"] == 0
    trailing_gemm_sub_plain(y, l21, u12, e, ncols=w)
    assert _close_to_plain(x, y, a, reg, l21, u12)
    if staged:
        for inst in ("registers", "staged"):
            z = a.clone()
            _trailing_launch(z[reg], l21, u12, inst)
            assert torch.equal(z, x), inst
        return
    with pytest.raises(RuntimeError):
        _trailing_launch(a.clone()[reg], l21, u12, "staged")
    if w % 8 == 0:
        # the same C at a 16-byte base, with rows of a multiple of 16 bytes
        c = torch.zeros((m + 8, w + 16), dtype=BF, device=cuda)[8:, 8:8 + w]
        assert trailing_staged(c)
        c.copy_(a[reg])
        _trailing_launch(c, l21, u12, "staged")
        assert torch.equal(c, x[reg])


def test_kernel6_profiler_names_all_bf16(cuda):
    """One ALL_BF16 factorization at n = 4096 under torch.profiler: the
    device events the benchmark charges to kernel 6
    (``benchmark_torch.readers.TRAILING``) are exactly the launches counted
    under ``trailing_sub``, every one through shared memory, and none of
    them is kernel 12's update pass (``trailing_kernel<bf16, true>``), whose
    events are its own launch count."""
    import re

    from benchmark_torch.readers import TRAILING

    n = 4096
    a = _hpl(n, 33, cuda).to(BF)
    fac = make_mpf(n, r=128, block=1024, policy=ALL_BF16)
    fac(a.clone())
    torch.cuda.synchronize()
    _lib.reset_counts()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fac(a.clone())
        torch.cuda.synchronize()
    names = [ev.name for ev in prof.events()
             if ev.device_type == torch.autograd.DeviceType.CUDA]
    k6 = [nm for nm in names if any(re.search(p, nm) for p in TRAILING)]
    k12 = [nm for nm in names if re.search(r"\btrailing_kernel<[^<>]*,\s*true>", nm)]
    launched = _lib.launches["trailing_sub"]
    assert launched == n // 1024 - 1 and len(k6) == launched
    assert _lib.trailing_instances == {"staged": launched, "registers": 0, "ffma": 0}
    assert not any(re.search(r",\s*true>", nm) for nm in k6)
    assert len(k12) == _lib.launches["upd_wide"] > 0


def _within_fp64_update(x, a, reg, l21, u12):
    """fp32 C of kernel 6's FFMA instance against C - A @ B in fp64: within
    one fp32 ulp of the result (the subtract's rounding) plus the bound on
    an fp32 sum of the K products in any order (oracle.sum_slack)."""
    ref = a[reg].double() - l21.double() @ u12.double()
    return within_ulp(x[reg], ref, sum_slack(a[reg], l21, u12), dtype=torch.float32).ok


def _ffma_call(x, l21, u12, ko, w):
    """Kernel 6 with fp32 operands: one launch, no operand copy."""
    _lib.reset_counts()
    trailing_gemm_sub(x, l21, u12, ko, ncols=w)
    return _lib.launches["trailing_sub"] == 1 and _lib.copies["gemm_operand"] == 0


@pytest.mark.parametrize("m,w,kk", [(300, 700, 1), (300, 700, 48), (300, 700, 72),
                                    (1000, 900, 1000), (200, 300, 72), (9000, 8000, 136)],
                         ids=["k1", "k48", "k72", "k1000", "fewer_tiles_than_sms",
                              "many_tiles"])
def test_trailing_ffma_shapes(cuda, m, w, kk):
    """Kernel 6's fp32-operand instance (the FFMA routine) at the shapes of
    test_trailing_sm90_shapes, operands that are views of wider matrices
    (K = 1: a 65-float row stride, the 4-byte-copy instance; else 16-byte
    copies): one launch, no copy, against the plain version and the fp64
    update."""
    ko = 40
    a = _hpl(ko + max(m, w) + 24, 21, cuda)
    gen = _gen(cuda, 22)
    l21 = (torch.rand((m, kk + 64), generator=gen, device=cuda) - 0.5)[:, :kk]
    u12 = (torch.rand((kk, w + 64), generator=gen, device=cuda) - 0.5)[:, :w]
    x, y = a.clone(), a.clone()
    assert _ffma_call(x, l21, u12, ko, w)
    trailing_gemm_sub_plain(y, l21, u12, ko, ncols=w)
    reg = (slice(ko, ko + m), slice(ko, ko + w))
    assert _close_to_plain(x, y, a, reg, l21, u12)
    assert _within_fp64_update(x, a, reg, l21, u12)


@pytest.mark.parametrize("odd_operands", [True, False], ids=["odd_views", "aligned"])
def test_trailing_ffma_unaligned(cuda, odd_operands):
    """Kernel 6's FFMA instance with C at an odd offset of a 1001-wide
    matrix (its rows alternate in alignment), and operands that are views
    at odd column offsets with odd row strides (the 4-byte-copy instance)
    or contiguous (16-byte copies): one launch, no copy, against the plain
    version and the fp64 update."""
    a = _hpl(1001, 23, cuda)
    gen = _gen(cuda, 24)
    if odd_operands:
        l21 = (torch.rand((900, 75), generator=gen, device=cuda) - 0.5)[:, 1:73]
        u12 = (torch.rand((72, 703), generator=gen, device=cuda) - 0.5)[:, 3:]
    else:
        l21 = torch.rand((900, 72), generator=gen, device=cuda) - 0.5
        u12 = torch.rand((72, 700), generator=gen, device=cuda) - 0.5
    x, y = a.clone(), a.clone()
    assert _ffma_call(x, l21, u12, 101, 700)
    trailing_gemm_sub_plain(y, l21, u12, 101, ncols=700)
    reg = (slice(101, 1001), slice(101, 801))
    assert _close_to_plain(x, y, a, reg, l21, u12)
    assert _within_fp64_update(x, a, reg, l21, u12)


def test_trailing_ffma_quadrants_bitwise(cuda):
    """Each entry of the FFMA routine is one fmaf chain in ascending k, so
    the update done as four calls on quadrants split at a row and a column
    that are no tile multiple is bitwise the update done in one call."""
    ko, m, w, kk = 30, 700, 650, 200
    a = _hpl(ko + m + 20, 25, cuda)
    gen = _gen(cuda, 26)
    l21 = torch.rand((m, kk), generator=gen, device=cuda) - 0.5
    u12 = torch.rand((kk, w), generator=gen, device=cuda) - 0.5
    x, y = a.clone(), a.clone()
    assert _ffma_call(x, l21, u12, ko, w)
    for r0, r1 in ((0, 333), (333, m)):
        for c0, c1 in ((0, 205), (205, w)):
            # y[ko + r0 :, ko + c0 :] is the quadrant's corner of the view
            assert _ffma_call(y[r0:, c0:], l21[r0:r1], u12[:, c0:c1], ko, c1 - c0)
    assert torch.equal(x, y)


@pytest.mark.parametrize("m,bc,r,jj0", [(3000, 1000, 48, 96), (1000, 301, 5, 10)],
                         ids=["r48", "odd_r_and_width"])
def test_panel_update_fp32_masked(cuda, m, bc, r, jj0):
    """Kernel 3 with fp32 update operands: the FFMA routine with its row
    mask.  Frozen rows (position < jj0 + r) and the columns left of the
    panel exact; L21 within 1e-5 of the plain version's; the update against
    the fp64 product of the kernel's own L21, within one fp32 ulp plus the
    sum bound.  odd_r_and_width: U12 at an odd offset with an odd row
    stride (the 4-byte-copy instance)."""
    rng = np.random.default_rng(7)
    slab = torch.from_numpy(rng.standard_normal((m, bc)).astype(np.float32)).to(cuda)
    pos = torch.from_numpy(rng.permutation(m).astype(np.int32)).to(cuda)
    rb = torch.from_numpy(rng.standard_normal((r, bc)).astype(np.float32)).to(cuda)
    ui = torch.triu(torch.from_numpy(rng.standard_normal((r, r)).astype(np.float32))).to(cuda)
    x, y = slab.clone(), slab.clone()
    _lib.reset_counts()
    panel_apply_update_trim(x, pos, rb, ui, jj0, jj0, False)
    assert _lib.launches["panel_update"] == 1
    panel_apply_update_trim_plain(y, pos, rb, ui, jj0, jj0, False)
    below = pos >= jj0 + r
    c0 = jj0 + r
    assert torch.equal(x[~below], slab[~below]) and torch.equal(x[:, :jj0], slab[:, :jj0])
    l21 = x[below, jj0:c0]
    assert float((l21 - y[below, jj0:c0]).abs().max() / y[below, jj0:c0].abs().max()) <= 1e-5
    ref = slab[below, c0:].double() - l21.double() @ rb[:, c0:].double()
    assert within_ulp(x[below, c0:], ref, sum_slack(slab[below, c0:], l21, rb[:, c0:]),
                      dtype=torch.float32).ok


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
@pytest.mark.parametrize("m,r,off", [
    (96, 16, 5), (1000, 12, 3), (4096, 128, 1000),
    (16384, 128, 0), (16384, 128, 8192), (4096, 256, 100), (65536, 128, 0),
    (200000, 8, 5), (300000, 64, 0)])
def test_hgetf2_kernel_exact(cuda, pdt, m, r, off):
    """Kernel 7: piv, perm, composed perm and srcs exact against the plain
    version, on the uniform panel (fp16: saturated first, as MPF_FP16) and
    on a tie-heavy dyadic one, with a permuted prev_perm.  The shapes span
    what the kernel takes: the masked path's m = 16384 at the first and a
    middle panel's diagonal, r = 256 (the port routes it masked), m =
    65536 (two rows a thread), m = 200000 at r = 8 (rows past 512 a block:
    positions in shared memory) and m = 300000 at r = 64 (the slice in
    global memory).  A shape the kernel refuses raises: no fallback."""
    uni = matgen.random_dense(m, seed=m)[:, :r] if m <= 16384 else (
        np.random.default_rng(m).random((m, r)).astype(np.float32) * 2 - 1)
    rng = np.random.default_rng(r)
    dy = (rng.integers(-4, 5, (m, r)) * 2.0 ** rng.integers(-2, 3, (m, r))).astype(np.float32)
    dy[dy == 0] = 1.0
    prev = torch.randperm(m, generator=torch.Generator().manual_seed(0)).to(torch.int32).to(cuda)
    for a in (uni, dy):
        pan = torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
        if pdt == torch.float16:
            pan = cast_to_panel(pan, MPF_FP16).contiguous()
        got = hgetf2_panel_swaps(pan, off, prev, panel_dtype=pdt)
        ref = hgetf2_panel_plain(pan, off, prev, panel_dtype=pdt)
        for x, y in zip(got, ref):
            assert torch.equal(x, y)


@pytest.mark.parametrize("r", [8, 48, 128, 256])
def test_npv_kernels(cuda, r):
    """Kernels 8 and 8b: LU and L^{-1} bit-exact against the plain version,
    U^{-1} within 1e-5 of its largest entry (the plain version's product
    sums in its own order), info exact (including a zero pivot).  For r <=
    128 (kernel 2's routines), kernel 8's LU, U^{-1} and info also bitwise
    kernel 2's outputs on the same rows (its row block's diagonal part and
    U^{-1}, fp32 slab); r = 256 runs the global-memory instance, its
    L^{-1} held as U^{-1}."""
    blk = torch.from_numpy((np.random.default_rng(r).random((r, r)) + r * np.eye(r))
                           .astype(np.float32)).to(cuda)
    k, p = getf2_npv_inv_block(blk), getf2_npv_inv_plain(blk)
    assert torch.equal(k[0], p[0]) and int(k[3]) == int(p[3]) == 0
    for x, y in zip(k[1:3], p[1:3]):
        assert float((x - y).abs().max() / y.abs().max()) <= 1e-5
    if r <= 128:
        assert torch.equal(k[1], p[1])
        rb, ui, info2 = rowblock_assemble(blk, torch.arange(r, dtype=torch.int32, device=cuda), 0)
        assert torch.equal(k[0], rb) and torch.equal(k[2], ui) and int(info2) == int(k[3])
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


# ---------------------------------------------------------------- ALL_BF16

def test_strip_pivots_kernel_bf16_slab(cuda):
    """Kernel 1 on a bf16 slab: exact against its plain version and against
    the kernel on an fp32 slab holding the same values (quant16 and exact)."""
    slab = _hpl(2048, 1, cuda)[:, :512].to(BF).contiguous()
    pos = torch.randperm(2048, generator=torch.Generator().manual_seed(0)).to(
        torch.int32).to(cuda)
    for q16 in (True, False):
        got = strip_panel_pivots(slab, 128, pos, BF, jj0=128, r=64, quant16=q16)
        ref = strip_panel_pivots_plain(slab, 128, pos, BF, jj0=128, r=64, quant16=q16)
        f32 = strip_panel_pivots(slab.float(), 128, pos, BF, jj0=128, r=64, quant16=q16)
        for x, y, z in zip(got, ref, f32):
            assert torch.equal(x, y) and torch.equal(x, z)


def test_rowblock_kernel_bf16(cuda):
    """Kernel 2's bf16 instance on the pivot rows kernel 1 picks (as the
    fused path gathers them): row block and U^-1 within one bf16 ulp of
    the plain version, the gathered L part exact, info exact."""
    slab = torch.from_numpy(matgen.random_dense(1024, seed=2)[:, :256].copy()).to(cuda).to(BF)
    pos = torch.arange(1024, dtype=torch.int32, device=cuda)
    glist = strip_panel_pivots(slab, 64, pos, BF, jj0=64, r=64)[2]
    k = rowblock_assemble(slab, glist, 64)
    p = rowblock_assemble_plain(slab, glist, 64)
    assert k[0].dtype == k[1].dtype == BF
    assert within_bf16_ulp(k[0], p[0]) and within_bf16_ulp(k[1], p[1])
    assert torch.equal(k[0][:, :64], slab[glist.long(), :64])
    assert int(k[2]) == int(p[2]) == 0


@pytest.mark.parametrize("jj0", [0, 384, 896])
def test_kernel12_on_card(cuda, jj0):
    """Kernel 12's two passes against their plain versions on the same
    inputs: L21 within one bf16 ulp, the update (fed the kernel's own L21)
    within one bf16 ulp plus the fp32 sum-order bound; frozen rows and the
    columns left of the panel exact; the last panel of a block column
    launches no update."""
    rng = np.random.default_rng(12 + jj0)
    m, bc, r = 2000, 1024, 128
    slab = torch.from_numpy(rng.standard_normal((m, bc)).astype(np.float32)).to(cuda).to(BF)
    pos = torch.from_numpy(rng.permutation(m).astype(np.int32)).to(cuda)
    rb = torch.from_numpy(rng.standard_normal((r, bc)).astype(np.float32)).to(cuda).to(BF)
    ui = torch.triu(torch.from_numpy(rng.standard_normal((r, r)).astype(np.float32) / 8)).to(
        cuda).to(BF)
    j0 = 500
    frozen = pos < j0 + r
    a, b = slab.clone(), slab.clone()
    la, lb = l21_trim(a, pos, ui, j0, jj0), l21_trim_plain(b, pos, ui, j0, jj0)
    assert within_bf16_ulp(la, lb) and within_bf16_ulp(a, b)
    assert torch.equal(a[frozen], slab[frozen]) and not la[frozen].any()
    c = a.clone()
    if jj0 + r < bc:
        slack = sum_slack(c[:, jj0 + r:], la, rb[:, jj0 + r:])
        upd_wide(a, la, rb, jj0)
        upd_wide_plain(c, la, rb, jj0)
        assert within_bf16_ulp(a[:, jj0 + r:], c[:, jj0 + r:], slack)
        assert torch.equal(a[:, :jj0 + r], c[:, :jj0 + r])
        assert not torch.equal(a[~frozen, jj0 + r:], slab[~frozen, jj0 + r:])
    assert torch.equal(a[frozen], slab[frozen]) and torch.equal(a[:, :jj0], slab[:, :jj0])
    _lib.reset_counts()
    panel_apply_update_trim(slab.clone(), pos, rb, ui, j0, jj0)
    assert _lib.launches["l21_trim"] == 1 and _lib.launches["panel_update"] == 0
    assert _lib.launches["upd_wide"] == int(jj0 + r < bc)


@pytest.mark.parametrize("r", [8, 48, 128])
@pytest.mark.parametrize("m", [2000, 129])
def test_kernel12_every_panel(cuda, m, r):
    """Kernel 12 on every panel of a bc = 1024 slab (the update width from
    1024 - r down to 1024 % r, 0 at r = 8 and 128), ragged m: L21 within one
    bf16 ulp of the plain version, the update pass (fed the kernel's own
    L21) within one bf16 ulp plus the fp32 sum-order bound, its two
    instances (C through shared memory, C in registers) bitwise equal;
    frozen rows and the columns left of the panel exact; one launch each,
    no operand copy (the slab a view of a wider matrix)."""
    rng = np.random.default_rng(1000 * r + m)
    bc = 1024
    mat = torch.from_numpy(rng.standard_normal((m, bc + 2048)).astype(np.float32)).to(
        cuda).to(BF)
    slab = mat[:, 1024:1024 + bc]
    pos = torch.from_numpy((rng.permutation(m) + r).astype(np.int32)).to(cuda)
    j0 = m // 3
    frozen = pos < j0 + r   # a third of the rows
    for jj0 in range(0, bc - r + 1, r):
        rb = torch.from_numpy(rng.standard_normal((r, bc)).astype(np.float32)).to(cuda).to(BF)
        ui = torch.triu(torch.from_numpy(rng.standard_normal((r, r)).astype(np.float32)
                                         / 8)).to(cuda).to(BF)
        a, b = mat.clone(), mat.clone()
        sa, sb = a[:, 1024:1024 + bc], b[:, 1024:1024 + bc]
        _lib.reset_counts()
        la = l21_trim(sa, pos, ui, j0, jj0)
        lb = l21_trim_plain(sb, pos, ui, j0, jj0)
        assert within_bf16_ulp(la, lb) and within_bf16_ulp(sa, sb), jj0
        assert torch.equal(sa[frozen], slab[frozen]) and not la[frozen].any()
        c0 = jj0 + r
        if c0 < bc:
            c, d = a.clone(), a.clone()
            sc, sd = c[:, 1024:1024 + bc], d[:, 1024:1024 + bc]
            slack = sum_slack(sc[:, c0:], la, rb[:, c0:])
            upd_wide(sa, la, rb, jj0)
            upd_wide(sd, la, rb, jj0, smem_c=False)
            upd_wide_plain(sc, la, rb, jj0)
            assert within_bf16_ulp(sa[:, c0:], sc[:, c0:], slack), jj0
            assert torch.equal(a, d), jj0
            assert torch.equal(sa[:, :c0], sc[:, :c0]) and torch.equal(sa[frozen], slab[frozen])
        assert torch.equal(a[:, :1024], mat[:, :1024]) and torch.equal(a[:, 2048:], mat[:, 2048:])
        assert _lib.launches["l21_trim"] == 1 and _lib.launches["upd_wide"] == 2 * (c0 < bc)
        assert _lib.copies["gemm_operand"] == 0


def test_kernel12_unaligned_operands(cuda):
    """Kernel 12's update pass with U12 at a column that is no multiple of 8
    elements (r = 12): U12 is copied into a padded buffer (one copy
    counted), the slab columns at an odd offset take the register epilogue
    whatever smem_c asks: against the plain version."""
    rng = np.random.default_rng(77)
    m, bc, r, jj0 = 700, 300, 12, 24
    mat = torch.from_numpy(rng.standard_normal((m, bc + 5)).astype(np.float32)).to(cuda).to(BF)
    slab = mat[:, 3:3 + bc]
    pos = torch.arange(m, dtype=torch.int32, device=cuda)
    rb = torch.from_numpy(rng.standard_normal((r, bc)).astype(np.float32)).to(cuda).to(BF)
    ui = torch.triu(torch.from_numpy(rng.standard_normal((r, r)).astype(np.float32) / 4)).to(
        cuda).to(BF)
    a, b = mat.clone(), mat.clone()
    sa, sb = a[:, 3:3 + bc], b[:, 3:3 + bc]
    la, lb = l21_trim(sa, pos, ui, 0, jj0), l21_trim_plain(sb, pos, ui, 0, jj0)
    assert within_bf16_ulp(la, lb) and within_bf16_ulp(sa, sb)
    c = a.clone()
    sc = c[:, 3:3 + bc]
    slack = sum_slack(sc[:, jj0 + r:], la, rb[:, jj0 + r:])
    _lib.reset_counts()
    upd_wide(sa, la, rb, jj0)
    assert _lib.launches["upd_wide"] == 1 and _lib.copies["gemm_operand"] == 1
    upd_wide_plain(sc, la, rb, jj0)
    assert within_bf16_ulp(sa[:, jj0 + r:], sc[:, jj0 + r:], slack)
    assert torch.equal(a[:, :3 + jj0 + r], c[:, :3 + jj0 + r])
    assert torch.equal(a[:, 3 + bc:], mat[:, 3 + bc:])


@pytest.mark.parametrize("dt", [torch.float32, BF])
@pytest.mark.parametrize("n,leaves", [
    (1000, None), (1, [(0, 1)]), (2, [(0, 2)]), (40, [(20, 17)]), (64, [(0, 64)]),
    (200, [(73, 127)]), (128, [(0, 128)]), (300, [(0, 128), (128, 2), (130, 127), (257, 17)])],
    ids=["leaves_1000", "s1", "s2", "s17", "s64", "s127", "s128", "mixed"])
def test_tri_inv_kernel_leaves_bitwise(cuda, dt, n, leaves):
    """Kernel 5 bitwise its plain version on leaf lists of every shape the
    recursion makes (_leaves(1000, 128), ragged last leaf), single leaves
    of 1, 2, 17, 64, 127 and 128 at any diagonal offset, and a mixed list,
    fp32 and bf16, on a matrix of odd row stride (a view of a wider one);
    the launch covers every leaf in one call."""
    rng = np.random.default_rng(n)
    leaves = _leaves(n, 128) if leaves is None else leaves
    wide = torch.from_numpy(rng.uniform(-0.5, 0.5, (n, n + 3)).astype(np.float32)).to(cuda)
    l = torch.tril(wide, -1).to(dt)[:, :n]
    assert l.stride(0) == n + 3
    _lib.reset_counts()
    k = tri_inv_leaves(l, leaves)
    assert _lib.launches["tri_inv"] == 1
    p = tri_inv_leaves_plain(l, leaves)
    for o, s in leaves:
        assert torch.equal(k[o:o + s, o:o + s], p[o:o + s, o:o + s]), (o, s)


def test_kernel12_factorization_calls_copy_nothing(cuda):
    """ALL_BF16 on the fused route at n = 2048 (kernel 12 on views of the
    working matrix): no operand copied for TMA, and the update pass
    launched on every panel but the last of its block column."""
    a = _hpl(2048, 8, cuda)
    _lib.reset_counts()
    res = mpf_factorize(a, r=128, policy=ALL_BF16)
    assert _lib.copies["gemm_operand"] == 0
    assert _lib.launches["l21_trim"] == 16 and _lib.launches["upd_wide"] == 14
    assert check_factorization_device(a, res.lu, res.ipiv, nbe_tol=5e-2).ok


def test_exchange_tri_inv_trailing_bf16(cuda):
    """Kernels 4 and 5 on bf16: exact; kernel 6's bf16-C instance within one
    bf16 ulp of its plain version plus the fp32 sum-order bound, ragged
    edges, outside untouched."""
    a = _hpl(1024, 3, cuda).to(BF)
    src = (torch.randperm(768, generator=torch.Generator().manual_seed(1))[:128] + 256).to(
        torch.int32).to(cuda)
    x, y = a.clone(), a.clone()
    assert torch.equal(rows_exchange(x, 256, src, src), rows_exchange_plain(y, 256, src, src))
    assert torch.equal(x, y)
    rng = np.random.default_rng(5)
    l = torch.tril(torch.from_numpy(rng.uniform(-0.5, 0.5, (384, 384)).astype(np.float32)),
                   -1).to(cuda).to(BF)
    leaves = _leaves(384, 128)
    k, p = tri_inv_leaves(l, leaves), tri_inv_leaves_plain(l, leaves)
    for o, s in leaves:
        assert torch.equal(k[o:o + s, o:o + s], p[o:o + s, o:o + s])
    a = _hpl(1000, 5, cuda).to(BF)
    l21 = (torch.rand((900, 72), device=cuda) - 0.5).to(BF)
    u12 = (torch.rand((72, 700), device=cuda) - 0.5).to(BF)
    x, y = a.clone(), a.clone()
    trailing_gemm_sub(x, l21, u12, 100, ncols=700)
    trailing_gemm_sub_plain(y, l21, u12, 100, ncols=700)
    assert within_bf16_ulp(x[100:, 100:800], y[100:, 100:800],
                           sum_slack(a[100:, 100:800], l21, u12))
    assert torch.equal(x[:100], a[:100]) and torch.equal(x[:, 800:], a[:, 800:])


def test_all_bf16_factorize_on_card(cuda):
    """ALL_BF16 on the fused route: kernels 1, 2, 12, 4, 5, 6 and 17 (once:
    one trailing update) launched, no kernel 3, no masked kernel, no plain
    version; device oracle at 5e-2; the pivots equal the CPU run's (plain
    versions) on the HPL-AI matrix."""
    n = 2048
    a = _hpl(n, 6, cuda)
    _lib.reset_counts()
    res = mpf_factorize(a, r=128, policy=ALL_BF16)
    assert res.lu.dtype == BF
    assert all(_lib.launches[k] > 0 for k in _FUSED_BF16), _lib.launches
    assert not any(_lib.launches[k] for k in _lib.KERNELS if k not in _FUSED_BF16)
    assert not any(_lib.plain_calls.values())
    assert _lib.launches["l21_trim"] == n // 128 and _lib.launches["upd_wide"] == 14
    assert _lib.launches["u12_product"] == 1
    assert check_factorization_device(a, res.lu, res.ipiv, nbe_tol=5e-2).ok
    cpu = mpf_factorize(a.cpu(), r=128, policy=ALL_BF16)
    assert torch.equal(cpu.ipiv, res.ipiv.cpu()) and torch.equal(cpu.perm, res.perm.cpu())


def _u12_operands(kw, w, dev, seed):
    """linv: the blocked inverse (kernel 5 and the recursion, as the
    block-column loop builds it) of a random unit-lower bf16 block whose entries lie below 2 /
    kw, so the inverse stays near one; a12: the (kw, w) view at row 32,
    column 200 of a wider bf16 matrix, which is returned too."""
    g = torch.Generator().manual_seed(seed)
    l11 = ((torch.rand((kw, kw), generator=g) - 0.5) * (4.0 / kw)).to(BF).to(dev)
    linv = unit_lower_inv_blocked(l11, base=128)
    big = (torch.rand((kw + 64, w + 328), generator=g) - 0.5).to(BF).to(dev)
    return linv, big, big[32:32 + kw, 200:200 + w]


@pytest.mark.parametrize("kw,w", [(1024, 1024), (1024, 3000), (250, 700), (1024, 31744)])
def test_u12_product_kernel(cuda, kw, w):
    """Kernel 17 against its plain version (the IEEE fp32 product of the
    bf16 operands, rounded once) with A12 a view of a wider matrix: every
    entry within one bf16 ulp plus the fp32 sum-order bound (sum_slack), at
    least 99.9% bit-equal; one launch, no plain call inside it; the matrix
    around A12 untouched; the result's rows padded to a multiple of 8
    entries, the padding zeros."""
    linv, big, a12 = _u12_operands(kw, w, cuda, kw + w)
    before = big.clone()
    _lib.reset_counts()
    got = u12_product(linv, a12)
    torch.cuda.synchronize()
    assert _lib.launches["u12_product"] == 1 and not any(_lib.plain_calls.values())
    w8 = -(-w // 8) * 8
    assert got.dtype == BF and got.shape == (kw, w) and got.stride() == (w8, 1)
    ref = u12_product_plain(linv, a12)
    rep = within_bf16_ulp(got, ref, sum_slack(torch.zeros(ref.shape, device=cuda), linv, a12))
    assert rep.ok, rep
    assert float((got == ref).double().mean()) >= 0.999
    assert torch.equal(big, before)
    assert not got.as_strided((kw, w8), (w8, 1))[:, w:].any()


def test_all_bf16_u12_keeps_the_matmul_in_pivots(cuda, monkeypatch):
    """ALL_BF16 at n = 16384 on HPL-AI: with kernel 17 (15 launches) the
    pivots and row map are exactly those of the same factorization with
    U12 on the ``matmul_in`` route (IEEE fp32 cuBLAS, then the cast),
    called in this test; both pass the device oracle."""
    from mpf_tpu_torch.utils.matgen import hpl_ai_matrix_device
    n = 16384
    a = hpl_ai_matrix_device(n, seed=19, dtype=BF, device=cuda)
    _lib.reset_counts()
    res = mpf_factorize(a, r=128, policy=ALL_BF16)
    assert _lib.launches["u12_product"] == n // 1024 - 1
    monkeypatch.setattr(mpf_loop, "_u12",
                        lambda linv, a12: matmul_in(linv, a12, a12.dtype).to(a12.dtype))
    _lib.reset_counts()
    ref = mpf_factorize(a, r=128, policy=ALL_BF16)
    assert _lib.launches["u12_product"] == 0
    assert torch.equal(res.ipiv, ref.ipiv) and torch.equal(res.perm, ref.perm)
    for x in (res, ref):
        assert check_factorization_device(a, x.lu, x.ipiv, nbe_tol=5e-2).ok


@pytest.mark.parametrize("pivot", [True, False])
def test_all_bf16_masked_on_card(cuda, pivot):
    """ALL_BF16 off the fused gate (r = 48, block 250, 250 % 48 != 0):
    kernels 5, 6, 17 (the trailing update's U12) and, with pivoting, 7 and
    9 launched; kernel 8 not (the bf16 diagonal is PyTorch ops); no plain
    version; device oracle at 5e-2."""
    n = 1000
    a = _hpl(n, 7, cuda)
    _lib.reset_counts()
    res = mpf_factorize(a, r=48, policy=ALL_BF16, block=250, pivot=pivot)
    want = ("tri_inv", "trailing_sub", "u12_product") + (("hgetf2", "laswp") if pivot else ())
    assert all(_lib.launches[k] > 0 for k in want), _lib.launches
    assert not any(_lib.launches[k] for k in _lib.KERNELS if k not in want)
    assert not any(_lib.plain_calls.values())
    assert check_factorization_device(a, res.lu, res.ipiv, nbe_tol=5e-2).ok
    assert pivot or torch.equal(res.ipiv.cpu(), torch.arange(1, n + 1, dtype=torch.int32))


def _band_perm(rng, n, k, bc):
    """(glist, dests) of a composed exchange map: swaps band row i <-> a
    row >= k + i, in order (swap chains bottom out in the band)."""
    perm = np.arange(k, n)
    for i in range(bc):
        j = rng.integers(i, n - k)
        perm[[i, j]] = perm[[j, i]]
    inv = np.empty(n - k, dtype=np.int64)
    inv[perm - k] = np.arange(n - k)
    return (torch.from_numpy(perm[:bc].astype(np.int32)),
            torch.from_numpy((inv[:bc] + k).astype(np.int32)))


@pytest.mark.parametrize("n,r0,c0,kk", [(1000, 256, 392, 136), (4096, 256, 1280, 1024)],
                         ids=["ragged", "more_tiles_than_sms"])
@pytest.mark.parametrize("dt,gd", [(torch.float32, BF), (torch.float32, torch.float32),
                                   (BF, BF)])
def test_gemmx_kernel(cuda, dt, gd, n, r0, c0, kk):
    """Kernel 13 at ragged sizes (n = 1000, r0 = 256, c0 = 392, K = 136,
    nr = 136) and at n = 4096, K = nr = 1024 (330 bf16 tiles, more than the
    SMs), each instance: bitwise equal to kernel 6 on the same region
    followed by kernel 4, for a random band map, the identity map and a
    band whose every row leaves.  Kernel 6's GEMM against the plain
    version: outside the region exact, inside within 1e-6 of max |a| (fp32
    C) or one bf16 ulp plus the fp32 sum-order bound (bf16 C).  The plain
    version with ``xargs`` equals its GEMM followed by the plain exchange."""
    rng = np.random.default_rng(11)
    m, w = n - r0, n - c0
    a = _hpl(n, 8, cuda).to(dt)
    l21 = (torch.rand((m, kk), device=cuda) - 0.5).to(gd)
    u12 = (torch.rand((kk, w), device=cuda) - 0.5).to(gd)
    g0 = a.clone()
    trailing_gemm_sub(g0[:, c0 - r0:], l21, u12, r0, ncols=w)
    p0 = gemm_trailing_plain(a.clone(), l21, u12, r0, c0)
    assert torch.equal(g0[:r0], a[:r0]) and torch.equal(g0[:, :c0], a[:, :c0])
    if dt == BF:
        assert within_bf16_ulp(g0[r0:, c0:], p0[r0:, c0:],
                               sum_slack(a[r0:, c0:], l21, u12)).ok
    else:
        assert float((g0 - p0).abs().max() / p0.abs().max()) <= 1e-6
    ident = torch.arange(r0, r0 + kk, dtype=torch.int32)
    rev = torch.arange(n - 1, n - 1 - kk, -1, dtype=torch.int32)
    for glist, dests in (_band_perm(rng, n, r0, kk), (ident, ident), (rev, rev)):
        glist, dests = glist.to(cuda), dests.to(cuda)
        x, y = a.clone(), g0.clone()
        _lib.reset_counts()
        _, pk = gemm_trailing(x, l21, u12, r0, c0, xargs=(r0, glist, dests))
        assert _lib.launches["gemmx"] == 1 and not any(_lib.plain_calls.values())
        py = rows_exchange(y, r0, glist, dests)
        x[r0:r0 + kk], y[r0:r0 + kk] = pk, py
        assert torch.equal(pk, py) and torch.equal(x, y)
        z, zp = p0.clone(), a.clone()
        pz = rows_exchange_plain(z, r0, glist, dests)
        _, pzp = gemm_trailing_plain(zp, l21, u12, r0, c0, xargs=(r0, glist, dests))
        assert torch.equal(pz, pzp) and torch.equal(z, zp)


@pytest.mark.parametrize("dtype", [torch.float32, BF])
def test_rows_kernels_exact(cuda, dtype):
    """Kernel 11 equals its plain versions bit for bit: a gather with
    repeats; a scatter with self-moves, inactive rows (their dests collide
    with anything) and a duplicate destination carrying equal values; a
    scatter from the band with in-band destinations."""
    rng = np.random.default_rng(12)
    n = 777
    a = _hpl(n, 9, cuda).to(dtype)
    rows = torch.from_numpy(rng.integers(0, n, 100).astype(np.int32)).to(cuda)
    _lib.reset_counts()
    assert torch.equal(rows_gather(a, rows), rows_gather_plain(a, rows))
    dests = torch.from_numpy(rng.choice(n, 60, replace=False).astype(np.int32)).to(cuda)
    src = torch.from_numpy(rng.choice(n, 60, replace=False).astype(np.int32)).to(cuda)
    src[:5] = dests[:5]                               # self-moves
    dests[10] = dests[11]
    src[10] = src[11]                                 # duplicate, equal values
    active = torch.ones(60, dtype=torch.bool, device=cuda)
    active[20:25] = False
    dests[20:25] = dests[30]                          # dropped: collide freely
    vals = a[src.long()].clone()
    x, y = a.clone(), a.clone()
    rows_scatter_inplace(x, dests, vals, self_src=src, active=active)
    rows_scatter_inplace_plain(y, dests, vals, self_src=src, active=active)
    assert torch.equal(x, y)
    glist, bdests = _band_perm(rng, n, 128, 64)
    x, y = a.clone(), a.clone()
    rows_scatter_from_band(x, 128, bdests.to(cuda))
    rows_scatter_from_band_plain(y, 128, bdests.to(cuda))
    assert torch.equal(x, y)
    assert _lib.launches["rows_gather"] == 1 and _lib.launches["rows_scatter"] == 2


@pytest.mark.parametrize("policy", [MPF_BF16, PURE_FP32, ALL_BF16])
def test_rows_kernels_move_kernel4_rows(cuda, policy, monkeypatch):
    """On each fused block column's ``(glist, dests)`` of a factorization on
    the card (uniform matrix, n = 2048, r = 128, block 512: 4 block
    columns), kernel 11's gather and scatter from the band, then the band
    write, leave the matrix and the pivot rows bitwise equal to kernel 4's;
    the factorization goes on with kernel 4's result, bitwise the
    unobserved one."""
    real = mpf_loop._exchange
    moved = []

    def both(a, k, bc, stage, combined):
        glist, dests = stage[2], stage[3]
        x, y = a.clone(), a.clone()
        g = rows_gather(x, glist)
        rows_scatter_from_band(x, k, dests)
        x[k:k + bc] = g
        p = rows_exchange(y, k, glist, dests)
        y[k:k + bc] = p
        assert torch.equal(g, p) and torch.equal(x, y), k
        moved.append(int(((dests < k) | (dests >= k + bc)).sum()))
        real(a, k, bc, stage, combined)

    a = torch.from_numpy(matgen.random_dense(2048, seed=5)).to(cuda)
    classic = mpf_factorize(a, r=128, policy=policy, block=512)
    monkeypatch.setattr(mpf_loop, "_exchange", both)
    _lib.reset_counts()
    res = mpf_factorize(a, r=128, policy=policy, block=512)
    assert _lib.launches["rows_gather"] == _lib.launches["rows_scatter"] == 4
    assert _lib.launches["rows_exchange"] == 8 and not any(_lib.plain_calls.values())
    assert all(moved[:-1]), moved
    assert torch.equal(res.lu, classic.lu) and torch.equal(res.perm, classic.perm)


@pytest.mark.parametrize("policy", [MPF_BF16, PURE_FP32, ALL_BF16])
def test_lookahead_on_card(cuda, policy):
    """n = 2048, block 512: lookahead launches kernel 13 twice (block
    columns 0 and 1; column 2's wide part is empty) and kernel 4 twice, with
    the pivots and row map of the classic loop on the card, LU within the
    oracle bound times max |LU| (tests/test_lookahead.py's bar: the narrow
    and wide U12 are cuBLAS products of other shapes) and the device
    oracle."""
    n = 2048
    a = _hpl(n, 10, cuda)
    tol = 5e-2 if policy is ALL_BF16 else (1e-3 if policy is MPF_BF16 else 1e-5)
    classic = mpf_factorize(a, r=128, policy=policy, block=512)
    _lib.reset_counts()
    la = mpf_factorize(a, r=128, policy=policy, block=512, lookahead=True)
    assert _lib.launches["gemmx"] == 2 and _lib.launches["rows_exchange"] == 2
    assert _lib.launches["trailing_sub"] == 3 and not any(_lib.plain_calls.values())
    assert torch.equal(la.ipiv, classic.ipiv) and torch.equal(la.perm, classic.perm)
    d = float((la.lu.float() - classic.lu.float()).abs().max())
    assert d <= tol * float(classic.lu.float().abs().max()), d
    assert check_factorization_device(a, la.lu, la.ipiv, nbe_tol=tol).ok


@pytest.mark.parametrize("dtype", [torch.float32, BF])
def test_overflow_kernels_exact(cuda, dtype):
    """Kernel 14: the band copy and the flush (dead slots carry the
    sentinel and are dropped) bitwise equal to their plain versions, on
    an odd width (unaligned rows take the element copy)."""
    n, ov, w = 1024, 256, 1001
    a = (torch.rand((n + ov, w), device=cuda) - 0.5).to(dtype)
    x, y = a.clone(), a.clone()
    _lib.reset_counts()
    copy_rows_block(x, 128, n + 64, 192)
    copy_rows_block_plain(y, 128, n + 64, 192)
    assert torch.equal(x, y) and _lib.launches["copy_rows"] == 1
    gen = torch.Generator().manual_seed(3)
    dests = torch.full((ov,), SENT, dtype=torch.int32)
    live = torch.randperm(ov, generator=gen)[:150]
    dests[live] = torch.randperm(n, generator=gen)[:150].to(torch.int32)
    dests = dests.to(cuda)
    flush_overflow(x, n, dests)
    flush_overflow_plain(y, n, dests)
    assert torch.equal(x, y) and _lib.launches["flush_overflow"] == 1


@pytest.mark.parametrize("dtype,gemm_bf16", [(torch.float32, False), (torch.float32, True),
                                             (BF, False)])
def test_kernel10_on_card(cuda, dtype, gemm_bf16):
    """Kernel 10 at jj0 = 0, 128 and 448 of a 2000 x 512 slab, r = 64:
    L21 within one ulp of the slab's dtype of the plain version's; the
    update within 1e-5 of max |slab| for fp32 operands and within one bf16
    ulp plus the sum-order slack for bf16 ones; the columns left of the
    panel and the frozen rows exact.  One launch a call."""
    rng = np.random.default_rng(7)
    m, bc, r = 2000, 512, 64
    for jj0 in (0, 128, 448):
        slab = torch.from_numpy(rng.standard_normal((m, bc)).astype(np.float32)).to(cuda)
        slab = slab.to(dtype)
        pos = torch.from_numpy(rng.permutation(m).astype(np.int32)).to(cuda)
        rb = torch.from_numpy(rng.standard_normal((r, bc)).astype(np.float32)).to(cuda).to(dtype)
        ui = torch.triu(torch.from_numpy(rng.standard_normal((r, r)).astype(np.float32)) / 8)
        ui = ui.to(cuda).to(dtype)
        x, y = slab.clone(), slab.clone()
        _lib.reset_counts()
        panel_apply_update(x, pos, rb, ui, jj0, jj0, gemm_bf16)
        assert _lib.launches["panel_update_full"] == 1
        panel_apply_update_plain(y, pos, rb, ui, jj0, jj0, gemm_bf16)
        below = pos >= jj0 + r
        c0 = jj0 + r
        assert torch.equal(x[~below], slab[~below]) and torch.equal(x[:, :jj0], slab[:, :jj0])
        assert within_bf16_ulp(x[:, jj0:c0], y[:, jj0:c0]).ok if dtype == BF else (
            float((x[:, jj0:c0] - y[:, jj0:c0]).abs().max()) <= 1e-5 * float(y.abs().max()))
        if c0 < bc:
            if dtype == torch.float32 and not gemm_bf16:
                d = float((x[:, c0:] - y[:, c0:]).abs().max())
                assert d <= 1e-5 * float(y.abs().max()), d
            else:
                # the update fed the kernel's own L21, so only the sum order differs
                l21 = torch.where(below[:, None], x[:, jj0:c0].float(), 0.0).to(BF)
                z = slab.clone()
                z[:, c0:] = torch.where(below[:, None], (slab[:, c0:].float() - l21.float()
                                        @ rb[:, c0:].to(BF).float()).to(dtype), slab[:, c0:])
                rep = within_bf16_ulp(x[:, c0:], z[:, c0:],
                                      sum_slack(slab[:, c0:], l21, rb[:, c0:].to(BF)))
                assert rep.ok, rep


@pytest.mark.parametrize("policy", [MPF_BF16, ALL_BF16])
def test_defer_bitwise_equals_classic_on_card(cuda, policy):
    """n = 2048, block 256, S = 2 on the uniform matrix: the deferred
    driver's factors, pivots and row map bitwise equal to the classic
    loop's on the card (the kernels' sums do not depend on the slab's
    height), with 8 band copies and 4 flushes; the pre-extended input
    factored in place equals it too."""
    n, block, S = 2048, 256, 2
    a = torch.from_numpy(matgen.random_dense(n, seed=4)).to(cuda)
    classic = mpf_factorize(a, r=128, policy=policy, block=block)
    _lib.reset_counts()
    d = mpf_factorize(a, r=128, policy=policy, block=block, defer=S)
    assert _lib.launches["copy_rows"] == 8 and _lib.launches["flush_overflow"] == 4
    assert not any(_lib.plain_calls.values())
    assert torch.equal(d.lu, classic.lu) and torch.equal(d.ipiv, classic.ipiv)
    assert torch.equal(d.perm, classic.perm)
    ext = torch.cat([a.to(policy.working), torch.zeros((S * block, n), device=cuda,
                                                       dtype=policy.working)])
    e = make_mpf(n, r=128, policy=policy, block=block, defer=S)(ext)
    assert e.lu.data_ptr() == ext.data_ptr() and torch.equal(e.lu, classic.lu)


@pytest.mark.parametrize("dtype", [torch.float32, BF])
def test_pair_copy_kernels_exact(cuda, dtype):
    """Kernels 15a-15c on a (512, 2, 1024) pair matrix: the slab extract
    and writeback (rows [130, 1024), columns [3, 258): unaligned rows take
    the element copy; then rows [0, 1024), columns [256, 768)) and the
    band write of 96 rows at row 128, bitwise equal to their plain
    versions, one launch each."""
    a3 = (torch.rand((512, 2, 1024), device=cuda) - 0.5).to(dtype)
    x, y = a3.clone(), a3.clone()
    _lib.reset_counts()
    for k0, k, m, bc in ((130, 3, 894, 255), (0, 256, 1024, 512)):
        s_k = slab_extract(x, k0, k, m, bc)
        s_p = slab_extract_plain(y, k0, k, m, bc)
        assert torch.equal(s_k, s_p) and s_k.is_contiguous()
        new = (torch.rand((m, bc), device=cuda) - 0.5).to(dtype)
        slab_writeback(x, new, k0, k)
        slab_writeback_plain(y, new, k0, k)
        assert torch.equal(x, y)
    rows = (torch.rand((96, 1024), device=cuda) - 0.5).to(dtype)
    band_write_rows(x, rows, 128)
    band_write_rows_plain(y, rows, 128)
    assert torch.equal(x, y)
    assert [_lib.launches[k] for k in ("slab_extract", "slab_writeback", "band_write")] == [2, 2, 1]


@pytest.mark.parametrize("dtype", [torch.float32, BF])
@pytest.mark.parametrize("kw,w", [(1024, 3000), (100, 77), (256, 1024)])
def test_u12_inplace_kernel(cuda, dtype, kw, w):
    """Kernel 15d in place on the pair matrix against its plain version,
    which computes the whole product before it writes (an out-of-place
    reference, so a row read after another block wrote it would show):
    within one ulp of the working dtype plus ``sum_slack``; everything
    outside the block exact; ragged kw and w included."""
    n = 4096
    rng = np.random.default_rng(kw)
    a3 = torch.from_numpy(rng.uniform(0, 9.9, (n, n)).astype(np.float32)).to(cuda).to(dtype)
    a3 = a3.view(n // 2, 2, n)
    lt = torch.tril(torch.from_numpy(rng.uniform(-1, 1, (kw, kw)).astype(np.float32)), -1)
    linv = unit_lower_inv_blocked((lt / 4).to(cuda).to(dtype), base=128)
    ks, e = 64, 64 + kw
    x, y = a3.clone(), a3.clone()
    a12 = a3.view(n, n)[ks:ks + kw, e:e + w].clone()
    _lib.reset_counts()
    u12_transform(x, linv, ks, e, w)
    assert _lib.launches["u12_inplace"] == 1
    u12_transform_plain(y, linv, ks, e, w)
    xm, ym = x.view(n, n), y.view(n, n)
    rep = within_ulp(xm[ks:ks + kw, e:e + w], ym[ks:ks + kw, e:e + w],
                     sum_slack(torch.zeros((), device=cuda), linv, a12), dtype)
    assert rep.ok, rep
    xm[ks:ks + kw, e:e + w] = 0
    ym[ks:ks + kw, e:e + w] = 0
    assert torch.equal(x, y)


@pytest.mark.parametrize("policy", [MPF_BF16, ALL_BF16])
def test_pair3d_driver_on_card(cuda, policy):
    """The pair-layout driver at n = 4096 (block 1024) against the 2D
    loop on the HPL-AI matrix: pivots and row map equal, factors within
    1e-3 (MPF_BF16) or 3e-2 (ALL_BF16: a few bf16 ulps of the n/4
    diagonal) of max |lu|, since U12's sums differ from cuBLAS's; oracle at the
    policy's bound, the exact launch counts, no plain call; the factors
    come back (n/2, 2, n) in the input's memory."""
    n = 4096
    a = _hpl(n, 9, cuda)
    ref = mpf_factorize(a, r=128, policy=policy)
    a3 = a.to(policy.working).view(n // 2, 2, n).clone()
    _lib.reset_counts()
    res = make_mpf(n, r=128, policy=policy)(a3)
    assert res.lu.data_ptr() == a3.data_ptr() and res.lu.shape == (n // 2, 2, n)
    cols, panels = n // 1024, n // 128
    want = dict(slab_extract=cols, slab_writeback=cols, rows_exchange=cols, band_write=cols,
                u12_inplace=cols - 1, tri_inv=cols - 1, trailing_sub=cols - 1,
                strip_pivots=panels, rowblock=panels)
    want.update(dict(l21_trim=panels, upd_wide=panels - cols) if policy is ALL_BF16
                else dict(panel_update=panels))
    assert {k: v for k, v in _lib.launches.items() if v} == want
    assert not any(_lib.plain_calls.values())
    assert torch.equal(res.ipiv, ref.ipiv) and torch.equal(res.perm, ref.perm)
    lu = res.lu.view(n, n).float()
    tol = 5e-2 if policy is ALL_BF16 else 1e-3
    d = float((lu - ref.lu.float()).abs().max())
    assert d <= (3e-2 if policy is ALL_BF16 else 1e-3) * float(ref.lu.float().abs().max()), d
    assert check_factorization_device(a, res.lu.view(n, n), res.ipiv, nbe_tol=tol).ok


def test_factorization_leaves_no_device_memory(cuda):
    """n = 4096 under ALL_BF16, classic and pair layout: once the result
    and its input are dropped, ``torch.cuda.memory_allocated()`` is back
    to its value before the call, with Python's cyclic collector off (a
    reference cycle in the driver once held the matrix until the collector
    ran)."""
    import gc
    n = 4096
    a = _hpl(n, 2, cuda).to(BF)
    fac = make_mpf(n, r=128, policy=ALL_BF16)
    fac(a.clone())                       # build the kernels, warm the caches
    for shape in ((n, n), (n // 2, 2, n)):
        torch.cuda.synchronize()
        gc.collect()
        gc.disable()
        try:
            before = torch.cuda.memory_allocated()
            work = a.clone().view(shape)
            res = fac(work)
            del res, work
            torch.cuda.synchronize()
            assert torch.cuda.memory_allocated() == before, shape
        finally:
            gc.enable()


# --------------------------------------------------------------------------
# Kernels 16a-16k: the tools/ probes (mpf_tpu_torch/tools)
# --------------------------------------------------------------------------

_PROBES = tuple(k for k in _lib.KERNELS if k.startswith("probe_"))


def _gen(cuda, seed):
    return torch.Generator(device=cuda).manual_seed(seed)


@pytest.mark.parametrize("ns", [64, 4096, 262144])
def test_probe_schedule_kernels_exact(cuda, ns):
    """16a and 16b on random int32 schedules (wrapping sums) and x: bitwise
    their plain versions; 16b's bulk copy from offsets 512 and 0."""
    from mpf_tpu_torch.tools.probe_r4 import (
        bulk_copy, bulk_copy_plain, sched_read, sched_read_plain)
    g = torch.Generator().manual_seed(ns)
    s = torch.randint(-2**31, 2**31 - 1, (ns,), generator=g, dtype=torch.int32).to(cuda)
    x = torch.randn((8, 128), generator=g).to(cuda)
    assert torch.equal(sched_read(s, x), sched_read_plain(s, x))
    for off, count in ((512, 512), (0, 16)):
        if off + count <= ns:
            assert torch.equal(bulk_copy(s, x, off, count), bulk_copy_plain(s, x, off, count))


@pytest.mark.parametrize("w,depth", [(3000, 1), (3000, 4), (8192, 32), (512, 48)])
def test_probe_row_ring_exact(cuda, w, depth):
    """16c: every row read through the ring; out is the row the tool's
    formula names, bitwise, for ragged row chunks and every depth."""
    from mpf_tpu_torch.tools.probe_r4 import ROW_STRIDE, row_ring, row_ring_plain, row_ring_target
    n, nrows = 1000, 300
    src = torch.randn((n, 1, w), generator=_gen(cuda, w + depth), device=cuda)
    out = row_ring(src, nrows, depth)
    assert torch.equal(out, src[(row_ring_target(nrows, depth) * ROW_STRIDE) % n])
    assert torch.equal(out, row_ring_plain(src, nrows, depth))


def test_probe_overlap_sum(cuda):
    """16d: the step sum within ``overlap_slack`` of the plain version on
    random bf16 operands (ragged ti), bitwise the same with extra bytes
    streamed (0.1 and 1 MB a step) as with none, and the checksum of the
    streamed bytes bitwise the plain version's (rows of 16 KB pieces, and
    of 2000 bytes, whose chunks end in a short piece)."""
    from mpf_tpu_torch.tools.probe_r4 import overlap, overlap_plain, overlap_slack
    gen = _gen(cuda, 16)
    l = torch.randn((200, 256), generator=gen, device=cuda).to(BF)
    u = torch.randn((256, 384), generator=gen, device=cuda).to(BF)
    steps = 8
    for a in (torch.randn((512, 1024), generator=gen, device=cuda).to(BF),
              torch.randn((300, 1000), generator=gen, device=cuda).to(BF)):
        got, sink = overlap(l, u, a, steps, 0)
        ref, ref_sink = overlap_plain(l, u, a, steps, 0)
        assert abs(float(got) - float(ref)) <= overlap_slack(l, u, steps)
        assert torch.equal(sink, ref_sink) and not sink.any()
        for mb in (0.1, 1):
            out, sink = overlap(l, u, a, steps, mb)
            assert torch.equal(out, got)
            assert torch.equal(sink, overlap_plain(l, u, a, steps, mb)[1]) and sink.any()


@pytest.mark.parametrize("dtype,g,w", [(BF, 16, 1024), (BF, 2, 1000), (torch.float32, 1, 999),
                                       (BF, 2, 77)])
@pytest.mark.parametrize("depth", [1, 4, 16])
def test_probe_window_kernels_exact(cuda, dtype, g, w, depth):
    """16e and 16f (and 16j, 16e on a view): read-modify-write and
    read-only visits bitwise their plain versions, vector and element
    paths (odd window sizes)."""
    from mpf_tpu_torch.tools.granule_r5 import (
        rmw_plain, window_gather, window_gather_plain, window_rmw)
    from mpf_tpu_torch.tools.refview_r5 import refview_rmw, refview_rmw_plain
    nwin, e = 300, 200
    rng = np.random.default_rng(g * w + depth)
    ids = torch.from_numpy(np.sort(rng.choice(nwin, e, replace=False)).astype(np.int32))
    ids = ids.to(cuda)
    x = torch.randn((nwin, g, w), generator=_gen(cuda, depth), device=cuda).to(dtype)
    y = x.clone()
    assert torch.equal(window_gather(x, ids, depth), window_gather_plain(x, ids))
    assert torch.equal(window_rmw(x, ids, depth), rmw_plain(y, ids))
    m, mp = x.view(nwin * g, w), y.clone().view(nwin * g, w)
    assert torch.equal(refview_rmw(m, ids, g, depth), refview_rmw_plain(mp, ids, g))


@pytest.mark.parametrize("dtype", [torch.float32, BF])
def test_probe_relayout_and_gemm3d(cuda, dtype):
    """16g bitwise (ragged 32 x 32 transpose tiles) and 16h within one
    bf16 ulp plus sum_slack (bf16) or 1e-6 of max |ref| (fp32) of their
    plain versions, at ragged shapes."""
    from mpf_tpu_torch.tools.micro_3d import (
        gemm3d, gemm3d_close, gemm3d_plain, relayout, relayout_plain)
    gen = _gen(cuda, 17)
    a = torch.randn((40, 2, 72), generator=gen, device=cuda).to(dtype)
    for mode, inp in (("collapse", a), ("split", a.view(80, 72)), ("tchunk", a)):
        assert torch.equal(relayout(inp, mode), relayout_plain(inp, mode))
    a3 = torch.randn((100, 2, 96), generator=gen, device=cuda).to(dtype)
    b = torch.randn((96, 136), generator=gen, device=cuda).to(dtype)
    c3 = torch.randn((100, 2, 136), generator=gen, device=cuda).to(dtype)
    got, ref = gemm3d(a3, b, c3), gemm3d_plain(a3, b, c3)
    assert gemm3d_close(got, ref, a3, b, c3)


@pytest.mark.parametrize("mode", ["masked", "dma", "store", "dstore"])
def test_probe_xsel_exact(cuda, mode):
    """16i on a (16, 300) window (a ragged last block) with 500 entries:
    bitwise its plain version."""
    from mpf_tpu_torch.tools.xsel_micro import xsel, xsel_plain
    rng = np.random.default_rng(5)
    ids = torch.from_numpy(rng.integers(0, 16, 500).astype(np.int32)).to(cuda)
    x = torch.randn((16, 300), generator=_gen(cuda, 18), device=cuda).to(BF)
    assert torch.equal(xsel(x, ids, mode), xsel_plain(x, ids, mode))


@pytest.mark.parametrize("s,k,w", [(1000, 1000, 1000), (1024, 1024, 1280)])
def test_probe_dot_ragged(cuda, s, k, w):
    """16k (tile_mma's store epilogue) at a ragged shape and a tool shape:
    within one bf16 ulp plus sum_slack of the plain version."""
    from mpf_tpu_torch.tools.crash_bisect_r5 import dot, dot_close, dot_plain
    gen = _gen(cuda, 19)
    a = torch.randn((s, k), generator=gen, device=cuda).to(BF)
    b = torch.randn((k, w), generator=gen, device=cuda).to(BF)
    assert dot_close(dot(a, b), dot_plain(a, b), a, b)


def test_probe_wrappers_never_take_the_plain_version(cuda):
    """Every probe wrapper on CUDA tensors launches its kernel once and
    calls no plain version."""
    from mpf_tpu_torch.tools import crash_bisect_r5, granule_r5, micro_3d, probe_r4, refview_r5
    from mpf_tpu_torch.tools import xsel_micro
    _lib.reset_counts()
    s = torch.arange(4096, dtype=torch.int32, device=cuda)
    x = torch.zeros((8, 128), device=cuda)
    probe_r4.sched_read(s, x)
    probe_r4.bulk_copy(s, x)
    probe_r4.row_ring(torch.ones((64, 1, 1024), device=cuda), 64, 4)
    lb = torch.ones((128, 128), dtype=BF, device=cuda)
    probe_r4.overlap(lb, lb, torch.ones((64, 512), dtype=BF, device=cuda), 2, 0.1)
    a = torch.zeros((8, 2, 256), dtype=BF, device=cuda)
    ids = torch.tensor([1, 3, 6], dtype=torch.int32, device=cuda)
    granule_r5.window_rmw(a, ids)
    granule_r5.window_gather(a, ids)
    micro_3d.relayout(a, "tchunk")
    micro_3d.gemm3d(a[:, :, :128], lb, a[:, :, :128].contiguous())
    xsel_micro.xsel(a.view(16, 256), ids, "masked")
    refview_r5.refview_rmw(a.view(16, 256), ids, 2)
    crash_bisect_r5.dot(lb, lb)
    torch.cuda.synchronize()
    assert {k: _lib.launches[k] for k in _PROBES} == {k: 1 for k in _PROBES}
    assert not any(_lib.plain_calls.values())


# ------------------------------------------- kernels 1 and 2, the redesign

def _dead_and_shuffled(m, seed, dead_share, dev):
    """Positions: a permutation of 0..m-1 with ``dead_share`` of the rows
    dead (SENT)."""
    g = torch.Generator().manual_seed(seed)
    pos = torch.randperm(m, generator=g).to(torch.int32)
    pos[torch.randperm(m, generator=g)[:int(dead_share * m)]] = SENT
    return pos.to(dev)


@pytest.mark.parametrize("r", [8, 64, 128])
@pytest.mark.parametrize("pdt,q16", [(BF, True), (BF, False), (torch.float32, False)],
                         ids=["bf16-quant16", "bf16-exact", "fp32-exact"])
def test_strip_pivots_redesign_exact_m16384(cuda, pdt, q16, r):
    """Kernel 1 at m = 16384 (one block an SM, 125 rows each): piv, pos
    and glist exact against the plain version, on the uniform slab from
    the identity positions and with 10% dead rows, shuffled positions and
    off > 0; the bf16 panel also from a bf16 slab."""
    m = 16384
    slab = torch.from_numpy(matgen.random_dense(m, seed=11)[:, :512].copy()).to(cuda)
    cases = [(torch.arange(m, dtype=torch.int32, device=cuda), 0, 0),
             (_dead_and_shuffled(m, 12, 0.1, cuda), 300, 128)]
    for pos, off, jj0 in cases:
        slabs = [slab, slab.to(BF)] if pdt == BF else [slab]
        for s in slabs:
            got = strip_panel_pivots(s, off, pos, pdt, jj0=jj0, r=r, quant16=q16)
            ref = strip_panel_pivots_plain(s, off, pos, pdt, jj0=jj0, r=r, quant16=q16)
            for x, y in zip(got, ref):
                assert torch.equal(x, y)


@pytest.mark.parametrize("q16", [True, False], ids=["quant16", "exact"])
def test_strip_pivots_redesign_largest_slice(cuda, q16):
    """Kernel 1 at m = 73728 with a bf16 panel (559 rows a block, three a
    thread: the deferred exchange's pre-extended n = 65536 slab with S = 8),
    from fp32 and bf16 slabs, with dead rows: exact against the plain
    version."""
    m = 73728
    gen = torch.Generator(device=cuda).manual_seed(13)
    slab = torch.rand((m, 256), generator=gen, device=cuda) * 2 - 1
    pos = _dead_and_shuffled(m, 14, 0.1, cuda)
    for s in (slab, slab.to(BF)):
        got = strip_panel_pivots(s, 64, pos, BF, jj0=128, r=128, quant16=q16)
        ref = strip_panel_pivots_plain(s, 64, pos, BF, jj0=128, r=128, quant16=q16)
        for x, y in zip(got, ref):
            assert torch.equal(x, y)


def _stale_slot_launches(dev):
    """(slab, pos, r, plain result) of launches whose panel width and grid
    change from one to the next: r 128 -> 8 -> 48 -> 64 -> 128 and m 16384
    -> 200 -> 50 -> 64 -> 16384 (G 132 -> 100 -> 50 -> 64 -> 132 on 132
    SMs; r <= m, since a column no row can pivot on reads apart in the
    kernel and the plain version), then the earlier sizes at r = 64."""
    out = []
    for m, r in ((16384, 128), (200, 8), (50, 48), (64, 64), (16384, 128),
                 (1000, 64), (16384, 64), (200, 64), (5000, 64)):
        slab = torch.from_numpy(matgen.random_dense(m, seed=m + r)[:, :128].copy()).to(dev)
        pos = torch.arange(m, dtype=torch.int32, device=dev)
        out.append((slab, pos, r, strip_panel_pivots_plain(slab, 0, pos, BF, r=r)))
    return out


def test_strip_pivots_back_to_back_launches(cuda):
    """Kernel 1's slots carry a flag from the launch count its scratch
    keeps: launches in a row on one stream, with r and the grid changing
    from one to the next, give the plain version's pivots every time (a
    slot an earlier launch left never reads as current), and block 0 polls
    at least once a column (``exchange_polls``)."""
    exchange_polls()
    for slab, pos, r, ref in _stale_slot_launches(cuda):
        for _ in range(3):
            got = strip_panel_pivots(slab, 0, pos, BF, r=r)
            assert all(torch.equal(x, y) for x, y in zip(got, ref))
            assert exchange_polls() >= r


def test_strip_pivots_stale_slots_on_two_streams(cuda):
    """The launches of the test above interleaved on two streams, one in
    order and one in reverse: each stream's scratch keeps its own launch
    count, so every launch gives the plain version's pivots, and each
    stream's block 0 polls at least once a column."""
    cases = _stale_slot_launches(cuda)
    streams = [torch.cuda.Stream() for _ in range(2)]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(st):
            exchange_polls()
    outs = [[], []]
    for k in range(2 * len(cases)):
        i = k % 2
        slab, pos, r, ref = cases[k // 2] if i == 0 else cases[-1 - k // 2]
        with torch.cuda.stream(streams[i]):
            outs[i].append((strip_panel_pivots(slab, 0, pos, BF, r=r), ref))
    torch.cuda.synchronize()
    for i, st in enumerate(streams):
        for got, ref in outs[i]:
            assert all(torch.equal(x, y) for x, y in zip(got, ref))
        with torch.cuda.stream(st):
            assert exchange_polls() >= sum(c[2] for c in cases)


@pytest.mark.parametrize("r", [8, 48, 128])
@pytest.mark.parametrize("dt", [torch.float32, BF], ids=["fp32", "bf16"])
def test_rowblock_redesign_lu_bitwise(cuda, dt, r):
    """Kernel 2: the diagonal LU bitwise against the plain version and
    against kernel 8's LU of the same gathered block (fp32, rounded to the
    slab's dtype); U^{-1} and U12 within 1e-5 of their largest entry
    (fp32), or one bf16 ulp plus the slack of sums taken in another order
    (bf16: the kernel's chains against the plain version's cuBLAS sums,
    the criterion of `chip_smoke.py`'s k2_bf16 phases); the gathered L
    part exact; info exact, also with an exactly-zero second pivot."""
    m, bc, jj0 = 4096, 512, 128
    slab = torch.from_numpy(matgen.random_dense(m, seed=r)[:, :bc].copy()).to(cuda).to(dt)
    pos = torch.arange(m, dtype=torch.int32, device=cuda)
    if r % 8 == 0:
        glist = strip_panel_pivots(slab, jj0, pos, BF, jj0=jj0, r=r)[2]
    else:
        glist = torch.arange(jj0, jj0 + r, dtype=torch.int32, device=cuda)
    k = rowblock_assemble(slab, glist, jj0)
    p = rowblock_assemble_plain(slab, glist, jj0)
    c1 = jj0 + r
    assert torch.equal(k[0][:, :c1], p[0][:, :c1])
    lu8 = getf2_npv_inv_block(slab[glist.long(), jj0:c1].float().contiguous())[0]
    assert torch.equal(k[0][:, jj0:c1], lu8.to(dt))
    if dt == torch.float32:
        for x, y in ((k[0][:, c1:], p[0][:, c1:]), (k[1], p[1])):
            assert float((x - y).abs().max() / y.abs().max()) <= 1e-5
    else:
        staged = slab[glist.long()].float()
        lu_f, linv_f, uinv_f, _ = getf2_npv_inv_plain(staged[:, jj0:c1])
        assert within_bf16_ulp(k[0][:, c1:], p[0][:, c1:],
                               sum_slack(staged.new_zeros(()), linv_f.to(BF), staged[:, c1:]))
        assert within_bf16_ulp(k[1], p[1], tri_inv_slack(uinv_f, torch.triu(lu_f)))
    assert int(k[2]) == int(p[2]) == 0
    slab[glist[1].long(), jj0:c1] = slab[glist[0].long(), jj0:c1]
    kz, pz = rowblock_assemble(slab, glist, jj0), rowblock_assemble_plain(slab, glist, jj0)
    assert int(kz[2]) == int(pz[2]) == (2 if r > 1 else 0)
    assert torch.equal(kz[0][:, :c1], pz[0][:, :c1])


def _earlier_rows_a_block(r, tsize):
    """The most rows a block of kernel 1 has always taken for a panel of r
    columns of ``tsize``-byte entries on the H100: rpb (r tsize + 68)
    bytes of dynamic shared memory beside 9,772 static bytes, under the
    232,448-byte opt-in limit."""
    return (232448 - 9776) // (r * tsize + 68)


@pytest.mark.parametrize("r,pdt,sdt", [(64, BF, BF), (64, BF, torch.float32), (32, BF, BF),
                                       (8, BF, BF), (8, torch.float32, torch.float32),
                                       (16, torch.float32, torch.float32)],
                         ids=["r64-bf16", "r64-bf16-fp32slab", "r32-bf16", "r8-bf16",
                              "r8-fp32", "r16-fp32"])
def test_strip_pivots_largest_accepted_rows(cuda, r, pdt, sdt):
    """Kernel 1 at the largest m its shared-memory layout has always
    accepted for small panels (one block an SM, more than three rows a
    thread: the rows past the registers' keep their strips in shared
    memory), with dead rows, shuffled positions and off > 0, quant16 and
    exact: piv, pos and glist exact against the plain version."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    m = sms * _earlier_rows_a_block(r, 2 if pdt == BF else 4)
    gen = torch.Generator(device=cuda).manual_seed(r)
    slab = ((torch.rand((m, 2 * r), generator=gen, device=cuda) * 2 - 1) * 4).to(sdt)
    pos = _dead_and_shuffled(m, r + 1, 0.1, cuda)
    for q16 in ((True, False) if pdt == BF else (False,)):
        got = strip_panel_pivots(slab, 64, pos, pdt, jj0=r, r=r, quant16=q16)
        ref = strip_panel_pivots_plain(slab, 64, pos, pdt, jj0=r, r=r, quant16=q16)
        for x, y in zip(got, ref):
            assert torch.equal(x, y)


def test_panel_kernels_on_two_streams(cuda):
    """Kernels 1 and 2 launched on two streams at once, over and over: each
    stream has its own scratch (grid barrier counter, keys and records;
    L^{-1} and U), so kernel 1's pivots equal the plain version's and
    kernel 2's outputs equal its run alone bit for bit, its diagonal LU
    also the plain version's."""
    m, r = 16384, 128
    slabs = [torch.from_numpy(matgen.random_dense(m, seed=s)[:, :512].copy()).to(cuda)
             for s in (21, 22)]
    pos = torch.arange(m, dtype=torch.int32, device=cuda)
    k1_ref = [strip_panel_pivots_plain(s, 0, pos, BF, r=r) for s in slabs]
    k2_alone = [rowblock_assemble(s, ref[2], 0) for s, ref in zip(slabs, k1_ref)]
    k2_plain = [rowblock_assemble_plain(s, ref[2], 0) for s, ref in zip(slabs, k1_ref)]
    streams = [torch.cuda.Stream() for _ in slabs]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    outs = [[], []]
    for _ in range(8):
        for i, st in enumerate(streams):
            with torch.cuda.stream(st):
                k1 = strip_panel_pivots(slabs[i], 0, pos, BF, r=r)
                outs[i].append((k1, rowblock_assemble(slabs[i], k1[2], 0)))
    torch.cuda.synchronize()
    for i in range(2):
        for k1, k2 in outs[i]:
            assert all(torch.equal(x, y) for x, y in zip(k1, k1_ref[i]))
            assert all(torch.equal(x, y) for x, y in zip(k2, k2_alone[i]))
            assert torch.equal(k2[0][:, :r], k2_plain[i][0][:, :r])
