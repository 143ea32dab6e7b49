"""Operand preparation of the bf16 trailing-GEMM wrappers (kernels 6 and 13,
``mpf_tpu_torch.ops._lib.gemm_operand``): an operand that TMA can read in
place passes through untouched; any other bf16 operand becomes a new
zero-padded ``(rows, ceil8(cols))`` buffer, counted; fp32 operands are
never touched, and the wrappers copy nothing for CPU tensors (they take
the plain versions)."""

import pytest
import torch

from mpf_tpu_torch.ops import _lib
from mpf_tpu_torch.ops.gemmx import gemm_trailing, gemm_trailing_plain
from mpf_tpu_torch.ops.panel_fused import trailing_gemm_sub, trailing_gemm_sub_plain

BF = torch.bfloat16


def _mat(rows, cols, dtype=BF, seed=0):
    g = torch.Generator().manual_seed(seed)
    t = torch.randn((rows, cols), generator=g).to(dtype)
    assert t.data_ptr() % 16 == 0          # a fresh allocation is aligned
    return t


@pytest.fixture(autouse=True)
def _counts():
    _lib.reset_counts()
    yield
    _lib.reset_counts()


@pytest.mark.parametrize("make", [
    lambda: _mat(1024, 1024),                       # the main path's contiguous operand
    lambda: _mat(1024, 1024)[64:, 128:256],         # ALL_BF16's L21: a view of the matrix
    lambda: _mat(72, 704),                          # 1408-byte rows
    lambda: _mat(1000, 3096)[:, :1000],             # K = 1000 of a wider matrix
    lambda: _mat(1, 8),                             # one row
], ids=["contiguous", "view", "ragged_aligned", "k1000_view", "one_row"])
def test_aligned_operand_passes_through(make):
    t = make()
    assert _lib.tma_ready(t)
    out = _lib.gemm_operand(t)
    assert out is t and out.data_ptr() == t.data_ptr()
    assert _lib.copies["gemm_operand"] == 0


@pytest.mark.parametrize("make", [
    lambda: _mat(256, 512)[:, 1:129],               # odd column offset: base 2 bytes off
    lambda: _mat(256, 512)[:, 4:68],                # base 8 bytes off
    lambda: _mat(300, 77),                          # odd width: 154-byte rows
    lambda: _mat(72, 700),                          # N = 700: 1400-byte rows
    lambda: _mat(64, 256)[:, ::2],                  # column stride 2
], ids=["odd_col_offset", "col_offset_4", "odd_width", "n700", "col_stride_2"])
def test_unaligned_operand_is_copied(make):
    t = make()
    assert not _lib.tma_ready(t)
    rows, cols = t.shape
    out = _lib.gemm_operand(t)
    assert out.dtype == BF and out.shape == (rows, -(-cols // 8) * 8)
    assert out.data_ptr() != t.data_ptr() and _lib.tma_ready(out)
    assert torch.equal(out[:, :cols], t)
    assert not out[:, cols:].any()
    assert _lib.copies["gemm_operand"] == 1


@pytest.mark.parametrize("t", [_mat(72, 701, torch.float32),
                               _mat(256, 512, torch.float32)[:, 1:129]],
                         ids=["odd_width", "odd_col_offset"])
def test_fp32_operand_never_touched(t):
    assert _lib.gemm_operand(t) is t
    assert _lib.copies["gemm_operand"] == 0


@pytest.mark.parametrize("dt", [torch.float32, BF])
def test_cpu_kernel6_copies_nothing(dt):
    """Kernel 6's wrapper on CPU tensors with unaligned bf16 operands (N =
    700, L21 at an odd column offset): the plain version, no copy."""
    a = _mat(1000, 1000, dt, seed=1)
    l21 = _mat(900, 73, seed=2)[:, 1:]
    u12 = _mat(72, 700, seed=3)
    x, y = a.clone(), a.clone()
    trailing_gemm_sub(x, l21, u12, 100, ncols=700)
    assert _lib.copies["gemm_operand"] == 0 and _lib.plain_calls["trailing_sub"] == 1
    trailing_gemm_sub_plain(y, l21, u12, 100, ncols=700)
    assert torch.equal(x, y)


def test_cpu_kernel13_copies_nothing():
    """Kernel 13's wrapper on CPU tensors with an unaligned U12: the plain
    version, no copy."""
    a = _mat(600, 600, BF, seed=4)
    l21 = _mat(500, 100, seed=5)
    u12 = _mat(100, 350, seed=6)[:, 1:]
    glist = torch.arange(100, 164, dtype=torch.int32)
    x, y = a.clone(), a.clone()
    _, px = gemm_trailing(x, l21, u12, 100, 251, xargs=(100, glist, glist))
    assert _lib.copies["gemm_operand"] == 0 and _lib.plain_calls["gemmx"] == 1
    _, py = gemm_trailing_plain(y, l21, u12, 100, 251, xargs=(100, glist, glist))
    assert torch.equal(x, y) and torch.equal(px, py)

