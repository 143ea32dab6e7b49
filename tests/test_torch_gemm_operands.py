"""Operand preparation of the bf16 trailing-GEMM wrappers (kernels 6 and 13,
``mpf_tpu_torch.ops._lib.gemm_operand``): an operand that TMA can read in
place passes through untouched; any other bf16 operand becomes a new
zero-padded ``(rows, ceil8(cols))`` buffer, counted; fp32 operands are
never touched, and the wrappers copy nothing for CPU tensors (they take
the plain versions)."""

import pytest
import torch

from mpf_tpu_torch.ops import _lib, panel_fused
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



# Kernel 6's C instance (``panel_fused.trailing_staged``): bf16 C goes
# through shared memory when TMA can read and write it in place, a 16-byte
# base, row stride and width; any other C stays in registers.  (matrix, e,
# width of the update, want): the C of ``a[e:e + w, e:e + w]``.
_C_CASES = {
    "all_bf16_trailing_block": (lambda: _mat(2048, 2048), 1024, 1024, True),
    "offset_8_elements": (lambda: _mat(512, 512), 8, 296, True),
    "row_stride_1000": (lambda: _mat(1000, 1000), 104, 704, True),
    "odd_offset": (lambda: _mat(512, 512), 1, 300, False),
    "offset_4_elements": (lambda: _mat(512, 512), 4, 300, False),
    "odd_row_stride": (lambda: _mat(1001, 1001), 101, 700, False),
    "width_not_16_bytes": (lambda: _mat(1024, 1024), 104, 900, False),
    "fp32_c": (lambda: _mat(2048, 2048, torch.float32), 1024, 1024, False),
}


@pytest.mark.parametrize("case", list(_C_CASES), ids=list(_C_CASES))
def test_trailing_staged_predicate(case):
    make, e, w, want = _C_CASES[case]
    a = make()
    c = a[e:e + w, e:e + w]
    assert panel_fused.trailing_staged(c) is want
    if c.dtype == BF:
        assert want == (_lib.tma_ready(c) and (c.shape[1] * 2) % 16 == 0)


@pytest.mark.parametrize("case", list(_C_CASES), ids=list(_C_CASES))
def test_kernel6_instance_follows_c(case, monkeypatch):
    """The wrapper's CUDA branch with the C call captured: the ``c_mode`` it
    passes is the predicate's decision (2 through shared memory, 1 bf16 C
    in registers, 0 fp32 C), one launch counted under that instance."""
    make, e, w, want = _C_CASES[case]
    a = make()
    calls = []
    monkeypatch.setattr(_lib, "on_cuda", lambda *t: True)
    monkeypatch.setattr(_lib, "call", lambda name, *args: calls.append((name, args)))
    l21 = _mat(w, 64, seed=7)
    u12 = _mat(64, w, seed=8)
    trailing_gemm_sub(a, l21, u12, e, ncols=w)
    (name, args), = calls
    c = a[e:e + w, e:e + w]
    assert name == "mpf_trailing_sub" and args[0] == 0 and args[1:4] == (w, w, 64)
    assert args[8] == c.data_ptr() and args[10] == a.stride(0)
    assert args[9] == (2 if want else 1 if a.dtype == BF else 0)
    inst = "staged" if want else "registers"
    assert _lib.trailing_instances == {"staged": 0, "registers": 0, "ffma": 0, inst: 1}
    assert _lib.launches["trailing_sub"] == 1
