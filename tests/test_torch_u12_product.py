"""U12 = L11^{-1} A12 under bf16 storage (``ops.blas3.u12_product``, kernel
17 on the card) on the CPU: the block-column loop sends the trailing
update's U12 through it exactly when the storage is bf16, its plain version
is the IEEE fp32 product of the bf16 operands rounded once, and
factorizations are bitwise what the ``matmul_in`` route gives."""

import numpy as np
import pytest
import torch

import mpf_tpu_torch as T
import mpf_tpu_torch.models.mpf as TM
from mpf_tpu_torch.ops import _lib
from mpf_tpu_torch.ops.blas3 import (
    matmul_in, u12_product, u12_product_plain, unit_lower_inv_blocked)
from mpf_tpu_torch.utils import matgen

BF = torch.bfloat16
N, BLOCK = 384, 128


def _matmul_in_route(linv, a12):
    """U12 on the ``matmul_in`` route (IEEE fp32 products, then the cast),
    for any storage dtype."""
    return matmul_in(linv, a12, a12.dtype).to(a12.dtype)


def _hpl(n=N, seed=3):
    return torch.from_numpy(matgen.hpl_ai_matrix(n, seed=seed).astype(np.float32))


def _updates(n, block):
    """Block columns whose trailing update has columns right of them."""
    return sum(1 for k in range(0, n, block) if k + block < n)


# (variant, mpf_factorize arguments, U12 products of an N x N factorization):
# the lookahead loop's narrow part in every block column but the last and
# its wide part in every one but the last two
VARIANTS = [
    ("classic", dict(r=32, block=BLOCK), _updates(N, BLOCK)),
    ("masked", dict(r=48, block=BLOCK), _updates(N, BLOCK)),
    ("lookahead", dict(r=32, block=BLOCK, lookahead=True), 2 * (N // BLOCK) - 3),
    ("deferred", dict(r=32, block=BLOCK, defer=2), _updates(N, BLOCK)),
]


@pytest.mark.parametrize("variant,kwargs,want", VARIANTS, ids=[v[0] for v in VARIANTS])
def test_bf16_storage_takes_u12_product(variant, kwargs, want):
    """ALL_BF16: every trailing update's U12 (and the lookahead's wide part)
    goes through u12_product's plain version on CPU tensors, once each;
    no kernel launches."""
    _lib.reset_counts()
    res = T.mpf_factorize(_hpl(), policy=T.ALL_BF16, **kwargs)
    assert res.lu.dtype == BF and int(res.info) == 0
    assert _lib.plain_calls["u12_product"] == want, variant
    assert not any(_lib.launches.values())


@pytest.mark.parametrize("policy", ["MPF_BF16", "MPF_FP16", "MPF_REF", "PURE_FP32"])
def test_fp32_storage_never_takes_u12_product(policy):
    """fp32 storage keeps the IEEE fp32 product: u12_product is never
    called, on the fused path or the masked one (MPF_FP16)."""
    _lib.reset_counts()
    res = T.mpf_factorize(_hpl(), r=32, block=BLOCK, policy=getattr(T, policy))
    assert res.lu.dtype == torch.float32 and int(res.info) == 0
    assert _lib.plain_calls["u12_product"] == 0 and _lib.launches["u12_product"] == 0


@pytest.mark.parametrize("kw,w", [(250, 700), (128, 64), (384, 1000)])
def test_plain_is_the_matmul_in_product(kw, w):
    """The plain version is bitwise ``matmul_in(linv, a12, bf16)`` rounded
    to bf16, on a strided view of a wider matrix with ragged kw and w and a
    blocked inverse as linv; a new row-major tensor, the matrix untouched."""
    g = torch.Generator().manual_seed(kw + w)
    l11 = ((torch.rand((kw, kw), generator=g) - 0.5) * 0.5).to(BF)
    linv = unit_lower_inv_blocked(l11, base=128)
    a = (torch.rand((kw + 40, w + 300), generator=g) - 0.5).to(BF)
    before = a.clone()
    a12 = a[17:17 + kw, 123:123 + w]
    _lib.reset_counts()
    got = u12_product(linv, a12)
    assert _lib.plain_calls["u12_product"] == 1
    assert got.dtype == BF and got.shape == (kw, w) and got.is_contiguous()
    assert torch.equal(got, matmul_in(linv, a12, BF).to(BF))
    assert torch.equal(got, u12_product_plain(linv, a12))
    assert torch.equal(a, before)


def test_u12_route_follows_the_storage_dtype():
    """``_u12`` on bf16 operands is u12_product; on fp32 operands the IEEE
    fp32 product, never u12_product."""
    g = torch.Generator().manual_seed(7)
    linv = torch.tril(torch.rand((96, 96), generator=g) - 0.5, -1) + torch.eye(96)
    a12 = torch.rand((96, 200), generator=g) - 0.5
    _lib.reset_counts()
    f = TM._u12(linv, a12)
    assert f.dtype == torch.float32 and _lib.plain_calls["u12_product"] == 0
    assert torch.equal(f, matmul_in(linv, a12, torch.float32))
    b = TM._u12(linv.to(BF), a12.to(BF))
    assert b.dtype == BF and _lib.plain_calls["u12_product"] == 1
    assert torch.equal(b, matmul_in(linv, a12, BF).to(BF))


@pytest.mark.parametrize("variant,kwargs", [(v[0], v[1]) for v in VARIANTS],
                         ids=[v[0] for v in VARIANTS])
@pytest.mark.parametrize("policy", ["ALL_BF16", "MPF_BF16"])
def test_factorization_bitwise_the_matmul_in_route(policy, variant, kwargs, monkeypatch):
    """On the CPU a factorization is bit for bit the one whose U12 takes
    the ``matmul_in`` route inline: factors, pivots, row map and info."""
    a = _hpl(seed=11)
    res = T.mpf_factorize(a, policy=getattr(T, policy), **kwargs)
    monkeypatch.setattr(TM, "_u12", _matmul_in_route)
    ref = T.mpf_factorize(a, policy=getattr(T, policy), **kwargs)
    assert torch.equal(res.lu, ref.lu), variant
    assert torch.equal(res.ipiv, ref.ipiv) and torch.equal(res.perm, ref.perm)
    assert int(res.info) == int(ref.info)
