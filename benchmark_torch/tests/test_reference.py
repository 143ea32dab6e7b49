"""The plain reference: the tiled fp64 residual against a dense rebuild,
the plain LU, the composition of ipiv, and the traffic generator."""

import pytest
import torch

from benchmark_torch import reference, traffic

HPL = {"low": -0.5, "high": 0.5, "diag_shift_per_n": 0.25, "pool": 2, "callers": 1, "why": "t"}
UNIFORM = {"low": 0.0, "high": 9.9, "diag_shift_per_n": 0.0, "pool": 2, "callers": 1, "why": "t"}


def _dense(a, lu, perm):
    n = lu.shape[0]
    l = torch.tril(lu.double(), -1) + torch.eye(n, dtype=torch.float64)
    d = l @ torch.triu(lu.double()) - a.double()[perm.long()]
    return float(d.norm() / (n * a.double().norm())), float(d.abs().max() / a.abs().max())


@pytest.mark.parametrize("rows, cols", [(64, 96), (100, 300), (4096, None)])
@pytest.mark.parametrize("store, operands", [("float32", "bfloat16"), ("bfloat16", None)])
def test_residual_matches_dense_rebuild(rows, cols, store, operands):
    a = traffic.make_matrix(300, UNIFORM, 7, 0, torch.float32, "cpu")
    ans = reference.lu_plain(a, 64, store, operands)
    got = reference.residual(a, ans.lu, ans.perm, rows=rows, cols=cols)
    assert got == pytest.approx(_dense(a, ans.lu, ans.perm), rel=1e-9)


@pytest.mark.parametrize("mix", [HPL, UNIFORM])
def test_plain_lu_in_fp64_is_exact_to_rounding(mix):
    a = traffic.make_matrix(257, mix, 3, 1, torch.float32, "cpu")
    ans = reference.lu_plain(a, 64)
    assert reference.perm_from_ipiv(ans.ipiv) == ans.perm.tolist()
    nbe, max_err = reference.residual(a, ans.lu, ans.perm)
    assert nbe < 1e-16 and max_err < 1e-13
    assert int(ans.info) == 0


def test_lower_precision_reads_higher():
    a = traffic.make_matrix(256, UNIFORM, 5, 0, torch.float32, "cpu")
    nbe = [reference.residual(a, x.lu, x.perm)[0] for x in (
        reference.lu_plain(a, 64, "float32"),
        reference.lu_plain(a, 64, "float32", "bfloat16"),
        reference.lu_plain(a, 64, "float32", "float8_e4m3fn"))]
    assert nbe[0] * 100 < nbe[1] and nbe[1] * 5 < nbe[2]


def test_perm_from_ipiv():
    assert reference.perm_from_ipiv(torch.tensor([3, 2, 3])) == [2, 1, 0]
    with pytest.raises(ValueError):
        reference.perm_from_ipiv(torch.tensor([1, 4, 3]))
    with pytest.raises(ValueError):
        reference.perm_from_ipiv(torch.tensor([2, 1, 3]))  # a swap with a row above


def test_generator_is_seeded_and_shaped():
    big = 2 ** 31 + 987654321
    a = traffic.make_matrix(64, HPL, big, 0, torch.float32, "cpu")
    assert torch.equal(a, traffic.make_matrix(64, HPL, big, 0, torch.float32, "cpu"))
    assert not torch.equal(a, traffic.make_matrix(64, HPL, big, 1, torch.float32, "cpu"))
    assert not torch.equal(a, traffic.make_matrix(64, HPL, big + 1, 0, torch.float32, "cpu"))
    off = a - torch.diag(torch.diagonal(a))
    assert float(off.min()) >= -0.5 and float(off.max()) < 0.5
    assert float(torch.diagonal(a).min()) >= 16 - 0.5
    u = traffic.make_matrix(64, UNIFORM, -3, 0, torch.bfloat16, "cpu")
    assert u.dtype == torch.bfloat16 and 0 <= float(u.min()) and float(u.max()) <= 9.9


def test_generator_refuses_unknown_traffic():
    with pytest.raises(ValueError):
        traffic.check({"low": 0.0, "high": 1.0})
    with pytest.raises(ValueError):
        traffic.check(dict(HPL, callers=4))
