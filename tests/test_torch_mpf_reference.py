"""MPF_FP16 through the port's normal path (``make_mpf``, masked in every
block column: the plain versions of kernels 5-9 on the CPU) held to the
plain MPF reference of the benchmark, ``benchmark_torch/reference_mpf.py:
mpf_plain`` (fp16 pre-pivot search with the source's saturating cast, an
fp32 no-pivot refactor, triangular solves and fp32 updates), at n in {256,
384}, r = 32, block = 128, on matrices of the benchmark's own generator
with fixed seeds.

* HPL-MxP's diagonally dominant class: ``ipiv`` and ``perm`` equal.
* U[0, 9.9] (the reference corpus): ``ipiv`` equal up to the first
  divergence stated in :data:`FIRST_DIVERGENCE`.  The port forms L21 and
  U12 as products with the diagonal block's inverses (the JAX package's
  ``use_inv``), the reference by triangular solves (the source's
  ``cublasDtrsm``), and sums in another order, so the fp32 working values
  part in their last bits; a later panel's fp16 cast can then round two
  near-equal candidates apart.  Where the pivots first part, the
  reference's search run on the port's own cast panel gives the port's
  pivots: the search agrees, its input does not.
* A matrix whose panels hold entries above fp16's largest finite value or
  below its smallest normal: the saturating cast turns two entries past
  65504 into a tie, which goes to the lower row, and flushes a column of
  entries below 6.1e-5 to zero, where the search then keeps the diagonal
  row.  There ``ipiv`` equals the reference's exactly, and at column 0,
  where both see the same matrix, it differs from an unsaturated fp32
  search's choice: the test sees the mechanism.
* The backward error ||L U - A[perm]||_F / (n ||A||_F): the port's within
  :data:`NBE_FACTOR` of the reference's, and the port with bf16 trailing
  operands (MPF_BF16's, the stated fp32 one step lower) outside it.

Runs on one torch thread, as ``test_torch_hgetf2_order.py`` does."""

import dataclasses
import functools

import pytest
import torch

import mpf_tpu_torch as T
from benchmark_torch import reference, traffic
from benchmark_torch import reference_mpf as RM
from mpf_tpu_torch.models import mpf as TM

R, BLOCK, SEED = 32, 128, 1000
SIZES = (256, 384)
HPL = {"low": -0.5, "high": 0.5, "diag_shift_per_n": 0.25, "pool": 2, "callers": 1, "why": "t"}
UNIFORM = {"low": 0.0, "high": 9.9, "diag_shift_per_n": 0.0, "pool": 2, "callers": 1,
           "why": "t"}
#: first index where the port's ipiv parts from the reference's on U[0, 9.9]
#: (seed 1000), None where they never part; measured, and held exactly so
#: that a change that moves it fails
FIRST_DIVERGENCE = {256: None, 384: 57}
#: the port's nbe over the reference's, either way: the inverse products
#: read 2.13-2.55x on U[0, 9.9] at these sizes (1.02-1.23x with the
#: reference's solves replaced by the same inverse products) and
#: 0.998-0.999x on HPL, and 5.58-5.79x at n = 16384 on an H100 (the
#: products' error grows with n); bf16 trailing operands read 30000x and
#: 40-48x here, 23000x at n = 16384.  8 leaves 1.4x of room above the
#: card's reading and fails bf16 operands by 5x.
NBE_FACTOR = 8.0
#: MPF_FP16 with MPF_BF16's trailing operands
BF16_OPERANDS = dataclasses.replace(T.MPF_FP16, name="mpf_fp16_bf16_operands",
                                    gemm_in=torch.bfloat16)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch CPU thread: the column loops issue thousands of small
    ops, between which idle OpenMP workers would spin on shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _saturating(kind: str, n: int) -> torch.Tensor:
    """U[0, 9.9] with, at the first column of every panel, 7e4 and 9e4 in
    rows 3 and 9 below the diagonal (both past fp16's 65504: a tie once
    saturated; fp32 takes the 9e4).  ``below_normal`` replaces the first
    panel's pair by row 0 and column 0 drawn from [3e-5, 5e-5), below fp16's
    smallest normal: flushed, the column reads zero throughout and the
    diagonal row is kept (fp32 takes the largest; row 0 small too, so that
    U11 stays well scaled)."""
    seed = {"above_max": 5, "below_normal": 7}[kind]
    a = traffic.make_matrix(n, UNIFORM, seed, 0, torch.float32, "cpu")
    first = 0
    if kind == "below_normal":
        g = torch.Generator().manual_seed(seed)
        a[:, 0] = 3e-5 + 2e-5 * torch.rand(n, generator=g)
        a[0, :] = 3e-5 + 2e-5 * torch.rand(n, generator=g)
        first = R
    for j0 in range(first, n - R, R):
        a[j0 + 3, j0] = 7.0e4
        a[j0 + 9, j0] = 9.0e4
    return a


def _matrix(mix: str, n: int) -> torch.Tensor:
    if mix in ("hpl", "uniform"):
        return traffic.make_matrix(n, HPL if mix == "hpl" else UNIFORM, SEED, 0,
                                   torch.float32, "cpu")
    return _saturating(mix, n)


def _port(a: torch.Tensor, policy=T.MPF_FP16):
    fac = T.make_mpf(a.shape[0], r=R, policy=policy, block=BLOCK)
    return fac(a.clone())


@functools.lru_cache(maxsize=None)
def _pair(mix: str, n: int):
    """``(matrix, port's answer, reference's answer)``."""
    a = _matrix(mix, n)
    return a, _port(a), RM.mpf_plain(a, R, BLOCK)


def _first_divergence(x: torch.Tensor, y: torch.Tensor):
    d = (x != y).nonzero()
    return int(d[0]) if len(d) else None


@pytest.mark.parametrize("n", SIZES)
def test_hpl_pivots_equal(n):
    _, port, ref = _pair("hpl", n)
    assert torch.equal(port.ipiv, ref.ipiv)
    assert torch.equal(port.perm, ref.perm)
    assert int(port.info) == int(ref.info) == 0


@pytest.mark.parametrize("n", SIZES)
def test_uniform_pivots_to_first_divergence(n, monkeypatch):
    _, port, ref = _pair("uniform", n)
    first = _first_divergence(port.ipiv, ref.ipiv)
    assert first == FIRST_DIVERGENCE[n]
    assert int(port.info) == int(ref.info) == 0
    if first is None:
        assert torch.equal(port.perm, ref.perm)
        return
    # the port's cast panel where the pivots part, as kernel 7's plain
    # version receives it, and the reference's search on it
    j0 = first - first % R
    seen = {}
    orig = TM.hgetf2_panel_swaps

    def capture(panel, row_offset, prev_perm, panel_dtype=None):
        if row_offset == j0:
            seen["panel"] = panel[j0:].clone()
        return orig(panel, row_offset, prev_perm, panel_dtype=panel_dtype)

    monkeypatch.setattr(TM, "hgetf2_panel_swaps", capture)
    again = _port(_matrix("uniform", n))
    assert torch.equal(again.ipiv, port.ipiv)
    assert seen["panel"].dtype == torch.float16
    piv = RM.prepivot(seen["panel"].float(), torch.float16, True)
    assert [j0 + p + 1 for p in piv] == port.ipiv[j0:j0 + R].tolist()


@pytest.mark.parametrize("kind", ["above_max", "below_normal"])
@pytest.mark.parametrize("n", SIZES)
def test_saturation_decides_the_pivots(kind, n):
    a, port, ref = _pair(kind, n)
    assert torch.equal(port.ipiv, ref.ipiv)
    assert torch.equal(port.perm, ref.perm)
    assert int(port.info) == int(ref.info) == 0
    # column 0: the tie goes to row 3, the flushed column keeps row 0
    assert int(ref.ipiv[0]) - 1 == (3 if kind == "above_max" else 0)
    fp32 = RM.mpf_plain(a, R, BLOCK, panel="float32", saturate=False)
    assert int(fp32.ipiv[0]) != int(ref.ipiv[0])


@pytest.mark.parametrize("mix", ["hpl", "uniform"])
@pytest.mark.parametrize("n", SIZES)
def test_backward_error_within_factor(mix, n):
    a, port, ref = _pair(mix, n)
    nbe_ref = reference.residual(a, ref.lu, ref.perm)[0]
    nbe_port = reference.residual(a, port.lu, port.perm)[0]
    assert nbe_ref / NBE_FACTOR <= nbe_port <= NBE_FACTOR * nbe_ref
    bf16 = _port(a, BF16_OPERANDS)
    assert reference.residual(a, bf16.lu, bf16.perm)[0] > NBE_FACTOR * nbe_ref
