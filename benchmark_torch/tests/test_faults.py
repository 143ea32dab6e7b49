"""A run with the timed path broken underneath comes out not correct.

The run skips only the look for a card (``run_cell`` on the CPU at a tiny
size); the limits are set ten times above what sound runs read there.  The
faults a one-chip factorization cell can have: a step that returns its
state unchanged, and an answer altered where it is produced (a tile of the
trailing update, one pivot).  It has no batch and no exchange between
chips; their nearest kin are checked where the cell can see them: half of
the rows left out of every trailing update, and the row exchange between
block columns left out.  On HPL matrices no row moves at this size, so the
exchange is not a fault there, and under ALL_BF16 the trailing update of
HPL's diagonally dominant matrix lies below bf16's resolution, so half of
it lost reads as rounding: ALL_BF16's lost update is the uniform cell's to
catch."""

import pytest
import torch

import mpf_tpu_torch.models.mpf as mpf_loop
from benchmark_torch import readings, run
from benchmark_torch.reference import Answer
from benchmark_torch.tests.conftest import CELLS, tiny

SEED = 2 ** 31 + 99


def _unchanged(a):
    n = a.shape[0]
    return Answer(lu=a, ipiv=torch.arange(1, n + 1, dtype=torch.int32),
                  info=torch.zeros((), dtype=torch.int32),
                  perm=torch.arange(n, dtype=torch.int32))


def _half_rows(orig):
    def sub(a, l21, u12, ko, ncols=None):
        return orig(a, l21[: l21.shape[0] // 2], u12, ko, ncols=ncols)
    return sub


def _no_exchange(a, k, bc, stage, combined):
    return None


def _altered_update(orig):
    def sub(a, l21, u12, ko, ncols=None):
        out = orig(a, l21, u12, ko, ncols=ncols)
        a[ko:ko + 8, ko:ko + 8] *= -1.0  # one tile of the update written with its sign flipped
        return out
    return sub


def _altered_pivot(fac):
    def run_it(a):
        res = fac(a)
        n = res.ipiv.shape[0]
        res.ipiv[n // 2] = n  # one pivot names another row
        return res
    return run_it


@pytest.fixture(scope="module")
def limits():
    """Ten times the worst that sound tiny runs read, per cell."""
    out = {}
    for name in CELLS:
        cell = tiny(name, {"nbe": 1.0, "max_err": 1e9, "info": 0, "perm_diff": 0})
        got = readings.read(cell, [SEED, SEED + 1], 0.2, False, device="cpu",
                            out=lambda _: None)
        out[name] = {"nbe": 10 * max(got["nbe"]), "max_err": 10 * max(got["max_err"]),
                     "info": 0, "perm_diff": 0}
    return out


FAULTS = ["unchanged", "altered_update", "altered_pivot", "half_rows", "no_exchange", "none"]
CASES = [(name, fault) for name in CELLS for fault in FAULTS
         if not (fault == "no_exchange" and name.endswith(".hpl"))
         and not (fault == "half_rows" and name == "all_bf16_n65536.hpl")]


@pytest.mark.parametrize("name, fault", CASES)
def test_broken_path_is_not_correct(name, fault, limits, monkeypatch):
    cell = tiny(name, limits[name])
    fac = None
    if fault == "unchanged":
        fac = _unchanged
    elif fault == "half_rows":
        monkeypatch.setattr(mpf_loop, "trailing_gemm_sub",
                            _half_rows(mpf_loop.trailing_gemm_sub))
    elif fault == "no_exchange":
        monkeypatch.setattr(mpf_loop, "_exchange", _no_exchange)
    elif fault == "altered_update":
        monkeypatch.setattr(mpf_loop, "trailing_gemm_sub",
                            _altered_update(mpf_loop.trailing_gemm_sub))
    elif fault == "altered_pivot":
        fac = _altered_pivot(run.program_factorizer(cell.config))
    # make_mpf caches its factorizers; each case builds its own
    mpf_loop._make_mpf.cache_clear()
    result, _ = run.run_cell(cell, SEED + 2, 0.2, False, device="cpu", factorizer=fac,
                             out=lambda _: None)
    mpf_loop._make_mpf.cache_clear()
    assert result["correct"] is (fault == "none"), result["checks"]
