"""Shared helpers of the benchmark's CPU tests: each cell cut to a tiny size
that the plain PyTorch versions of the program's kernels run in a second."""

import dataclasses

import pytest
import torch

from benchmark_torch import spec

CELLS = ("mpf_bf16_n16384.hpl", "all_bf16_n65536.hpl", "mpf_bf16_n16384.uniform",
         "all_bf16_n65536.uniform")


@pytest.fixture(autouse=True)
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def tiny(name: str, limits: dict | None = None, n: int = 256):
    """Cell ``name`` at order ``n``, block 128, panels of 32, one traced
    factorization; ``limits`` replaces the cell's (set at its real size)."""
    cell = spec.cell(spec.load(), name)
    conf = dict(cell.config, n=n, trace_factorizations=1,
                make_mpf=dict(cell.config["make_mpf"], block=128, r=32))
    lim = dict(cell.limits, limits=limits) if limits is not None else cell.limits
    return dataclasses.replace(cell, config=conf, limits=lim)
