"""The one generator of every traffic mix: dense test matrices made on the device.

A traffic file (``traffic/<name>.json``) gives the matrix class and the loop:

* ``low``, ``high``: entries uniform in [low, high) (fp32 values of a
  ``torch.Generator``, scaled as ``low + (high - low) u``);
* ``diag_shift_per_n``: ``diag_shift_per_n * n`` is added to the diagonal
  (HPL-MxP's diagonally dominant class takes 1/4);
* ``pool``: how many matrices the caller factors in turn;
* ``callers``: callers in the closed loop (each waits for its answer).

Each value is computed in fp32 and cast to the configuration's storage
dtype once.  A copy of `mpf_tpu_torch/utils/matgen.py:_device_uniform`
(``hpl_ai_matrix_device``, ``random_dense_device``): rows are made in
chunks of 2^26 fp32 values, so the peak is the matrix plus one chunk, and
the same (seed, index) gives the same matrix on every run.
"""

from __future__ import annotations

import hashlib

import torch

#: fp32 values per generation chunk (256 MB)
CHUNK_ELEMS = 1 << 26

KEYS = {"low", "high", "diag_shift_per_n", "pool", "callers", "why"}


def check(traffic: dict) -> None:
    """Refuse a traffic file this generator cannot read."""
    missing = KEYS - set(traffic)
    if missing:
        raise ValueError(f"traffic file lacks {sorted(missing)}")
    if not traffic["high"] > traffic["low"]:
        raise ValueError("traffic: high must exceed low")
    if traffic["pool"] < 1 or traffic["callers"] != 1:
        raise ValueError("traffic: pool >= 1 and one caller (the closed loop)")


def matrix_seed(seed: int, index: int) -> int:
    """A 63-bit generator seed for matrix ``index`` of run seed ``seed``
    (any whole number, negative or beyond 64 bits included)."""
    digest = hashlib.sha256(f"mpf-bench:{seed}:{index}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def make_matrix(n: int, traffic: dict, seed: int, index: int, dtype, device) -> torch.Tensor:
    """Matrix ``index`` of the pool of run seed ``seed``: (n, n) of
    ``dtype`` on ``device``."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(matrix_seed(seed, index))
    low, span = float(traffic["low"]), float(traffic["high"]) - float(traffic["low"])
    shift = float(traffic["diag_shift_per_n"]) * n
    out = torch.empty((n, n), dtype=dtype, device=dev)
    chunk = max(1, CHUNK_ELEMS // n)
    for r0 in range(0, n, chunk):
        x = torch.rand((min(chunk, n - r0), n), generator=gen, dtype=torch.float32, device=dev)
        if span != 1.0:
            x.mul_(span)
        if low != 0.0:
            x.add_(low)
        if shift:
            x.diagonal(r0).add_(shift)
        out[r0:r0 + x.shape[0]] = x
    return out
