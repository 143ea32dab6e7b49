"""Operation and byte counts, published peaks, and the statistics the metrics use.

Kept apart from the program, so that a later change to the program cannot
change what it is measured against.  ``lu_flops`` is a copy of
`mpf_tpu_torch/utils/timing.py:lu_flops`.
"""

from __future__ import annotations

import math

#: NVIDIA H100 SXM data sheet, dense (no sparsity), at the 700 W limit:
#: tensor-core bf16 / fp16, fp32 outside the tensor cores, HBM3 bandwidth.
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12

DTYPE_BYTES = {"float64": 8, "float32": 4, "bfloat16": 2, "float16": 2}


def lu_flops(n: int) -> float:
    """The canonical LU operation count, 2n^3/3."""
    return 2.0 * n ** 3 / 3.0


def trailing_work(n: int, block: int, c_dtype: str, op_dtype: str) -> list:
    """(flops, bytes) of each trailing update of a blocked right-looking LU
    of order n: after block column k the (n - e) x (n - e) trailing matrix,
    e = (k + 1) block, takes C -= L21 @ U12 with K = block.  Bytes count C
    read once and written once and L21 and U12 read once; the work is
    counted from n and block, whatever kernel does it."""
    cb, ob = DTYPE_BYTES[c_dtype], DTYPE_BYTES[op_dtype]
    out = []
    for k in range(0, n, block):
        kw = min(block, n - k)
        m = n - k - kw
        if m <= 0:
            break
        out.append((2.0 * m * m * kw, 2.0 * cb * m * m + 2.0 * ob * m * kw))
    return out


def roofline_s(flops: float, nbytes: float, op_dtype: str) -> float:
    """The least time the chip could take: the larger of operations over
    the peak rate of ``op_dtype`` and bytes over the peak bandwidth."""
    return max(flops / PEAK_FLOPS[op_dtype], nbytes / PEAK_BYTES_PER_S)


def trailing_bound_s(n: int, block: int, c_dtype: str, op_dtype: str) -> float:
    """The trailing updates' least time over one factorization, each update
    bound by its own operations or bytes."""
    return sum(roofline_s(f, b, op_dtype) for f, b in trailing_work(n, block, c_dtype, op_dtype))


def p95(values) -> float:
    """The 95th percentile by nearest rank: the smallest sample that at
    least 95% of the samples do not exceed."""
    s = sorted(values)
    if not s:
        raise ValueError("p95 of no samples")
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


def union_length(intervals) -> float:
    """Total length covered by ``(start, end)`` intervals, overlaps counted
    once (two streams' kernels that overlap are one busy stretch)."""
    return sum(e - s for s, e in merged(intervals))


def merged(intervals) -> list:
    """The ``(start, end)`` intervals merged where they overlap, in order."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]
