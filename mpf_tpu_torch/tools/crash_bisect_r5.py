"""Port of tools/tpu_crash_bisect_r5.py: single-shot bf16 products along
each axis from (1024, 1024, 1024), on the card.

The TPU tool bisected the shapes at which its compile helper crashed.  On the
card the question is whether the port's tiled ``mma.sync`` routine
(``gemm::tile_mma``, kernel 3's bf16-operand update) holds its rate
across these shapes: ``out (s, w) = bf16(A @ B)``, fp32 sums, through
``mpf_probe_dot`` (tile_mma with its store epilogue).  Each leg is checked
finite, as the tool checks it, and within one bf16 ulp plus
``utils/oracle.sum_slack`` of the plain version (an IEEE sum of the same
exact products in another order).

Usage: python -m mpf_tpu_torch.tools.crash_bisect_r5 [w|s|k|all] [--device cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from mpf_tpu_torch.ops import _lib
from mpf_tpu_torch.ops.blas3 import ieee_fp32
from mpf_tpu_torch.tools import device, errors, finish, leg, parser, rate, time_ms
from mpf_tpu_torch.utils.oracle import sum_slack, within_bf16_ulp

BASE = (1024, 1024, 1024)
LEGS = {
    "w": [(1024, 1024, w) for w in (1280, 1536, 1792, 2048)],
    "s": [(s, 1024, 1024) for s in (1536, 2048, 3072, 4096)],
    "k": [(1024, k, 1024) for k in (2048, 4096)],
}
BF = torch.bfloat16


def _check(a, b):
    _lib.check(a.dim() == 2 and b.dim() == 2 and a.shape[1] == b.shape[0]
               and a.dtype == BF and b.dtype == BF, "dot: bf16 A (s, k) and B (k, w)")


def dot_plain(a, b):
    """Plain version of :func:`dot`: an IEEE fp32 product, one rounding."""
    _lib.counted_plain("probe_dot")
    _check(a, b)
    with ieee_fp32():
        return (a.float() @ b.float()).to(BF)


def dot(a, b):
    """``bf16(A @ B)`` for bf16 A (s, k) and B (k, w), fp32 sums.  CPU
    tensors take the plain version; CUDA tensors launch ``mpf_probe_dot``
    (the tensor cores)."""
    _check(a, b)
    if not _lib.on_cuda(a, b):
        return dot_plain(a, b)
    a, b = a.contiguous(), b.contiguous()
    (s, k), w = a.shape, b.shape[1]
    out = torch.empty((s, w), dtype=BF, device=a.device)
    _lib.call("mpf_probe_dot", s, w, k, a.data_ptr(), k, b.data_ptr(), w, out.data_ptr(), w)
    _lib.counted_launch("probe_dot")
    return out


def dot_close(got, ref, a, b) -> bool:
    """Within one bf16 ulp plus sum_slack of the plain version."""
    zero = torch.zeros((), device=a.device)
    return within_bf16_ulp(got, ref, sum_slack(zero, a, b)).ok


def try_dot(dev, s: int, k: int, w: int) -> dict:
    """One leg on the tool's inputs (``default_rng(0)`` a leg)."""
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((s, k)).astype(np.float32)).to(dev).to(BF)
    b = torch.from_numpy(rng.standard_normal((k, w)).astype(np.float32)).to(dev).to(BF)
    got, ref = dot(a, b), dot_plain(a, b)
    finite = bool(torch.isfinite(got).all())
    close = dot_close(got, ref, a, b)
    ms = time_ms(lambda: dot(a, b), dev, iters=5)
    pms = time_ms(lambda: dot_plain(a, b), dev, iters=1, warmup=0)
    lib = time_ms(lambda: torch.matmul(a, b), dev)
    flops = 2.0 * s * k * w
    tf = rate(ms, lambda t: flops / t / 1e12, "TF/s")
    return leg("probe_dot", f"dot s={s:5d} k={k:5d} w={w:5d} bfloat16", finite and close,
               f"finite={finite} within_ulp_and_sum_order={close} {tf}", ms=ms, plain_ms=pms,
               library=lib, **errors(got, ref),
               nbytes=(s * k + k * w + s * w) * 2, bf16_ops=flops, shape=[s, k, w])


def run(dev, axis: str = "all", base=BASE, legs=LEGS) -> list:
    """The base shape, then every leg of each axis (the tool stops an axis
    at its first failure to protect its worker; here a failure is a fault
    and every leg runs)."""
    res = [try_dot(dev, *base)]
    for ax in (("w", "s", "k") if axis == "all" else (axis,)):
        res += [try_dot(dev, s, k, w) for s, k, w in legs[ax]]
    return res


def main(argv=None) -> int:
    p = parser(__doc__)
    p.add_argument("axis", nargs="?", default="all", choices=("w", "s", "k", "all"))
    args = p.parse_args(argv)
    dev = device(args.device)
    print(f"device={dev}", flush=True)
    return finish(run(dev, args.axis))


if __name__ == "__main__":
    sys.exit(main())
