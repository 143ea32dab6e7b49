"""Port of tools/tpu_granule_r5.py: row read-modify-write and read-only
visits against the window granule, on the card.

On the TPU a row DMA moved a whole tiled window (16 bf16 rows); the card's
granule is a 32-byte sector, so the question here is whether 16-, 2- and
1-row windows all reach the byte rate.  Legs (E window visits a launch on an
(N / g, g, W) array, ids sorted and distinct; ``d`` is the kernels' loads in
flight a thread, which does not change the function):

  g16_dN    bf16, 16-row windows, read-modify-write (+1)    16e
  pair_dN   bf16, 2-row windows, read-modify-write          16e
  row32_dN  fp32, 1-row windows, read-modify-write          16e
  *gath_dN  bf16, read-only visits summing row i mod g of window ids[i]
            in order of i (A2's gather shape)               16f

The g16 legs have N / 16 = 1024 windows, fewer than E = 2048: the tool's
draw of E distinct windows raises there, so they visit each window once
(E = 1024).

Usage: python -m mpf_tpu_torch.tools.granule_r5 [W] [--device cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from mpf_tpu_torch.ops import _lib
from mpf_tpu_torch.tools import (
    check_ids, device, errors, finish, leg, parser, rate, time_ms)

N, W, E = 16384, 32768, 2048
R = 8  # launches whose sum the tool's check reads
BF = torch.bfloat16
DEPTHS = (1, 4, 8, 16)
LEGS = (
    ("g16_d4", "rmw", BF, 16, 4),
    ("pair_d4", "rmw", BF, 2, 4),
    ("pair_d8", "rmw", BF, 2, 8),
    ("pair_d16", "rmw", BF, 2, 16),
    ("row32_d8", "rmw", torch.float32, 1, 8),
    ("row32_d16", "rmw", torch.float32, 1, 16),
    ("g16gath_d4", "gath", BF, 16, 4),
    ("pgath_d8", "gath", BF, 2, 8),
    ("pgath_d16", "gath", BF, 2, 16),
)


def _check(a, ids, depth, name):
    _lib.check(a.dim() == 3 and a.is_contiguous() and a.dtype in (torch.float32, BF),
               f"{name}: a must be a contiguous fp32 or bf16 (nwin, g, w) array")
    _lib.check(ids.dim() == 1 and not ids.is_floating_point(), f"{name}: ids must be 1-D ints")
    _lib.check(depth in DEPTHS, f"{name}: depth must be one of {DEPTHS}")


# --------------------------------------------------------------------------
# 16e (16j runs the same kernel): window read-modify-write
# --------------------------------------------------------------------------

def rmw_plain(a, ids, counter: str = "probe_window_rmw"):
    """``a[ids] = T(f32(a[ids]) + 1)`` in place on the leading dimension of
    any array ``a`` (its windows); the plain version of :func:`window_rmw`
    and of ``refview_r5.refview_rmw``."""
    _lib.counted_plain(counter)
    check_ids(ids, a.shape[0], "window read-modify-write")
    idx = ids.long()
    a[idx] = (a[idx].float() + 1.0).to(a.dtype)
    return a


def rmw_launch(a, ids, depth: int, counter: str) -> None:
    """``mpf_probe_window_rmw`` on the contiguous array ``a``, one window a
    leading index."""
    ids = ids.to(torch.int32).contiguous()
    _lib.call("mpf_probe_window_rmw", ids.shape[0], a.shape[0], a[0].numel(), a.data_ptr(),
              ids.data_ptr(), a.element_size(), depth)
    _lib.counted_launch(counter)


def window_rmw(a, ids, depth: int = 4):
    """IN PLACE on the (nwin, g, w) fp32 or bf16 array ``a``: each window
    ``ids[i]`` (distinct) += 1 in fp32, rounded once to the element type.
    Returns ``a``.  CPU tensors take the plain version (ids outside
    [0, nwin) raise ValueError); CUDA tensors launch ``mpf_probe_window_rmw``
    with ``depth`` 16-byte loads in flight a thread (and skip such ids)."""
    _check(a, ids, depth, "window_rmw")
    if not _lib.on_cuda(a, ids):
        return rmw_plain(a, ids)
    rmw_launch(a, ids, depth, "probe_window_rmw")
    return a


# --------------------------------------------------------------------------
# 16f: read-only visits
# --------------------------------------------------------------------------

def window_gather_plain(a, ids):
    """Plain version of :func:`window_gather`."""
    _lib.counted_plain("probe_window_gather")
    check_ids(ids, a.shape[0], "window_gather")
    g = a.shape[1]
    acc = torch.zeros((1, a.shape[2]), dtype=torch.float32, device=a.device)
    for i, wid in enumerate(ids.tolist()):
        acc = acc + a[wid, i % g].float()
    return acc


def window_gather(a, ids, depth: int = 4):
    """(1, w) fp32: the sum over i, in order, of row ``i mod g`` of window
    ``ids[i]`` of the (nwin, g, w) array ``a`` (left unchanged).  CPU tensors
    take the plain version (ids outside [0, nwin) raise ValueError); CUDA
    tensors launch ``mpf_probe_window_gather``, one thread a column (such ids
    add nothing)."""
    _check(a, ids, depth, "window_gather")
    if not _lib.on_cuda(a, ids):
        return window_gather_plain(a, ids)
    ids = ids.to(torch.int32).contiguous()
    out = torch.empty((1, a.shape[2]), dtype=torch.float32, device=a.device)
    _lib.call("mpf_probe_window_gather", ids.shape[0], a.shape[0], a.shape[1], a.shape[2],
              a.data_ptr(), ids.data_ptr(), int(a.dtype == BF), depth, out.data_ptr())
    _lib.counted_launch("probe_window_gather")
    return out


# --------------------------------------------------------------------------
# the tool's legs
# --------------------------------------------------------------------------

def window_extremes(a):
    """(min, max) of each window of ``a``, as fp32."""
    flat = a.reshape(a.shape[0], -1)
    return flat.amin(1).float(), flat.amax(1).float()


def _rmw_leg(dev, name, dt, g, d, ids, nwin, w):
    # the tool's check: R launches on zeros leave R in every visited window
    # and 0 elsewhere
    a = torch.zeros((nwin, g, w), dtype=dt, device=dev)
    for _ in range(R):
        window_rmw(a, ids, d)
    lo, hi = window_extremes(a)
    want = torch.zeros(nwin, device=dev)
    want[ids.long()] = R
    tool_ok = torch.equal(lo, want) and torch.equal(hi, want)
    ms = time_ms(lambda: window_rmw(a, ids, d), dev)
    del a
    # against the plain version on random values
    x = torch.randn((nwin, g, w), generator=torch.Generator(device=dev).manual_seed(20),
                    device=dev).to(dt)
    y = x.clone()
    window_rmw(x, ids, d)
    rmw_plain(y, ids)
    same = torch.equal(x, y)
    err = errors(x, y)
    pms = time_ms(lambda: rmw_plain(y, ids), dev, iters=1, warmup=0)
    idx = ids.long()
    one = torch.ones((), dtype=dt, device=dev).expand(ids.shape[0], g, w)
    lib = time_ms(lambda: y.index_add_(0, idx, one), dev)
    del x, y
    vis = g * w * _elem(dt) * 2
    per = rate(ms, lambda s: s / ids.shape[0] * 1e9, "ns/visit")
    gbs = rate(ms, lambda s: vis * ids.shape[0] / s / 1e9, "GB/s")
    return leg("probe_window_rmw", name, tool_ok and same,
               f"{per} ({vis / 1024:.0f} KB -> {gbs}) ok={tool_ok} equals_plain={same}",
               ms=ms, plain_ms=pms, library=lib, nbytes=vis * ids.shape[0], g=g, depth=d,
               **err)


def _gath_leg(dev, name, dt, g, d, ids, nwin, w):
    # the tool's check: on ones every column sums to E
    a = torch.ones((nwin, g, w), dtype=dt, device=dev)
    tool_ok = bool((window_gather(a, ids, d) == ids.shape[0]).all())
    ms = time_ms(lambda: window_gather(a, ids, d), dev)
    del a
    x = torch.randn((nwin, g, w), generator=torch.Generator(device=dev).manual_seed(21),
                    device=dev).to(dt)
    got, ref = window_gather(x, ids, d), window_gather_plain(x, ids)
    same = torch.equal(got, ref)
    pms = time_ms(lambda: window_gather_plain(x, ids), dev, iters=1, warmup=0)
    idx, sub = ids.long(), torch.arange(ids.shape[0], device=dev) % g
    lib = time_ms(lambda: x[idx, sub].float().sum(0), dev)
    del x
    row = w * _elem(dt)
    per = rate(ms, lambda s: s / ids.shape[0] * 1e9, "ns/visit")
    gbs = rate(ms, lambda s: row * ids.shape[0] / s / 1e9, "GB/s of rows read")
    return leg("probe_window_gather", name, tool_ok and same,
               f"{per} ({row / 1024:.0f} KB row of a {g * row / 1024:.0f} KB window -> {gbs}) "
               f"ok={tool_ok} equals_plain={same}", ms=ms, plain_ms=pms, library=lib,
               nbytes=row * ids.shape[0] + w * 4, g=g, depth=d, **errors(got, ref))


def _elem(dt) -> int:
    return torch.empty((), dtype=dt).element_size()


def leg_ids(rng, nwin: int, e: int) -> np.ndarray:
    """A leg's window ids as the tool draws them: e sorted, distinct windows
    of nwin.  Where e > nwin (the tool's g16 legs: 2048 of N / 16 = 1024
    windows, a draw that raises in the tool) every window is visited once,
    in order, and the generator is left as the tool's failed draw leaves
    it."""
    if e > nwin:
        return np.arange(nwin, dtype=np.int32)
    return np.sort(rng.choice(nwin, size=e, replace=False)).astype(np.int32)


def run(dev, n: int = N, w: int = W, e: int = E, legs=LEGS) -> list:
    """The tool's legs in its order, ids drawn as it draws them
    (:func:`leg_ids`)."""
    rng = np.random.default_rng(0)
    res = []
    for name, kind, dt, g, d in legs:
        nwin = n // g
        ids = torch.from_numpy(leg_ids(rng, nwin, e)).to(dev)
        fn = _rmw_leg if kind == "rmw" else _gath_leg
        res.append(fn(dev, name, dt, g, d, ids, nwin, w))
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return res


def main(argv=None) -> int:
    p = parser(__doc__)
    p.add_argument("w", nargs="?", type=int, default=W, help=f"row width (default {W})")
    args = p.parse_args(argv)
    dev = device(args.device)
    print(f"device={dev}; N={N} W={args.w} E={E}", flush=True)
    return finish(run(dev, w=args.w))


if __name__ == "__main__":
    sys.exit(main())
