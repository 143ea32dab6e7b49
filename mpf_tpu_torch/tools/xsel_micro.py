"""Port of tools/tpu_xsel_micro.py: the per-entry cost of reading or writing
one row, by a dynamic index, of a (G, XW) bf16 window held in on-chip memory
(the inner step of the exchange kernels 4, 11 and 13), on the card.

The TPU tool's six modes are four functions (E entries ``ids`` in [0, G),
``win`` starting as ``x``):

  masked, roll, dot  extract:  out = sum_e f32(win[ids[e]]), in order of e
  store              overlay:  win[ids[e]] = bf16(e); out = f32(win[0])
  dma                copy-out: row[e mod 4] = win[ids[e]] (rows start 0);
                               out = f32(win[0]) + f32(row[0])
  dstore             copy-in:  win[ids[e]] = row[e mod 4]; out as copy-out

one kernel, ``mpf_probe_xsel``: each block holds a (G, 256) slice of the
window in shared memory, one thread a column, and walks all E entries.

Usage: python -m mpf_tpu_torch.tools.xsel_micro [--device cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from mpf_tpu_torch.ops import _lib
from mpf_tpu_torch.tools import (
    check_ids, device, errors, finish, leg, parser, rate, time_ms)

E, XW, G = 2048, 32768, 16
NROWS = 4  # the copy modes' row buffers
MODES = ("masked", "roll", "dot", "dma", "store", "dstore")
KIND = {"masked": 0, "roll": 0, "dot": 0, "store": 1, "dma": 2, "dstore": 3}
BF = torch.bfloat16


def _check(x, ids, mode):
    _lib.check(mode in KIND, f"xsel: mode must be one of {MODES}")
    _lib.check(x.dim() == 2 and x.dtype == BF, "xsel: x must be a bf16 (g, xw) window")
    _lib.check(ids.dim() == 1 and not ids.is_floating_point(), "xsel: ids must be 1-D ints")


def xsel_plain(x, ids, mode: str):
    """Plain version of :func:`xsel`."""
    _lib.counted_plain("probe_xsel")
    _check(x, ids, mode)
    check_ids(ids, x.shape[0], "xsel")
    kind = KIND[mode]
    win = x.clone()
    row = torch.zeros((NROWS, x.shape[1]), dtype=BF, device=x.device)
    acc = torch.zeros((1, x.shape[1]), dtype=torch.float32, device=x.device)
    for e, r in enumerate(ids.tolist()):
        if kind == 0:
            acc = acc + win[r].float()
        elif kind == 1:
            win[r] = (acc[0] + float(e)).to(BF)
        elif kind == 2:
            row[e % NROWS] = win[r]
        else:
            win[r] = row[e % NROWS]
    if kind == 0:
        return acc
    out = win[0:1].float()
    return out if kind == 1 else out + row[0:1].float()


def xsel(x, ids, mode: str):
    """(1, xw) fp32: the function ``mode`` names (module docstring) on the
    (g, xw) bf16 window ``x`` (left unchanged) and the row ids.  CPU tensors
    take the plain version (ids outside [0, g) raise ValueError); CUDA
    tensors launch ``mpf_probe_xsel`` (and skip such ids)."""
    _check(x, ids, mode)
    if not _lib.on_cuda(x, ids):
        return xsel_plain(x, ids, mode)
    x, ids = x.contiguous(), ids.to(torch.int32).contiguous()
    _lib.check(ids.shape[0] * 4 + (x.shape[0] + NROWS) * 512 <= 227 * 1024,
               "xsel: the ids and a (g, 256) window slice must fit a block's shared memory")
    out = torch.empty((1, x.shape[1]), dtype=torch.float32, device=x.device)
    _lib.call("mpf_probe_xsel", KIND[mode], x.shape[0], x.shape[1], ids.shape[0], x.data_ptr(),
              ids.data_ptr(), out.data_ptr())
    _lib.counted_launch("probe_xsel")
    return out


def run(dev, e: int = E, xw: int = XW, g: int = G, modes=MODES) -> list:
    """The tool's modes on its inputs (``default_rng(0)``: ids, then x),
    each held bitwise to the plain version."""
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, g, size=e).astype(np.int32)).to(dev)
    x = torch.from_numpy(rng.standard_normal((g, xw)).astype(np.float32)).to(dev).to(BF)
    idx = ids.long()
    res = []
    for mode in modes:
        got, ref = xsel(x, ids, mode), xsel_plain(x, ids, mode)
        same = torch.equal(got, ref)
        ms = time_ms(lambda: xsel(x, ids, mode), dev, iters=5)
        pms = time_ms(lambda: xsel_plain(x, ids, mode), dev, iters=1, warmup=0)
        lib = (time_ms(lambda: x.index_select(0, idx).float().sum(0), dev)
               if KIND[mode] == 0 else None)
        per = rate(ms, lambda s: s / e * 1e9, "ns/entry")
        res.append(leg("probe_xsel", mode, same, f"{per} (fp={float(got[0, 0]):.3e}) "
                       f"equals_plain={same}", ms=ms, plain_ms=pms, library=lib,
                       nbytes=g * xw * 2 + e * 4 + xw * 4, **errors(got, ref),
                       fp32_ops=e * xw if KIND[mode] == 0 else 0))
    return res


def main(argv=None) -> int:
    args = parser(__doc__).parse_args(argv)
    dev = device(args.device)
    print(f"device={dev}; E={E} xw={XW} g={G} bfloat16", flush=True)
    return finish(run(dev))


if __name__ == "__main__":
    sys.exit(main())
