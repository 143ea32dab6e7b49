"""Port of tools/tpu_refview_r5.py: read-modify-write of sub-granule row
slices of a 2-D matrix, on the card.

The TPU tool asked whether its compiler could move 2-row (bf16) or 1-row
(fp32) slices of a 2-D-tiled matrix in place, addressed four ways (A: an
in-kernel reshape to (N/g, g, W); B: a dynamic row slice; C: the same for
fp32 rows; D: B with an alignment hint).  The card's matrix is untiled, so
every mode is one function: rows [id*g, id*g+g) of an (N, W) matrix += 1 for
E sorted, distinct ids, which is 16e's kernel (``mpf_probe_window_rmw``) on
the (N/g, g, W) view.  Each mode is checked exactly over the whole matrix.

Usage: python -m mpf_tpu_torch.tools.refview_r5 [--device cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from mpf_tpu_torch.ops import _lib
from mpf_tpu_torch.tools import device, errors, finish, leg, parser, time_ms
from mpf_tpu_torch.tools.granule_r5 import DEPTHS, rmw_launch, rmw_plain

N, W, E = 1024, 1024, 16
MODES = (("A", 2, torch.bfloat16), ("B", 2, torch.bfloat16), ("C", 1, torch.float32),
         ("D", 2, torch.bfloat16))


def _view(a, g: int):
    _lib.check(a.dim() == 2 and a.is_contiguous() and a.shape[0] % g == 0
               and a.dtype in (torch.float32, torch.bfloat16),
               "refview_rmw: a contiguous fp32 or bf16 (N, W) matrix, N % g == 0")
    return a.view(a.shape[0] // g, g, a.shape[1])


def refview_rmw_plain(a, ids, g: int):
    """Plain version of :func:`refview_rmw`."""
    rmw_plain(_view(a, g), ids, "probe_refview")
    return a


def refview_rmw(a, ids, g: int, depth: int = 4):
    """IN PLACE: rows [id*g, id*g+g) of the (N, W) fp32 or bf16 matrix ``a``
    += 1 (in fp32, rounded once) for each of the distinct ``ids``.  Returns
    ``a``.  CPU tensors take the plain version; CUDA tensors launch
    ``mpf_probe_window_rmw`` on the (N/g, g, W) view."""
    v = _view(a, g)
    _lib.check(depth in DEPTHS, f"refview_rmw: depth must be one of {DEPTHS}")
    if not _lib.on_cuda(a, ids):
        return refview_rmw_plain(a, ids, g)
    rmw_launch(v, ids, depth, "probe_refview")
    return a


def run(dev, n: int = N, w: int = W, e: int = E, modes=MODES) -> list:
    """The tool's four modes, ids drawn as it draws them; each exact over
    the whole matrix and against the plain version on random values."""
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev).manual_seed(22)
    res = []
    for mode, g, dt in modes:
        ids_np = np.sort(rng.choice(n // g, size=e, replace=False))
        ids = torch.from_numpy(ids_np.astype(np.int32)).to(dev)
        out = refview_rmw(torch.zeros((n, w), dtype=dt, device=dev), ids, g)
        exp = np.zeros((n, w), np.float32)
        for i in ids_np:
            exp[i * g:(i + 1) * g] += 1.0
        nbad = int((out.float().cpu().numpy() != exp).sum())
        x = torch.randn((n, w), generator=gen, device=dev).to(dt)
        y = x.clone()
        same = torch.equal(refview_rmw(x, ids, g), refview_rmw_plain(y, ids, g))
        err = errors(x, y)
        ms = time_ms(lambda: refview_rmw(x, ids, g), dev, iters=5)
        pms = time_ms(lambda: refview_rmw_plain(y, ids, g), dev, iters=1, warmup=0)
        view, idx = y.view(n // g, g, w), ids.long()
        one = torch.ones((), dtype=dt, device=dev).expand(e, g, w)
        lib = time_ms(lambda: view.index_add_(0, idx, one), dev)
        res.append(leg("probe_refview", f"{mode} g={g} {str(dt)[6:]}", nbad == 0 and same,
                       f"exact={nbad == 0} (bad={nbad}) equals_plain={same}", ms=ms,
                       plain_ms=pms, library=lib, nbytes=2 * e * g * w * x.element_size(), g=g,
                       **err))
    return res


def main(argv=None) -> int:
    args = parser(__doc__).parse_args(argv)
    dev = device(args.device)
    print(f"device={dev}; N={N} W={W} E={E}", flush=True)
    return finish(run(dev))


if __name__ == "__main__":
    sys.exit(main())
