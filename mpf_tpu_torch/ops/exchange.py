"""Bounded row exchange, once per block column (port of
`mpf_tpu/ops/exchange.py:rows_exchange`; kernel 4, ``csrc/exchange.cu``).

The composed row map of a block column is a permutation whose swap chains
bottom out in the band [k, k + nr): every row moving INTO the band is a
pivot row ``glist[j]``, and every row moving OUT is an original band row
going to ``dests[i]``.  The TPU kernel's granule windows and sorted
schedules (`build_exchange_schedules`) exist for the TPU's DMA granule and
have no counterpart here: rows are contiguous in a row-major tensor.
"""

from __future__ import annotations

import torch

from mpf_tpu_torch.ops import _lib


def rows_exchange_plain(a: torch.Tensor, k: int, glist: torch.Tensor,
                        dests: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`rows_exchange` (same in-place contract)."""
    _lib.counted_plain("rows_exchange")
    nr = glist.shape[0]
    pivrows = a[glist.long()]                 # gathered copy (all reads first)
    band = a[k:k + nr].clone()
    d = dests.long()
    act = (d < k) | (d >= k + nr)
    a[d[act]] = band[act]
    return pivrows


def rows_exchange(a: torch.Tensor, k: int, glist: torch.Tensor,
                  dests: torch.Tensor) -> torch.Tensor:
    """One bounded row exchange, IN PLACE on ``a`` (the TPU kernel aliased
    its output to its input).  Returns ``pivrows`` with

      * ``pivrows[j] = a[glist[j], :]`` — values before any write; the
        caller writes it over the band ``a[k:k+nr, :]``, and
      * ``a[dests[i], :] = a[k + i, :]`` for every ``dests[i]`` outside the
        band (in-band destinations are covered by the band write).

    CPU tensors take the plain version; CUDA tensors launch kernel 4 (a
    gather launch, then a scatter launch)."""
    if not _lib.on_cuda(a, glist, dests):
        return rows_exchange_plain(a, k, glist, dests)
    _lib.check(a.dtype == torch.float32 and a.dim() == 2 and a.is_contiguous(),
               "rows_exchange: a must be a contiguous fp32 matrix")
    glist = glist.to(torch.int32).contiguous()
    dests = dests.to(torch.int32).contiguous()
    nr, w = glist.shape[0], a.shape[1]
    pivrows = torch.empty((nr, w), dtype=a.dtype, device=a.device)
    _lib.call("mpf_rows_exchange", nr, w, a.data_ptr(), a.stride(0), int(k),
              glist.data_ptr(), dests.data_ptr(), pivrows.data_ptr())
    _lib.counted_launch("rows_exchange")
    return pivrows
