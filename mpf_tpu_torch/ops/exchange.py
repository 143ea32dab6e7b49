"""Row exchanges (port of `mpf_tpu/ops/exchange.py`): the bounded row
exchange once per block column (:func:`rows_exchange`, kernel 4,
``csrc/exchange.cu``; :func:`rows_exchange3` on the pair-layout matrix)
and the deferred-overflow exchange's band copy and
flush (:func:`copy_rows_block`, :func:`flush_overflow`, kernel 14,
``csrc/overflow.cu``).

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


def scatter_band(a: torch.Tensor, k: int, dests: torch.Tensor) -> None:
    """``a[dests[i], :] = a[k + i, :]`` for every ``dests[i]`` outside the
    band ``[k, k + nr)``, the band read before any write: the scatter half
    of the plain exchanges (kernels 4, 11 and 13), uncounted."""
    nr = dests.shape[0]
    band = a[k:k + nr].clone()
    d = dests.long()
    act = (d < k) | (d >= k + nr)
    a[d[act]] = band[act]


def rows_exchange_plain(a: torch.Tensor, k: int, glist: torch.Tensor,
                        dests: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`rows_exchange` (same in-place contract)."""
    _lib.counted_plain("rows_exchange")
    pivrows = a[glist.long()]                 # gathered copy (all reads first)
    scatter_band(a, k, dests)
    return pivrows


def rows_exchange(a: torch.Tensor, k: int, glist: torch.Tensor,
                  dests: torch.Tensor) -> torch.Tensor:
    """One bounded row exchange, IN PLACE on ``a`` (the TPU kernel aliased
    its output to its input).  Returns ``pivrows`` with

      * ``pivrows[j] = a[glist[j], :]`` — values before any write; the
        caller writes it over the band ``a[k:k+nr, :]``, and
      * ``a[dests[i], :] = a[k + i, :]`` for every ``dests[i]`` outside the
        band (in-band destinations are covered by the band write).

    ``a`` is fp32 or bf16 (rows are copied as they are).  CPU tensors take
    the plain version; CUDA tensors launch kernel 4 (a gather launch, then a
    scatter launch)."""
    if not _lib.on_cuda(a, glist, dests):
        return rows_exchange_plain(a, k, glist, dests)
    _lib.check(a.dtype in (torch.float32, torch.bfloat16) and a.dim() == 2
               and a.is_contiguous(), "rows_exchange: a must be a contiguous fp32 or bf16 matrix")
    glist = glist.to(torch.int32).contiguous()
    dests = dests.to(torch.int32).contiguous()
    nr, w = glist.shape[0], a.shape[1]
    pivrows = torch.empty((nr, w), dtype=a.dtype, device=a.device)
    _lib.call("mpf_rows_exchange", nr, w, a.data_ptr(), a.stride(0), int(k),
              glist.data_ptr(), dests.data_ptr(), pivrows.data_ptr(), a.element_size())
    _lib.counted_launch("rows_exchange")
    return pivrows


def rows_exchange3(a3: torch.Tensor, k: int, glist: torch.Tensor,
                   dests: torch.Tensor) -> torch.Tensor:
    """:func:`rows_exchange` on the (n/2, 2, n) pair-layout matrix, row i
    at ``a3[i // 2, i % 2]`` (`exchange.rows_exchange3`'s function): kernel
    4 on its (n, n) view (:func:`mpf_tpu_torch.ops.pair3d.as_matrix`),
    counted as ``rows_exchange``.  Returns the pivot rows (nr, n) in the
    matrix's dtype, where the TPU kernel returned its fp32 staging, and
    which :func:`mpf_tpu_torch.ops.pair3d.band_write_rows` writes over the
    band.  The TPU kernel's 2-row windows and 16-slot rings existed for its
    DMA granule."""
    from mpf_tpu_torch.ops.pair3d import as_matrix  # pair3d's imports reach this module

    return rows_exchange(as_matrix(a3), k, glist, dests)


def _raw_rows(a: torch.Tensor, name: str) -> None:
    _lib.check(a.dtype in (torch.float32, torch.bfloat16) and a.dim() == 2
               and a.is_contiguous(), f"{name}: a must be a contiguous fp32 or bf16 matrix")


def copy_rows_block_plain(a: torch.Tensor, src: int, dst: int, nrows: int) -> torch.Tensor:
    """Plain version of :func:`copy_rows_block`."""
    _lib.counted_plain("copy_rows")
    a[dst:dst + nrows] = a[src:src + nrows]
    return a


def copy_rows_block(a: torch.Tensor, src: int, dst: int, nrows: int) -> torch.Tensor:
    """IN PLACE: ``a[dst:dst+nrows] = a[src:src+nrows]``, the two ranges
    not overlapping (the deferred exchange's band -> overflow append).
    Rows of the fp32 or bf16 ``a`` are copied as they are.  Returns ``a``.
    CPU tensors take the plain version; CUDA tensors launch kernel 14's
    row copy."""
    _lib.check(0 <= src and 0 <= dst and max(src, dst) + nrows <= a.shape[0]
               and (src + nrows <= dst or dst + nrows <= src),
               "copy_rows_block: ranges must lie in a and not overlap")
    if not _lib.on_cuda(a):
        return copy_rows_block_plain(a, src, dst, nrows)
    _raw_rows(a, "copy_rows_block")
    _lib.call("mpf_copy_rows", int(nrows), a.shape[1], a.data_ptr(), a.stride(0), int(src),
              int(dst), a.element_size())
    _lib.counted_launch("copy_rows")
    return a


def flush_overflow_plain(a: torch.Tensor, novstart: int, dests: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`flush_overflow`."""
    _lib.counted_plain("flush_overflow")
    slots = torch.arange(novstart, novstart + dests.shape[0], device=a.device)
    d = dests.long()
    # a dead slot rewrites its own row with its own value (no boolean
    # indexing, so no host sync)
    a[torch.where(d < novstart, d, slots)] = a[slots].clone()
    return a


def flush_overflow(a: torch.Tensor, novstart: int, dests: torch.Tensor) -> torch.Tensor:
    """IN PLACE: ``a[dests[i]] = a[novstart + i]`` for every live slot i
    (``dests[i] < novstart``); dead slots carry ``2**31 - 1`` and are
    dropped.  Live destinations must be pairwise distinct.  Rows of the
    fp32 or bf16 ``a`` are copied as they are.  Returns ``a``.

    CPU tensors take the plain version; CUDA tensors launch kernel 14's
    flush (one block per slot)."""
    nov = dests.shape[0]
    _lib.check(0 <= novstart and novstart + nov <= a.shape[0],
               "flush_overflow: overflow slots outside a")
    if not _lib.on_cuda(a, dests):
        return flush_overflow_plain(a, novstart, dests)
    _raw_rows(a, "flush_overflow")
    dests = dests.to(torch.int32).contiguous()
    _lib.call("mpf_flush_overflow", nov, a.shape[1], a.data_ptr(), a.stride(0), int(novstart),
              dests.data_ptr(), a.element_size())
    _lib.counted_launch("flush_overflow")
    return a
