"""Panel kernels of the masked path (port of `mpf_tpu/ops/panel_pallas.py`).

* :func:`hgetf2_panel` / :func:`hgetf2_panel_swaps` (kernel 7,
  ``csrc/hgetf2.cu``) — the low-precision pre-pivoting panel LU: pivots,
  the panel row map, the composed map and the LASWP sources; the factors
  are discarded.  Plain version: :func:`ops.getf2.panel_pivots_perm`.
* :func:`getf2_npv_inv_block` (kernel 8, ``csrc/npv.cu``) and
  :func:`getf2_npv_block` (8b, the same kernel without the inverses) — the
  fp32 no-pivot LU of the r x r diagonal block with a zero-pivot ``info``.
* :func:`laswp_apply` (kernel 9, ``csrc/laswp.cu``) — the bounded row
  exchange ``slab[cand[i]] = slab_old[src[i]]``, IN PLACE (the TPU kernel
  aliased its output to its input).

The signatures and return tuples are the JAX package's.  Each wrapper runs
its plain version for CPU tensors and launches its kernel for CUDA tensors;
a CUDA tensor the kernel cannot take raises.  The TPU constraints
``r % 8 == 0`` and ``m % 128 == 0`` (sublane and lane tiling) do not apply.
"""

from __future__ import annotations

import functools

import torch

from mpf_tpu_torch.ops import _lib
from mpf_tpu_torch.ops.blas3 import ieee_fp32
from mpf_tpu_torch.ops.getf2 import npv_step, panel_pivots_perm

_PANEL_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


# --------------------------------------------------------------------------
# kernel 7: pre-pivoting panel LU
# --------------------------------------------------------------------------

def hgetf2_panel_plain(panel, row_offset, prev_perm, panel_dtype=None):
    """Plain version of :func:`hgetf2_panel_swaps`: the panel cast to
    ``panel_dtype`` (round to nearest even) through
    :func:`panel_pivots_perm`, then the LASWP sources."""
    _lib.counted_plain("hgetf2")
    m, r = panel.shape
    panel_dtype = panel_dtype or panel.dtype
    if prev_perm is None:
        prev_perm = torch.arange(m, dtype=torch.int32, device=panel.device)
    piv, perm, cperm = panel_pivots_perm(panel.to(panel_dtype), int(row_offset),
                                         prev_perm=prev_perm)
    rows = torch.arange(int(row_offset), int(row_offset) + r, device=panel.device)
    srcs = torch.cat([perm[rows], perm[piv.long()]])
    return piv, perm, cperm, srcs


def hgetf2_panel_swaps(panel, row_offset: int, prev_perm, panel_dtype=None):
    """Pre-pivoting LU of the (m, r) ``panel`` (fp32 working values, cast
    in-kernel to ``panel_dtype``, or already in ``panel_dtype``) whose
    diagonal sits at row ``row_offset``.  Returns int32 ``(piv, perm,
    composed, srcs)``: pivot positions (r,), the panel's row map (m,), the
    composed map ``prev_perm[perm]`` (identity ``prev_perm`` when None) and
    the LASWP gather sources (2r,) aligned with ``cand = [row_offset +
    arange(r), piv]``.

    CPU tensors take the plain version; CUDA tensors launch kernel 7 (one
    cooperative launch, r grid barriers) on the current stream, with that
    stream's scratch (:func:`_scratch`)."""
    m, r = panel.shape
    panel_dtype = panel_dtype or panel.dtype
    tensors = (panel,) if prev_perm is None else (panel, prev_perm)
    if not _lib.on_cuda(*tensors):
        return hgetf2_panel_plain(panel, row_offset, prev_perm, panel_dtype)
    _lib.check(panel_dtype in _PANEL_KIND, f"hgetf2: panel dtype {panel_dtype}")
    _lib.check(panel.dtype in (torch.float32, panel_dtype) and panel.stride(1) == 1,
               "hgetf2: panel must be a row-major fp32 or panel-dtype view")
    _lib.check(0 <= row_offset and row_offset + r <= m, "hgetf2: diagonal outside the panel")
    dev = panel.device
    if prev_perm is None:
        prev_perm = torch.arange(m, dtype=torch.int32, device=dev)
    prev_perm = prev_perm.to(torch.int32).contiguous()
    kind = _PANEL_KIND[panel_dtype]
    gmax = _sm_count(dev)
    scratch = _scratch(dev, r)
    nbytes = _panel_bytes(m, r, kind, gmax)
    gpanel = torch.empty(nbytes, dtype=torch.uint8, device=dev) if nbytes else None
    piv = torch.empty(r, dtype=torch.int32, device=dev)
    perm = torch.empty(m, dtype=torch.int32, device=dev)
    cperm = torch.empty(m, dtype=torch.int32, device=dev)
    srcs = torch.empty(2 * r, dtype=torch.int32, device=dev)
    _lib.call("mpf_hgetf2", m, r, panel.data_ptr(), panel.stride(0),
              int(panel.dtype == panel_dtype and panel_dtype != torch.float32), kind,
              int(row_offset), prev_perm.data_ptr(), piv.data_ptr(), perm.data_ptr(),
              cperm.data_ptr(), srcs.data_ptr(), scratch.data_ptr(),
              None if gpanel is None else gpanel.data_ptr(), gmax)
    _lib.counted_launch("hgetf2")
    return piv, perm, cperm, srcs


@functools.lru_cache(maxsize=16)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=256)
def _panel_bytes(m: int, r: int, kind: int, gmax: int) -> int:
    """Bytes of the global panel kernel 7 needs when a block's rows do not
    fit in shared memory (0 when they do)."""
    return _lib.lib().mpf_hgetf2_panel_bytes(m, r, kind, gmax)


#: kernel 7's scratch by (device, stream)
_SCRATCH: dict = {}


def _scratch(device: torch.device, r: int) -> torch.Tensor:
    """Kernel 7's scratch for launches of up to ``r`` columns on ``device``
    from the current stream: one zeroed buffer holding the grid barrier's
    counters (each launch leaves them at 0) and two key and two record
    slots a block.  One for each stream, so launches on two streams never
    share it; sized for r = 256 (the widest panel the driver factors) and
    grown when a wider panel comes (the old buffer is freed in the
    stream's order, after the launches that use it)."""
    key = (device, torch.cuda.current_stream().cuda_stream)
    nbytes = _lib.lib().mpf_hgetf2_scratch_bytes(max(r, 256), _sm_count(device))
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() < nbytes:
        buf = _SCRATCH[key] = torch.zeros(nbytes, dtype=torch.uint8, device=device)
    return buf


def hgetf2_panel(panel, row_offset: int = 0, prev_perm=None):
    """Pre-pivoting LU of the (m, r) ``panel`` in its own dtype: ``(piv,
    perm)``, and ``(piv, perm, composed)`` when ``prev_perm`` is given."""
    piv, perm, cperm, _ = hgetf2_panel_swaps(panel, row_offset, prev_perm)
    if prev_perm is not None:
        return piv, perm, cperm
    return piv, perm


# --------------------------------------------------------------------------
# kernel 8 / 8b: no-pivot diagonal LU (with the inverses)
# --------------------------------------------------------------------------

def getf2_npv_inv_plain(block, with_inv: bool = True):
    """Plain version of kernels 8 (``with_inv``) and 8b: the elimination of
    :func:`ops.getf2.getf2_npv`, the Gauss-Jordan L^{-1} in the same loop,
    and U^{-1} by back substitution (a row-times-matrix product per row)."""
    _lib.counted_plain("npv_inv" if with_inv else "npv")
    r = block.shape[0]
    dev = block.device
    f32 = torch.float32
    b = block.to(f32).clone()
    cols = torch.arange(r, device=dev)[None, :]
    zero = torch.zeros((), dtype=f32, device=dev)
    one = torch.ones((), dtype=f32, device=dev)
    info = torch.zeros((), dtype=torch.int32, device=dev)
    li = torch.eye(r, dtype=f32, device=dev)
    for j in range(r):
        b, mult, info = npv_step(b, j, info)
        if with_inv:
            li = _lib.fms(li, mult, li[j:j + 1, :])
    if not with_inv:
        return b, info
    y = torch.zeros((r, r), dtype=f32, device=dev)
    with ieee_fp32():
        for t in range(r):
            i = r - 1 - t
            urow_m = torch.where(cols > i, b[i:i + 1, :], zero)
            uii = b[i, i]
            safe = torch.where(uii == 0, one, uii)
            y[i:i + 1, :] = ((cols == i).to(f32) - urow_m @ y) / safe
    return b, li, y, info


def _npv_launch(block, with_inv: bool):
    """Kernel 8 (``with_inv``) or 8b on a CUDA ``block``."""
    _lib.check(block.dtype == torch.float32 and block.dim() == 2
               and block.shape[0] == block.shape[1] and block.stride(1) == 1,
               "getf2_npv: block must be a square row-major fp32 view")
    r = block.shape[0]
    dev = block.device
    lu = torch.empty((r, r), dtype=torch.float32, device=dev)
    linv = torch.empty((r, r), dtype=torch.float32, device=dev) if with_inv else None
    uinv = torch.empty((r, r), dtype=torch.float32, device=dev) if with_inv else None
    info = torch.empty((), dtype=torch.int32, device=dev)
    _lib.call("mpf_npv", r, block.data_ptr(), block.stride(0), lu.data_ptr(),
              None if linv is None else linv.data_ptr(),
              None if uinv is None else uinv.data_ptr(), info.data_ptr(), int(with_inv))
    _lib.counted_launch("npv_inv" if with_inv else "npv")
    return lu, linv, uinv, info


def getf2_npv_inv_block(block):
    """No-pivot LU of the (r, r) fp32 ``block`` with fused triangular
    inverses: ``(lu, L^{-1}, U^{-1}, info)``, ``info`` the 1-based first
    zero pivot as an int32 scalar tensor.  CPU tensors take the plain
    version; CUDA tensors launch kernel 8 (one launch: for r <= 128 kernel
    2's register-tile elimination and back substitution, bitwise kernel 2's
    outputs on the same rows; beyond, one block stepping through the block
    in shared or global memory)."""
    if not _lib.on_cuda(block):
        return getf2_npv_inv_plain(block, True)
    return _npv_launch(block, True)


def getf2_npv_block(block):
    """No-pivot LU of the (r, r) fp32 ``block``: ``(lu, info)``.  CPU
    tensors take the plain version; CUDA tensors launch kernel 8b (kernel
    8's elimination, without the inverses)."""
    if not _lib.on_cuda(block):
        return getf2_npv_inv_plain(block, False)
    lu, _, _, info = _npv_launch(block, False)
    return lu, info


# --------------------------------------------------------------------------
# kernel 9: bounded row exchange
# --------------------------------------------------------------------------

def laswp_plain(slab, cand, src):
    """Plain version of :func:`laswp_apply` (same in-place contract)."""
    _lib.counted_plain("laswp")
    slab[cand.long()] = slab[src.long()]
    return slab


def laswp_apply(slab, cand, src):
    """``slab[cand[i], :] = slab_old[src[i], :]`` IN PLACE on the (n, w)
    row-major view ``slab`` (fp32 or bf16; any row stride), every read
    before any write.  Duplicate ``cand`` entries must carry identical
    sources.  Returns ``slab``.  CPU tensors take the plain version; CUDA
    tensors launch kernel 9 (a gather launch into a staging buffer, then a
    scatter launch)."""
    if not _lib.on_cuda(slab, cand, src):
        return laswp_plain(slab, cand, src)
    _lib.check(slab.dim() == 2 and slab.stride(1) == 1
               and slab.dtype in (torch.float32, torch.bfloat16),
               "laswp: slab must be a row-major fp32 or bf16 view")
    cand = cand.to(torch.int32).contiguous()
    src = src.to(torch.int32).contiguous()
    nswap, w = cand.shape[0], slab.shape[1]
    stage = torch.empty((nswap, w), dtype=slab.dtype, device=slab.device)
    _lib.call("mpf_laswp", nswap, w, slab.data_ptr(), slab.stride(0), cand.data_ptr(),
              src.data_ptr(), stage.data_ptr(), slab.element_size())
    _lib.counted_launch("laswp")
    return slab
