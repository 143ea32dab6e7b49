"""Strip-blocked virtual-pivoting panel LU (port of
`mpf_tpu/ops/panel_strip.py:strip_panel_pivots`; kernel 1,
``csrc/strip_pivots.cu``).

Rows never move: ``pos`` maps each slab row to its current position, rows
at positions below the panel's diagonal are frozen, and ``2**31 - 1`` marks
a dead row.  Per 8-column strip the active columns are eliminated in fp32
over panel-dtype storage, and the later strips receive one deferred rank-8
update (the JAX package's ``MPF_A1_DEFER=full`` semantics).  The factors
are discarded; only the pivots and the position map escape.

Round points (they decide the pivots, so kernel and plain version keep
them identical): the panel is stored in the panel dtype and rounded once
per strip; values within a strip are fp32; multipliers are a true divide
(by the top-15-bit-truncated pivot under quant16); the deferred update
rounds the multipliers and (T S)(I+N)^{-1} to the panel dtype.  Pivot ties
go to the lowest POSITION.

The TPU-only knobs ``MPF_GM``, ``MPF_A1_V2``, ``MPF_A1_STUB`` and
``MPF_ROLL_PACK`` are layout or timing devices with no counterpart here.
"""

from __future__ import annotations

import functools

import torch

from mpf_tpu_torch.ops import _lib
from mpf_tpu_torch.ops.blas3 import ieee_fp32

W = 8                 # strip width
SENT = 2**31 - 1      # dead-row position sentinel
_QUANT16_MAX_POS = 65536


def _use_quant16(panel_dtype, m: int, pos_bound: int | None = None) -> bool:
    """quant16 (bf16 |value| granularity, single-key search) for bf16
    panels whose position range fits the TPU key's 16-bit field; the exact
    search otherwise (fp32 panels always).  The range is ``pos_bound``, the
    exclusive bound of the live positions, when given, else the slab height
    ``m``: a deferred-exchange slab carries overflow rows below its logical
    height while its positions stay below it (`panel_strip.py:822-826`)."""
    bound = m if pos_bound is None else pos_bound
    return panel_dtype == torch.bfloat16 and bound <= _QUANT16_MAX_POS


def strip_panel_pivots_plain(slab, off, pos, panel_dtype, jj0=0, r=None,
                             quant16=None, pos_bound=None):
    """Plain version of :func:`strip_panel_pivots` (one column at a time in
    PyTorch; same arithmetic and round points as the kernel)."""
    _lib.counted_plain("strip_pivots")
    m, w = slab.shape
    r = w if r is None else r
    quant16 = _use_quant16(panel_dtype, m, pos_bound) if quant16 is None else quant16
    dev = slab.device
    f32 = torch.float32
    zero = torch.zeros((), dtype=f32, device=dev)
    one = torch.ones((), dtype=f32, device=dev)
    rows = torch.arange(m, device=dev)
    t = slab[:, jj0:jj0 + r].to(panel_dtype).clone()          # (m, r)
    p64 = pos.to(torch.int64).clone()
    piv = torch.empty(r, dtype=torch.int64, device=dev)
    glist = torch.empty(r, dtype=torch.int64, device=dev)
    absmask = 0x7FFF0000 if quant16 else 0x7FFFFFFF
    wcols = torch.arange(W, device=dev)
    for s in range(r // W):
        st = t[:, s * W:(s + 1) * W].to(f32)                   # (m, W)
        mbuf = torch.zeros((m, W), dtype=f32, device=dev)
        olist = []
        for jc in range(W):
            j = s * W + jc
            d = off + j
            colv = st[:, jc]
            active = (p64 != SENT) & (p64 >= d)
            bits = colv.view(torch.int32).to(torch.int64) & absmask
            key = torch.where(active, bits * 2**32 + (2**32 - 1 - p64),
                              torch.full_like(p64, -1))
            o = torch.argmax(key)                              # unique max
            kbits = bits[o]
            cp = p64[o]
            val = colv[o]
            if quant16:
                mag = kbits.to(torch.int32).view(f32)
                pivval = torch.where(torch.signbit(val), -mag, mag)
            else:
                pivval = val
            safe = torch.where(kbits == 0, one, pivval)
            disp = p64 == d
            p64 = torch.where(rows == o, torch.full_like(p64, d),
                              torch.where(disp, cp, p64))
            below = (p64 != SENT) & (p64 > d)
            mult = torch.where(below, colv / safe, zero)
            mbuf[:, jc] = mult
            ucol = torch.where(wcols > jc, st[o], zero)        # winner's strip row
            rest = _lib.fms(st, ucol[None, :], mult[:, None])
            st = torch.where(wcols[None, :] > jc, rest, st)
            piv[j] = cp
            glist[j] = o
            olist.append(o)
        t[:, s * W:(s + 1) * W] = st.to(panel_dtype)
        if s + 1 == r // W:
            break
        # deferred rank-W update of the later strips
        mq = mbuf.to(panel_dtype).to(f32)                      # (m, W)
        ol = torch.stack(olist)
        nmat = mq[ol].t()                                      # N[a, b] = M[a, o_b]
        eye = torch.eye(W, dtype=f32, device=dev)
        with ieee_fp32():
            vinv = eye - nmat
            pw = -nmat
            for _ in range(W - 2):
                pw = (-nmat) @ pw
                vinv = vinv + pw
            f0 = (s + 1) * W
            fut = t[:, f0:].to(f32)                            # (m, F)
            u = fut[ol].t() @ vinv                             # (F, W)
            ub = u.to(panel_dtype).to(f32)
            upd = mq @ ub.t()                                  # (m, F)
        t[:, f0:] = (fut - upd).to(panel_dtype)
    return piv.to(torch.int32), p64.to(torch.int32), glist.to(torch.int32)


def strip_panel_pivots(slab, off: int, pos, panel_dtype=None, jj0: int = 0,
                       r: int | None = None, quant16: bool | None = None,
                       pos_bound: int | None = None):
    """Virtual-pivoting panel LU of columns [jj0, jj0 + r) of the fp32 or
    bf16 ``slab`` (m, w), with the panel held in ``panel_dtype`` (bf16 or
    fp32; a bf16 slab needs a bf16 panel, which the kernel takes as stored).

    ``off`` — the current position of the panel's diagonal; ``pos`` (m,)
    int32 — slab row -> current position.  Returns ``(piv, pos', glist)``
    (int32): 0-based pivot positions (r,), the updated position map (a new
    tensor; ``pos`` is not modified), and ``glist[j]`` — the slab row that
    lands on position off + j.  ``quant16=None`` picks quant16 for bf16
    panels whose live positions lie below 65536 (below ``pos_bound`` when
    given, else below m), the exact search otherwise.  Rows at position
    ``2**31 - 1`` are dead: never searched, swapped or eliminated.

    CPU tensors take the plain version; CUDA tensors launch kernel 1 (one
    cooperative launch, r exchanges of the blocks' candidates through
    flagged slots) on the current stream, with that stream's scratch
    (:func:`_scratch`)."""
    m, w = slab.shape
    r = w if r is None else r
    panel_dtype = panel_dtype or slab.dtype
    quant16 = _use_quant16(panel_dtype, m, pos_bound) if quant16 is None else quant16
    if not _lib.on_cuda(slab, pos):
        return strip_panel_pivots_plain(slab, off, pos, panel_dtype, jj0, r, quant16)
    _lib.check(slab.dtype in (torch.float32, torch.bfloat16) and slab.stride(1) == 1,
               "strip_panel_pivots: slab must be a row-major fp32 or bf16 view")
    _lib.check(panel_dtype in (torch.bfloat16, torch.float32),
               "strip_panel_pivots: panel dtype must be bf16 or fp32")
    slab_bf16 = slab.dtype == torch.bfloat16
    _lib.check(panel_dtype == torch.bfloat16 or not slab_bf16,
               "strip_panel_pivots: a bf16 slab needs a bf16 panel")
    _lib.check(r % W == 0 and 0 < r <= 128, "strip_panel_pivots: r % 8 == 0, r <= 128")
    dev = slab.device
    pos2 = pos.to(torch.int32).clone()
    piv = torch.empty(r, dtype=torch.int32, device=dev)
    glist = torch.empty(r, dtype=torch.int32, device=dev)
    gmax, scratch = _scratch(dev)
    _lib.call("mpf_strip_pivots", m, r, slab.data_ptr(), slab.stride(0), int(jj0),
              int(off), pos2.data_ptr(), piv.data_ptr(), glist.data_ptr(), int(slab_bf16),
              int(panel_dtype == torch.bfloat16), int(bool(quant16)),
              scratch.data_ptr(), gmax)
    _lib.counted_launch("strip_pivots")
    return piv, pos2, glist


def _scratch(device: torch.device):
    """Kernel 1's scratch for launches on ``device`` from the current
    stream: the grid's upper bound (the SM count) and one zeroed buffer
    holding a header of counters (the launch count, whose successor flags
    a launch's slots; the poll rounds :func:`exchange_polls` reads) and a
    candidate slot and tail per column (r <= 128) and block.  Made once for
    each stream, so launches on two streams never share it."""
    return _stream_scratch(device, torch.cuda.current_stream().cuda_stream)


_POLL_WORD = 3  # the header's 32-bit word of poll rounds (csrc kPollWord)


def exchange_polls(device=None) -> int:
    """The poll rounds block 0 of kernel 1 made over its columns' exchanges
    on the current stream since the last call (which this one resets): one
    a column when every block's candidate was there at the first read, so
    at least r a launch; many when the exchange waits on the slowest block.
    Synchronises: for ``utils/panel_bench.py`` and ``chip_smoke.py``, never
    on the factorization path."""
    dev = torch.device("cuda", torch.cuda.current_device()) if device is None else device
    word = _scratch(dev)[1][4 * _POLL_WORD:4 * _POLL_WORD + 4].view(torch.int32)
    n = int(word.item()) & 0xFFFFFFFF
    word.zero_()
    return n


@functools.lru_cache(maxsize=16)
def _stream_scratch(device: torch.device, stream: int):
    gmax = torch.cuda.get_device_properties(device).multi_processor_count
    nbytes = _lib.lib().mpf_strip_scratch_bytes(gmax)
    return gmax, torch.zeros(nbytes, dtype=torch.uint8, device=device)


def barrier_probe(kind: int, iters: int, device=None) -> None:
    """Launch kernel 1's grid barrier probe on ``device`` (default: the
    current CUDA device): ``iters`` grid barriers across one block an SM,
    ``kind`` 0 cooperative groups' ``grid.sync()``, 1 an arrival counter
    (kernel 7's), 2 the counter with a read of the G keys behind it, 3
    kernel 1's exchange alone (each block writes its flagged slot, warp 0
    polls the G keys, reduces them and reads the winner's values), 4 kind
    3 with a released record (a release fence between 128 flagged words
    and the slot, an acquire fence after the poll).  Kinds 3 and 4 take a
    multiple of 8 ``iters``.
    Asynchronous; time it with CUDA events (no pivot search, no count)."""
    dev = torch.device("cuda", torch.cuda.current_device()) if device is None else device
    gmax, scratch = _scratch(dev)
    _lib.call("mpf_strip_barrier_probe", int(kind), int(iters), scratch.data_ptr(), gmax)
