"""Port of tools/tpu_probe_r4.py: the four round-4 design probes on the card.

  smem      16a  a per-launch int32 schedule of ns entries: read its first,
                 middle and last entries (on the card a block loads its own
                 indices, so ns is bounded by device memory)
  hbm2smem  16b  an async device -> shared-memory bulk copy completed on a
                 barrier (TMA ``cp.async.bulk`` on an ``mbarrier``)
  rowdma    16c  strided single-row fp32 reads through a ring of ``depth``
                 slots: the row-read rate against depth
  overlap   16d  tensor-core GEMM steps with extra device-memory reads
                 streamed beside them: us/step and TF/s against extra MB/step

Usage: python -m mpf_tpu_torch.tools.probe_r4 [CMD ...] [--device cpu]
(default: all four).
"""

from __future__ import annotations

import sys

import torch

from mpf_tpu_torch.ops import _lib
from mpf_tpu_torch.ops.blas3 import ieee_fp32
from mpf_tpu_torch.tools import (
    device, errors, finish, leg, parser, rate, time_ms)

SMEM_SIZES = (2048, 8192, 32768, 65536, 262144)
HBM2SMEM_NS, HBM2SMEM_C = 4096, 512
ROW_STRIDE = 97
OVERLAP_G = 16         # rows a streamed chunk
OVERLAP_AW = 8192      # the streamed (8192, 8192) bf16 array
OVERLAP_PIECE = 16384  # bytes a streamed piece (the kernel's ring slot)
OVERLAP_TILE = 128     # d's rows and columns a block
BF = torch.bfloat16


# --------------------------------------------------------------------------
# 16a: three entries of a schedule
# --------------------------------------------------------------------------

def sched_read_plain(sched, x):
    """Plain version of :func:`sched_read`."""
    _lib.counted_plain("probe_sched_read")
    ns = sched.shape[0]
    return x + (sched[0] + sched[ns // 2] + sched[ns - 1]).to(torch.float32)


def sched_read(sched, x):
    """``x + f32(s[0] + s[ns/2] + s[ns-1])`` for the int32 schedule ``sched``
    (ns,) and fp32 ``x``; the int32 sum wraps.  CPU tensors take the plain
    version; CUDA tensors launch ``mpf_probe_sched_read``."""
    _lib.check(sched.dim() == 1 and sched.dtype == torch.int32 and sched.shape[0] > 0
               and x.dtype == torch.float32, "sched_read: int32 (ns,) schedule, fp32 x")
    if not _lib.on_cuda(sched, x):
        return sched_read_plain(sched, x)
    sched, x = sched.contiguous(), x.contiguous()
    out = torch.empty_like(x)
    _lib.call("mpf_probe_sched_read", sched.shape[0], sched.data_ptr(), x.data_ptr(),
              out.data_ptr(), x.numel())
    _lib.counted_launch("probe_sched_read")
    return out


# --------------------------------------------------------------------------
# 16b: a bulk copy into shared memory, waited on a barrier
# --------------------------------------------------------------------------

def bulk_copy_plain(sched, x, off: int = HBM2SMEM_C, count: int = HBM2SMEM_C):
    """Plain version of :func:`bulk_copy`."""
    _lib.counted_plain("probe_bulk_copy")
    ssc = sched[off:off + count].clone()
    return x + (ssc[0] + ssc[count - 1]).to(torch.float32)


def bulk_copy(sched, x, off: int = HBM2SMEM_C, count: int = HBM2SMEM_C):
    """``s[off:off+count]`` copied into on-chip memory, then ``x +
    f32(ssc[0] + ssc[count-1])``.  On the card a TMA bulk copy into shared
    memory completed on an mbarrier (``mpf_probe_bulk_copy``); count and off
    multiples of 4 (16 bytes), count * 4 <= 227 KB.  CPU tensors take the
    plain version."""
    _lib.check(sched.dim() == 1 and sched.dtype == torch.int32 and x.dtype == torch.float32
               and 0 <= off and count > 0 and off + count <= sched.shape[0],
               "bulk_copy: int32 (ns,) schedule, fp32 x, [off, off+count) inside it")
    if not _lib.on_cuda(sched, x):
        return bulk_copy_plain(sched, x, off, count)
    sched, x = sched.contiguous(), x.contiguous()
    _lib.check(count % 4 == 0 and count * 4 <= 227 * 1024
               and (sched.data_ptr() + 4 * off) % 16 == 0,
               "bulk_copy: the copy must be 16-byte aligned, a multiple of 16 bytes, <= 227 KB")
    out = torch.empty_like(x)
    _lib.call("mpf_probe_bulk_copy", sched.data_ptr(), off, count, x.data_ptr(),
              out.data_ptr(), x.numel())
    _lib.counted_launch("probe_bulk_copy")
    return out


# --------------------------------------------------------------------------
# 16c: strided row reads through a ring
# --------------------------------------------------------------------------

def row_ring_target(nrows: int, depth: int) -> int:
    """The read that lands last in slot 0: the largest i < nrows with
    i mod depth == 0."""
    return (nrows - 1) // depth * depth


def _rows2d(src):
    """The (n, w) rows of the tool's (n, 1, w) fp32 array."""
    _lib.check(src.dim() == 3 and src.shape[1] == 1 and src.dtype == torch.float32,
               "row_ring: an (n, 1, w) fp32 array")
    return src.view(src.shape[0], src.shape[2])


def row_ring_plain(src, nrows: int, depth: int, stride: int = ROW_STRIDE):
    """Plain version of :func:`row_ring`."""
    _lib.counted_plain("probe_row_ring")
    a = _rows2d(src)
    i = row_ring_target(nrows, depth)
    return a[(i * stride) % a.shape[0]].reshape(1, -1).clone()


def row_ring(src, nrows: int, depth: int, stride: int = ROW_STRIDE):
    """Reads rows ``(i * stride) mod n``, i < nrows, of the (n, 1, w) fp32
    array ``src`` through a ring of ``depth`` slots and returns (1, w): the
    row of :func:`row_ring_target`, the last one read into slot 0.  On the
    card every row is read (``mpf_probe_row_ring``: 4 KB row chunks, ``depth``
    in flight a block, one block a multiprocessor); depth <= 48, w % 4 == 0.
    CPU tensors take the plain version."""
    a = _rows2d(src)
    _lib.check(nrows > 0 and depth > 0, "row_ring: nrows and depth must be positive")
    if not _lib.on_cuda(src):
        return row_ring_plain(src, nrows, depth, stride)
    _lib.check(depth <= 48 and a.shape[1] % 4 == 0 and a.stride(1) == 1
               and a.stride(0) % 4 == 0 and a.data_ptr() % 16 == 0 and nrows * stride < 2**32,
               "row_ring: depth <= 48, 16-byte aligned rows of w % 4 == 0 elements, "
               "nrows * stride < 2^32")
    out = torch.empty((1, a.shape[1]), dtype=torch.float32, device=a.device)
    _lib.call("mpf_probe_row_ring", a.shape[0], a.shape[1], a.data_ptr(), a.stride(0), nrows,
              stride, depth, row_ring_target(nrows, depth), out.data_ptr())
    _lib.counted_launch("probe_row_ring")
    return out


# --------------------------------------------------------------------------
# 16d: GEMM steps with reads streamed beside them
# --------------------------------------------------------------------------

def overlap_chunks(extra_mb: float, a) -> int:
    """Chunks of OVERLAP_G rows of ``a`` a step for ``extra_mb`` MB/step,
    rounded down as the tool rounds."""
    return int(extra_mb * 1e6 / (OVERLAP_G * a.shape[1] * 2))


def _overlap_check(l, u, a, steps):
    _lib.check(l.dim() == 2 and u.dim() == 2 and l.shape[1] == u.shape[0]
               and l.dtype == BF and u.dtype == BF, "overlap: bf16 l (ti, kk) and u (kk, t)")
    _lib.check(a.dim() == 2 and a.dtype == BF and a.shape[0] > OVERLAP_G
               and a.shape[1] % 2 == 0 and steps > 0,
               f"overlap: a bf16 (rows > {OVERLAP_G}, even w) stream array and steps > 0")


def overlap_slack(l, u, steps: int) -> float:
    """How far two evaluations of :func:`overlap`'s sum can part when each
    sums d[0, 0]'s exact products in its own order: d within
    ``utils/oracle.sum_slack``'s 3 (K + 1) 2^-24 sum |l u| of each other, so
    the ``steps`` copies of it within ``steps`` times that, plus one
    rounding (2^-24 of |sum| <= steps (|d| + slack)) a step on each side."""
    with ieee_fp32():
        ad = float(l[:1].float().abs() @ u[:, :1].float().abs())
    sd = 3 * (l.shape[1] + 1) * 2.0 ** -24 * ad
    return steps * sd + steps * 2.0 ** -23 * steps * (ad + sd)


def overlap_blocks(l, u) -> int:
    """The blocks of :func:`overlap`: one a 128 x 128 tile of d."""
    return -(-l.shape[0] // OVERLAP_TILE) * -(-u.shape[1] // OVERLAP_TILE)


def overlap_sink_plain(a, steps: int, xrows: int, blocks: int):
    """(blocks,) int32, :func:`overlap`'s checksum of the streamed bytes:
    step s's xrows chunks are cut into 16 KB pieces, piece p being piece
    p mod per_chunk of chunk p // per_chunk, dealt to block p mod blocks;
    entry b is the XOR of the first 32-bit word of every piece of block b
    over all steps."""
    words = a.contiguous().view(torch.int32).reshape(-1)
    per_chunk = -(-OVERLAP_G * a.shape[1] * 2 // OVERLAP_PIECE)
    pieces = xrows * per_chunk
    if pieces == 0:
        return torch.zeros(blocks, dtype=torch.int32, device=a.device)
    p = torch.arange(pieces, device=a.device)
    s = torch.arange(steps, device=a.device)[:, None]
    row0 = ((s * xrows + p // per_chunk) * OVERLAP_G) % (a.shape[0] - OVERLAP_G)
    w = words[row0 * (a.shape[1] // 2) + p % per_chunk * (OVERLAP_PIECE // 4)]
    pad = torch.zeros((steps, -pieces % blocks), dtype=torch.int32, device=a.device)
    w = torch.cat([w, pad], 1).reshape(-1, blocks)  # column b: block b's pieces
    while w.shape[0] > 1:
        if w.shape[0] % 2:
            w = torch.cat([w, torch.zeros_like(w[:1])])
        w = w[0::2] ^ w[1::2]
    return w[0]


def overlap_plain(l, u, a, steps: int, extra_mb: float):
    """Plain version of :func:`overlap`: d[0, 0] as an IEEE fp32 sum (the
    products of bf16 operands are exact), added ``steps`` times in order,
    and :func:`overlap_sink_plain`."""
    _lib.counted_plain("probe_overlap")
    _overlap_check(l, u, a, steps)
    with ieee_fp32():
        d00 = (l[:1].float() @ u[:, :1].float()).reshape(())
    acc = torch.zeros((), dtype=torch.float32, device=l.device)
    for _ in range(steps):
        acc = acc + d00
    sink = overlap_sink_plain(a, steps, overlap_chunks(extra_mb, a), overlap_blocks(l, u))
    return acc.reshape(1, 1), sink


def overlap(l, u, a, steps: int, extra_mb: float):
    """``steps`` repeats of ``d = l @ u`` (bf16 operands, fp32 sums).
    Returns the (1, 1) fp32 in-order sum of d[0, 0] over the steps, and the
    (blocks,) int32 checksum :func:`overlap_sink_plain` of the bytes
    streamed: each step also reads :func:`overlap_chunks` chunks of 16 rows
    of the bf16 stream array ``a`` at rows ``((step * xrows + j) * 16) mod
    (rows - 16)``.  On the card ``mpf_probe_overlap``: every tile of d on the
    tensor cores each step, kept in registers, each step's chunks streamed
    beside it by TMA bulk copies once the GEMM has begun that step.  CPU
    tensors take the plain version."""
    _overlap_check(l, u, a, steps)
    if not _lib.on_cuda(l, u, a):
        return overlap_plain(l, u, a, steps, extra_mb)
    l, u, a = l.contiguous(), u.contiguous(), a.contiguous()
    _lib.check(a.shape[1] % 8 == 0, "overlap: the stream array's rows must be 16-byte multiples")
    ti, kk = l.shape
    t = u.shape[1]
    dev = l.device
    blocks = overlap_blocks(l, u)
    keep = torch.empty(blocks * 256, dtype=torch.float32, device=dev)
    sink = torch.empty(blocks, dtype=torch.int32, device=dev)
    out = torch.empty((1, 1), dtype=torch.float32, device=dev)
    _lib.call("mpf_probe_overlap", ti, t, kk, l.data_ptr(), u.data_ptr(), keep.data_ptr(), steps,
              a.data_ptr(), a.shape[0], a.shape[1] * 2, OVERLAP_G, overlap_chunks(extra_mb, a),
              sink.data_ptr(), out.data_ptr())
    _lib.counted_launch("probe_overlap")
    return out, sink


# --------------------------------------------------------------------------
# the tool's legs
# --------------------------------------------------------------------------

def probe_smem(dev, sizes=SMEM_SIZES) -> list:
    """16a: the tool's schedule (arange) and x = 0 must give exp = 0 + ns/2
    + ns - 1; a random schedule (wrapping int32 sums) and x against the
    plain version, bitwise."""
    res = []
    gen = torch.Generator().manual_seed(16)
    for ns in sizes:
        sched = torch.arange(ns, dtype=torch.int32, device=dev)
        x = torch.zeros((8, 128), dtype=torch.float32, device=dev)
        out = sched_read(sched, x)
        val_ok = bool((out == float(0 + ns // 2 + ns - 1)).all())
        rs = torch.randint(-2**31, 2**31 - 1, (ns,), generator=gen, dtype=torch.int32).to(dev)
        rx = torch.randn((8, 128), generator=gen).to(dev)
        got, ref = sched_read(rs, rx), sched_read_plain(rs, rx)
        same = torch.equal(got, ref)
        ms = time_ms(lambda: sched_read(sched, x), dev, iters=5)
        pms = time_ms(lambda: sched_read_plain(sched, x), dev, iters=1, warmup=0)
        res.append(leg("probe_sched_read", f"smem ns={ns}", val_ok and same,
                       f"val_ok={val_ok} equals_plain={same}", ms=ms, plain_ms=pms,
                       nbytes=12 + 2 * x.numel() * 4, **errors(got, ref)))
    return res


def probe_hbm2smem(dev, ns: int = HBM2SMEM_NS, count: int = HBM2SMEM_C) -> list:
    """16b: the tool's schedule must give exp = C + 2C - 1; a random one
    against the plain version, bitwise."""
    sched = torch.arange(ns, dtype=torch.int32, device=dev)
    x = torch.zeros((8, 128), dtype=torch.float32, device=dev)
    out = bulk_copy(sched, x, count, count)
    val_ok = bool((out == float(count + 2 * count - 1)).all())
    gen = torch.Generator().manual_seed(17)
    rs = torch.randint(-2**31, 2**31 - 1, (ns,), generator=gen, dtype=torch.int32).to(dev)
    rx = torch.randn((8, 128), generator=gen).to(dev)
    got, ref = bulk_copy(rs, rx, count, count), bulk_copy_plain(rs, rx, count, count)
    same = torch.equal(got, ref)
    ms = time_ms(lambda: bulk_copy(sched, x, count, count), dev, iters=5)
    pms = time_ms(lambda: bulk_copy_plain(sched, x, count, count), dev, iters=1, warmup=0)
    return [leg("probe_bulk_copy", "hbm2smem", val_ok and same,
                f"val_ok={val_ok} equals_plain={same} (TMA bulk copy on an mbarrier)",
                ms=ms, plain_ms=pms, nbytes=4 * count + 2 * x.numel() * 4, **errors(got, ref))]


def probe_rowdma(dev, n: int = 32768, w: int = 8192, nrows: int = 8192,
                 depths=(4, 16, 32)) -> list:
    """16c: on random rows, out must be the row the tool's formula names and
    equal the plain version; the read rate against depth."""
    gen = torch.Generator(device=dev).manual_seed(18)
    src = torch.randn((n, 1, w), generator=gen, device=dev)
    rows = (torch.arange(nrows, device=dev) * ROW_STRIDE) % n
    res = []
    for depth in depths:
        out = row_ring(src, nrows, depth)
        named = src[(row_ring_target(nrows, depth) * ROW_STRIDE) % n]
        ref = row_ring_plain(src, nrows, depth)
        ok = torch.equal(out, named) and torch.equal(out, ref)
        ms = time_ms(lambda: row_ring(src, nrows, depth), dev, iters=5)
        pms = time_ms(lambda: row_ring_plain(src, nrows, depth), dev, iters=1, warmup=0)
        lib = time_ms(lambda: src.index_select(0, rows), dev)
        nb = nrows * w * 4
        per_row = rate(ms, lambda s: s / nrows * 1e6, "us/row", ".3f")
        gbs = rate(ms, lambda s: nb / s / 1e9, "GB/s read")
        res.append(leg("probe_row_ring", f"rowdma w={w} nrows={nrows} depth={depth}", ok,
                       f"{per_row}, {gbs}, exact={ok}", ms=ms, plain_ms=pms,
                       library=lib, nbytes=nb + w * 4, depth=depth, **errors(out, ref)))
    return res


def probe_overlap(dev, ti: int = 2048, t: int = 1024, kk: int = 1024, steps: int = 2048,
                  extra_mb=(0, 2, 4, 8, 16)) -> list:
    """16d: integer-valued bf16 operands in [-2, 2] (the tool's are ones),
    so d[0, 0] and the sum over the steps are exact in any order: the
    kernel's sum must equal the plain version's (which no extra MB/step
    changes), and its checksum of the streamed bytes (random values) must
    equal the plain version's; us/step and TF/s against extra MB/step."""
    gen = torch.Generator(device=dev).manual_seed(19)
    l = torch.randint(-2, 3, (ti, kk), generator=gen, device=dev).to(BF)
    u = torch.randint(-2, 3, (kk, t), generator=gen, device=dev).to(BF)
    a = torch.randn((OVERLAP_AW, OVERLAP_AW), generator=gen, device=dev).to(BF)
    flops = 2.0 * ti * kk * t * steps
    res = []
    for mb in extra_mb:
        out, sink = overlap(l, u, a, steps, mb)
        ref, ref_sink = overlap_plain(l, u, a, steps, mb)
        same_sink = torch.equal(sink, ref_sink)
        ok = torch.equal(out, ref) and same_sink
        chunk_bytes = OVERLAP_G * a.shape[1] * 2
        xbytes = steps * overlap_chunks(mb, a) * chunk_bytes
        ms = time_ms(lambda: overlap(l, u, a, steps, mb), dev, iters=1, warmup=0)
        pms = time_ms(lambda: overlap_plain(l, u, a, steps, mb), dev, iters=1, warmup=0)
        lib = time_ms(lambda: _overlap_library(l, u, a, steps, xbytes), dev, iters=1)
        us = rate(ms, lambda s: s / steps * 1e6, "us/step")
        tf = rate(ms, lambda s: flops / s / 1e12, "TF/s")
        xr = rate(ms, lambda s: xbytes / s / 1e9, "GB/s streamed")
        res.append(leg("probe_overlap", f"overlap extra={mb}MB/step", ok,
                       f"{us} ({tf}; {xr}) sum={float(out)} equals_plain={ok} "
                       f"checksum_equals_plain={same_sink}", ms=ms, plain_ms=pms, library=lib,
                       nbytes=xbytes + (l.numel() + u.numel()) * 2 + 4, bf16_ops=flops,
                       extra_mb=mb, extra_bytes=xbytes, **errors(out, ref)))
    return res


def _overlap_library(l, u, a, steps: int, xbytes: int):
    """``steps`` cuBLAS products on the current stream beside ``copy_`` of
    ``xbytes`` of ``a`` on a second one (which needs no cuBLAS workspace of
    its own)."""
    cur = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(cur)
    if xbytes:
        dst = torch.empty_like(a)
        with torch.cuda.stream(side):
            for _ in range(-(-xbytes // (a.numel() * 2))):
                dst.copy_(a)
    d = torch.empty((l.shape[0], u.shape[1]), dtype=BF, device=l.device)
    for _ in range(steps):
        torch.matmul(l, u, out=d)
    cur.wait_stream(side)


CMDS = {"smem": probe_smem, "hbm2smem": probe_hbm2smem, "rowdma": probe_rowdma,
        "overlap": probe_overlap}


def run(dev, cmds=None) -> list:
    res = []
    for name in cmds or CMDS:
        res += CMDS[name](dev)
    return res


def main(argv=None) -> int:
    p = parser(__doc__)
    p.add_argument("cmds", nargs="*", choices=sorted(CMDS), metavar="CMD",
                   help=f"any of {' '.join(CMDS)} (default: all)")
    args = p.parse_args(argv)
    dev = device(args.device)
    print(f"device={dev} ({torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'})",
          flush=True)
    return finish(run(dev, args.cmds))


if __name__ == "__main__":
    sys.exit(main())
