"""Operation and byte counts of the masked path's panel kernels, and the
metrics that read them.

The masked path (``make_mpf`` under a saturating panel cast, MPF_FP16)
factors each block column of ``block`` columns in r-wide panels: kernel 7
searches the panel's pivots in fp16, kernel 9 swaps the candidate rows,
kernel 8 refactors the r x r diagonal block without pivoting; after the
block column kernel 9 swaps the candidate rows of the columns outside it.
Each count below is taken from n, r and block alone, whatever kernel does
the work, and is held against the published peaks by
:func:`benchmark_torch.yardstick.roofline_s` (the fp32 CUDA-core rate:
none of the three uses the tensor cores).  A panel starting at row j0 has
m = n - j0 active rows and width rp (r, or the block column's remainder):

* kernel 7, the pre-pivot search: a partial-pivoted LU of the (m, rp)
  panel, per column j the m - j - 1 multipliers (one divide each) and the
  rank-1 update of the (m - j - 1) x (rp - j - 1) block beside them (a
  multiply and a subtract each): sum over j of (m - j - 1)(1 + 2(rp - j -
  1)), about m rp^2; bytes: the fp16 panel's active rows read once, 2 m rp;
* kernel 8, the no-pivot LU of the rp x rp diagonal block with L^-1 and
  U^-1: 4 rp^3 / 3 (2 rp^3 / 3 for the LU, rp^3 / 3 for each inverse);
  bytes: the block read once and LU, L^-1 and U^-1 written once, 4 rp^2
  storage elements;
* kernel 9, the row exchange: every candidate row read and written once,
  no arithmetic: 2 rp rows of the block column's width bc after each
  panel, and 2 bc rows of the n - bc columns outside the block column
  after each block column.

The readers take kernel time from the device trace by kernel name (read
from an H100 trace: kernel 7 ``hgetf2_kernel``, kernel 8
``npv_tile_kernel`` for r <= 128 and ``npv_wide_kernel`` beyond, kernel 9
``csrc/laswp.cu``'s gather, ``rows::gather_kernel`` of ``csrc/common.cuh``,
and its own ``scatter_kernel``).  Kernel 9's gather is one template with
kernel 4's and kernel 11's gathers; where their scatters ran in the trace,
kernel 9 cannot be told apart and its readers return None.
"""

from __future__ import annotations

from benchmark_torch.yardstick import DTYPE_BYTES, roofline_s

#: kernel 7 (csrc/hgetf2.cu)
PREPIVOT = (r"\bhgetf2_kernel\b",)
#: kernel 8 (csrc/npv.cu)
NPV = (r"\bnpv_tile_kernel\b", r"\bnpv_wide_kernel\b")
#: kernel 9 (csrc/laswp.cu): the gather, then the scatter of
#: ``(int, E*, long long, const int*, const E*)``
LASWP = (r"rows::.*\bgather_kernel\b",
         r"\bscatter_kernel<[^<>]*>\(int, unsigned (int|short)\*")
#: the scatters of kernel 4 (csrc/exchange.cu) and kernel 11 (csrc/rows.cu,
#: ``(int, int, E*, ...)``), which run beside the same gather
FOREIGN = (r"\bscatter_band_kernel\b", r"\bscatter_kernel<[^<>]*>\(int, int, ")
#: the peak the three kernels are held to (CUDA cores, fp32)
PEAK = "float32"


def panels(n: int, r: int, block: int) -> list:
    """``(j0, rp, bc)`` of every r-panel the masked path factors: the
    panel's first row and column, its width, its block column's width (a
    1 x 1 panel at the matrix's end is left alone)."""
    out = []
    for k in range(0, n, block):
        bc = min(block, n - k)
        if n - k <= 1:
            break
        for j0 in range(k, k + bc, r):
            rp = min(r, k + bc - j0)
            if n - j0 <= 1:
                break
            out.append((j0, rp, bc))
    return out


def prepivot_work(n: int, r: int, block: int) -> list:
    """(flops, bytes) of kernel 7's launches, one a panel."""
    out = []
    for j0, rp, _ in panels(n, r, block):
        m = n - j0
        flops = sum((m - j - 1) * (1 + 2 * (rp - j - 1)) for j in range(rp))
        out.append((float(flops), 2.0 * m * rp))
    return out


def npv_work(n: int, r: int, block: int, storage: str = "float32") -> list:
    """(flops, bytes) of kernel 8's launches, one a panel."""
    sb = DTYPE_BYTES[storage]
    return [(4.0 * rp ** 3 / 3.0, 4.0 * sb * rp * rp) for _, rp, _ in panels(n, r, block)]


def laswp_work(n: int, r: int, block: int, storage: str = "float32") -> list:
    """(flops, bytes) of kernel 9's exchanges: one a panel over its block
    column, then one a block column over the columns outside it."""
    sb = DTYPE_BYTES[storage]
    out = [(0.0, 2.0 * sb * 2 * rp * bc) for _, rp, bc in panels(n, r, block)]
    for k in range(0, n, block):
        bc = min(block, n - k)
        if n - k <= 1:
            break
        if n - bc > 0:
            out.append((0.0, 2.0 * sb * 2 * bc * (n - bc)))
    return out


def bound_s(work: list) -> float:
    """The least time of ``work``'s launches on the chip, each bound by its
    own operations or bytes."""
    return sum(roofline_s(f, b, PEAK) for f, b in work)


def _ms(run, patterns):
    """Device ms per traced factorization of the kernels ``patterns``
    name; None without a trace or where none ran."""
    t = run.trace
    s = t.seconds(patterns) if t is not None else None
    return s / t.count * 1e3 if s is not None else None


def _laswp_ms(run):
    t = run.trace
    if t is not None and t.seconds(FOREIGN) is not None:
        return None
    return _ms(run, LASWP)


def _share(ms, work) -> float | None:
    return None if ms is None else 100.0 * bound_s(work) * 1e3 / ms


def _shape(run) -> tuple:
    c = run.config
    return c["n"], c["make_mpf"]["r"], c["make_mpf"]["block"]


def masked_panel_ms(run):
    """Device ms per factorization of kernels 7, 8 and 9."""
    parts = [_ms(run, PREPIVOT), _ms(run, NPV), _laswp_ms(run)]
    return None if None in parts else sum(parts)


def prepivot_roofline(run):
    """Kernel 7's least time (:func:`prepivot_work`) over its device time,
    in percent."""
    return _share(_ms(run, PREPIVOT), prepivot_work(*_shape(run)))


def npv_roofline(run):
    """Kernel 8's least time (:func:`npv_work`) over its device time, in
    percent."""
    return _share(_ms(run, NPV), npv_work(*_shape(run), run.config["storage"]))


def laswp_roofline(run):
    """Kernel 9's least time (:func:`laswp_work`) over its device time, in
    percent."""
    return _share(_laswp_ms(run), laswp_work(*_shape(run), run.config["storage"]))
