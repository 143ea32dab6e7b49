"""GPU smoke test of the PyTorch port (mpf_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, one line each:
  1. device check and the kernel build (nvcc, sm_90a, one process per
     source, all started together) from csrc/; what ptxas -v said of the
     FFMA routine's four kernels (kernels 6 and 13, 16- and 4-byte
     copies), the L21 pass's four (kernels 3 and 12: fp32 and bf16, TMA
     and per-thread copies) and kernel 5's two printed, and no spill
     required (the Hopper routine's kernels printed too); the same for
     the panel kernels: kernel 1's twelve instances, kernel 2's two
     launches in both dtypes, kernel 7's ten and kernel 8's three;
  2. kernels 1-6 of the fused path against their plain PyTorch versions on
     the card, at the fused path's shapes (n = 16384, r = 128, block 1024,
     MPF_BF16); kernel 6's bf16-operand instance (the Hopper TMA + wgmma
     routine) printed with its TF/s and share of the 989 TFLOP/s bf16 peak
     beside the library call's time; kernel 3's fp32-operand update timed
     beside one addmm_ over as many rows; kernel 6's fp32 instance (the
     FFMA routine of gemm_ffma.cuh) at 15360^2 x 1024 on fp32 operands:
     the update against the fp64 product past half an ulp of the stored
     result (1e-5 relative), everything outside the trailing block exact,
     and the same update as four calls on quadrants split at a row and a
     column that are no tile multiple bitwise equal; its TF/s and share
     of the 67 TFLOP/s fp32 peak printed beside addmm_ and the bound;
  2b. kernels 7, 8, 8b and 9 of the masked path against their plain
     versions at the masked path's shapes (m = 16384, r = 128; the slab
     (16384, 1024) and the whole matrix for the row exchange); kernel 7
     exact, kernel 8's LU and L^-1 bitwise at r = 128; kernels 7, 8 and 8b
     also timed on the device alone (CUDA graph replays) beside their
     wrappers, kernel 8b beside lu_factor_ex, and kernel 7 beside its
     chain floor (r grid barriers as phase 2 timed one alone);
  2c. the bf16-storage instances (ALL_BF16) against their plain versions at
     the fused path's shapes: kernels 1, 4 and 5 exact (kernel 5, here and
     in phase 2, and kernel 12's two passes also timed on the device alone
     by CUDA graph replays, beside the library calls the same way: their
     wrapper's time is the host's where issuing takes longer; kernel 12's
     update pass in both instances of the Hopper routine, C through shared
     memory and C in registers, bitwise equal and timed in turns, and the
     L21 pass beside torch.matmul and its FFMA floor); kernel 2's LU and
     kernel 12's L21 pass within one bf16 ulp, info exact; kernel 2's U12
     and U^-1, kernel 12's update pass (fed the kernel's own L21) and
     kernel 6 within one bf16 ulp plus the bound on two fp32 sums of the
     same products in other orders (utils/oracle.py: sum_slack,
     tri_inv_slack), which exceeds an ulp where the result cancels, on
     several seeds, printing the largest share of that bound used; frozen
     rows and the columns left of the panel exact, and a copy without the
     update pass shown to fail; kernel 6's bf16-C instance's TF/s and share
     of the bf16 peak printed; kernel 6's two bf16-C instances (C through
     shared memory, the wrapper's choice; C in registers) bitwise equal at
     15360^2 x 1024 and timed in turns there and at 64512^2 x 1024, C
     through shared memory required faster than C in registers at 15360;
  2h. (run after 2c) kernel 17, the trailing update's U12 under bf16
     storage, at (1024 x 1024) @ (1024 x w), w = 64512, 31744, 1024, on a
     view of a wider matrix: within one bf16 ulp plus sum_slack of its plain
     version and at least 99.9% bit-equal, the matrix untouched; timed,
     and on the device alone, beside its bound, the plain version (the IEEE
     fp32 cuBLAS route) and PyTorch's bf16 matmul;
  3. the fused path: mpf_factorize at n = 16384, MPF_BF16, r = 128 on the
     HPL-AI matrix and on the uniform (pivot-heavy) matrix: device fp64
     oracle (nbe <= 1e-3), perm consistent with ipiv, kernels 1-6 launched
     and no plain version called in the run, and the median of 3 timed runs;
  4. the masked path: MPF_FP16 at n = 16384, r = 128 on both matrices
     (nbe <= 5e-4, kernels 5-9 launched, 1-4 and 8b not, no plain version,
     median of 3); MPF_BF16 at n = 4096, r = 48, block 1000 (uniform, nbe
     <= 1e-3); pivot=False under PURE_FP32 at n = 16384 (HPL-AI, ipiv the
     identity, nbe <= 1e-5);
  5. ALL_BF16 (bf16 working storage) on the fused path at n = 16384 on both
     matrices: device oracle (nbe <= 5e-2), the exact launch counts of
     kernels 1, 2, 12, 4, 5, 6, 17 and no other, every launch of kernel 6 with
     C through shared memory (``_lib.trailing_instances``), median of 3
     beside phase 3's;
  5b. ALL_BF16 at n = 65536 (HPL-AI made on the card in bf16): one timed
     factorization, launch counts (kernel 6's by instance, as in 5),
     oracle, peak device memory;
  5c. ALL_BF16 masked at n = 4096, r = 48, block 1000 (uniform): kernels 7
     and 9 launched, kernel 8 not;
  5d. ALL_BF16 pivot=False at n = 4096 (HPL-AI): ipiv the identity;
  2d. (run after 2c) kernel 13, the trailing GEMM with the next block
     column's row exchange inside it, at block column 0 of n = 16384 (m =
     15360, w = 14336, K = 1024, 1024 band rows), each instance (bf16
     operands and fp32 C, fp32 operands, bf16 C) bitwise equal to kernel 6
     on the same region followed by kernel 4, and against its plain version
     (fp32 C: 1e-6 of max |a|; bf16 C: one bf16 ulp plus sum_slack), the
     bf16-operand instances' TF/s and share of the bf16 peak printed, the
     FFMA instance's TF/s and share of the fp32 peak beside the library
     call and the bound;
     kernel 11's gather, scatter from the band and scatter of values
     bitwise equal to their plain versions, fp32 and bf16 (kernel 11 is on
     no driver path: its row reports these launches and 0 a
     factorization);
  3b. (run after 5d, before 6) MPF_REF on the fused path at n = 16384, r =
     128 on both matrices (kernels 3 and 6 with fp32 operands: the FFMA
     routine), then the lookahead driver (kernel 13's FFMA instance):
     device oracle (nbe <= 1e-5), the exact launch counts, no plain call,
     no operand copy, lookahead's pivots and row map equal to the classic
     loop's on HPL-AI, whether the factors are bitwise equal printed,
     median of 3 each;
  6. the lookahead driver (kernel 13) under MPF_BF16 at n = 16384 on both
     matrices: device oracle, the exact launch counts, HPL-AI pivots and
     row map equal to phase 3's, the uniform matrix's first pivot that
     differs from phase 3's printed, median of 3 beside phase 3's;
  6b. lookahead under ALL_BF16 at n = 16384 (both matrices, beside phase 5)
     and at n = 65536 on HPL-AI (one timed run beside 5b's, launch counts,
     oracle, peak memory);
  2e. (run after 2d) kernel 14 at the deferred exchange's shapes (n =
     16384, S = 8, block 1024): the band copy of 1024 rows and a flush of
     8192 overflow slots with 4096 live rows, fp32 and bf16, bitwise equal
     to their plain versions; kernel 10 (tests only) on the uniform slab's
     panels at jj0 = 0 and 384, m = 16384, bc = 1024, r = 128, each
     instance (fp32 slab with bf16 or fp32 update operands, bf16 slab) held
     as phases 2 and 2c hold kernels 3 and 12, frozen rows and the columns
     left of the panel exact, and the fp32-operand instance bitwise equal
     to kernel 3 (the same sum order);
  7. the deferred exchange, defer = 8 under MPF_BF16 at n = 16384 on both
     matrices: factors, pivots and row map bitwise equal to phase 3's, the
     exact launch counts (16 band copies, 2 flushes), oracle, median of 3;
  7b. defer = 8 under ALL_BF16 at n = 65536 on HPL-AI through the
     pre-extended (n + 8192, n) input made on the card: one timed run beside
     5b's, pivots and row map equal to 5b's, launch counts, oracle, peak
     memory;
  2f. (run after 2e) kernels 15a-15d of the pair-layout driver at block
     column 0 of n = 16384 (m = 16384, bc = 1024, w = 15360), fp32 and
     bf16: the slab extract, writeback and band write bitwise equal to
     their plain versions, rows_exchange3 and trailing_sub3 (kernels 4 and
     6 on the pair tensor) bitwise equal to the plain exchange and to
     kernel 6 on the 2D view (trailing_sub3 with bf16 operands and, on the
     fp32 matrix, with fp32 operands too, each timed); the in-place U12 within one working-dtype ulp of
     its plain version plus sum_slack (the largest share of that bound used
     printed), with L^-1 from the uniform matrix's first block column;
  8. the pair-layout (n/2, 2, n) driver at n = 16384, MPF_BF16 beside
     phase 3 and ALL_BF16 beside phase 5, on their matrices viewed as pairs:
     device oracle, the exact launch counts, no plain call, HPL-AI pivots
     and row map equal to the 2D loop's, the uniform matrix's first pivot
     that differs printed, the max |lu - 2D lu| printed, median of 3.  The
     factors need not equal the 2D loop's bit for bit: kernel 15d sums U12
     in ascending order with FMA, and cuBLAS need not;
  8b. the pair layout under ALL_BF16 at n = 65536 on HPL-AI from
     hpl_ai_matrix_device(pairs=True) (5b's matrix bit for bit): one timed
     run beside 5b's, pivots and row map equal to 5b's, launch counts,
     oracle, resident and peak memory;
  2g. (run after 2f, before 3) kernels 16a-16k, the tools/ probes: every
     module of mpf_tpu_torch/tools run as its entry point runs it, at the
     TPU tools' default shapes, with the counts set to 0 before and read
     after (each probe kernel launched); every leg applies the TPU tool's
     own exactness check and holds the kernel to its plain version
     (bitwise, or for 16d on integer operands, 16h and 16k within one bf16
     ulp plus sum_slack or 1e-6 of max |ref| for fp32) and prints the
     card's answer (us/row and GB/s against ring depth, us/step and TF/s
     against extra MB/step, ns/visit, ns/entry, TF/s); every tensor freed
     before phase 3.
Every phase at n = 65536 prints the device memory resident before it.
Every factorization phase prints the bf16 GEMM operands that kernels 6 and
13 had to copy because TMA could not read them in place (operand_copies),
and requires 0.
Then the card's name and power limit, one JSON line of per-kernel results
(times, errors against the plain version, launches in the main path's run,
the least time the card could take and the time of a PyTorch call that
computes the same function, where one exists), and as the last line the
contract line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failure exits nonzero before that line.  No JAX is imported.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

SLICE_N, SLICE_R, SLICE_BC = 16384, 128, 1024
NBE_TOL = 1e-3       # the JAX package's MPF_BF16 oracle bound
NBE_TOL_FP16 = 5e-4  # its MPF_FP16 bound (tests/test_mpf.py:70-72)
NBE_TOL_FP32 = 1e-5  # its fp32-GEMM bound
NBE_TOL_BF16 = 5e-2  # its ALL_BF16 bound (tests/test_panel_fused.py:441-443)
BIG_N = 65536        # the size the JAX package runs ALL_BF16 at (bench.py)
# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): bytes/s of HBM3, fp32
# FLOP/s outside the tensor cores, bf16 FLOP/s on the tensor cores
HBM_BPS, FP32_FLOPS, BF16_FLOPS = 3.35e12, 67e12, 989e12
FUSED = ("strip_pivots", "rowblock", "panel_update", "rows_exchange", "tri_inv",
         "trailing_sub")
MASKED = ("tri_inv", "trailing_sub", "hgetf2", "npv_inv", "laswp")
# ALL_BF16: kernel 12 takes kernel 3's place; the masked path's bf16
# diagonal is PyTorch ops, not kernel 8
FUSED_BF16 = ("strip_pivots", "rowblock", "l21_trim", "upd_wide", "rows_exchange",
              "tri_inv", "trailing_sub")
MASKED_BF16 = ("tri_inv", "trailing_sub", "hgetf2", "laswp", "u12_product")
ROWS11 = ("rows_gather", "rows_scatter")  # kernel 11, on no driver path
DEFER = ("copy_rows", "flush_overflow")  # kernel 14, the deferred exchange
DEFER_S = 8                              # its group size in phases 7 and 7b
PAIRS = ("slab_extract", "slab_writeback", "band_write", "u12_inplace")  # 15a-15d
# 16a-16k, the tools/ probes, and the TPU pallas_call each replaces
PROBES = {
    "probe_sched_read": "tools/tpu_probe_r4.py:48",
    "probe_bulk_copy": "tools/tpu_probe_r4.py:83",
    "probe_row_ring": "tools/tpu_probe_r4.py:142",
    "probe_overlap": "tools/tpu_probe_r4.py:215",
    "probe_window_rmw": "tools/tpu_granule_r5.py:122",
    "probe_window_gather": "tools/tpu_granule_r5.py:149",
    "probe_relayout": "tools/tpu_3d_micro.py:65",
    "probe_gemm3d": "tools/tpu_3d_micro.py:107",
    "probe_xsel": "tools/tpu_xsel_micro.py:120",
    "probe_refview": "tools/tpu_refview_r5.py:79",
    "probe_dot": "tools/tpu_crash_bisect_r5.py:42",
}
BF = torch.bfloat16


def fused_counts(n: int, r: int, bc: int, bf16: bool = False, lookahead: bool = False,
                 defer_s: int = 0, pairs: bool = False) -> dict:
    """Launches of one fused factorization of an n x n matrix, stated from
    the algorithm: every panel runs kernels 1 and 2 and B (kernel 3; under
    ALL_BF16 kernel 12's L21 pass, and its update pass on every panel but
    the last of its block column), every block column one exchange (kernel
    4), every block column but the last one kernel-5 launch and one
    trailing GEMM.
    Lookahead: block column 0 and the last one exchange on their own, the
    others inside kernel 13, which runs once for each block column with a
    wide part left (all but the last two); kernel 6 runs the narrow parts.
    Deferred exchange in groups of ``defer_s`` block columns: kernel 4
    still runs in every block column (its eager part), kernel 14's band
    copy in every block column and its flush once a group.  Pair layout:
    every block column one slab extract, one writeback and one band write
    beside its kernel 4, and every block column but the last one in-place
    U12 beside its kernels 5 and 6.  Under ALL_BF16 every U12 product of
    the trailing updates is kernel 17: one for every block column but the
    last, and with lookahead one more for each wide part; the pair layout
    computes its U12 in place (15d) instead."""
    panels, cols = n // r, n // bc
    c = {"strip_pivots": panels, "rowblock": panels, "rows_exchange": cols,
         "tri_inv": cols - 1, "trailing_sub": cols - 1}
    if bf16:
        c.update(l21_trim=panels, upd_wide=panels - cols)
        if not pairs:
            c["u12_product"] = cols - 1 + (cols - 2 if lookahead else 0)
    else:
        c["panel_update"] = panels
    if lookahead:
        c.update(rows_exchange=2, gemmx=cols - 2)
    if defer_s:
        c.update(copy_rows=cols, flush_overflow=-(-cols // defer_s))
    if pairs:
        c.update(slab_extract=cols, slab_writeback=cols, band_write=cols, u12_inplace=cols - 1)
    return c


def bound(nbytes: float, fp32_ops: float = 0.0, bf16_ops: float = 0.0):
    """Least milliseconds the card could take: the larger of the bytes over
    the HBM rate and the operations over the peak rate of their type."""
    t_bytes = nbytes / HBM_BPS
    t_ops = fp32_ops / FP32_FLOPS + bf16_ops / BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


class SmokeError(RuntimeError):
    pass


def fail(msg: str):
    raise SmokeError(msg)


def phase(name: str, ok: bool, **fields) -> None:
    parts = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[{'PASS' if ok else 'FAIL'}] {name} {parts}", flush=True)
    if not ok:
        fail(f"phase {name} failed")


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def live_cuda_tensors(top: int = 5):
    """GiB of the distinct CUDA storages that Python objects hold, and the
    ``top`` largest as (GiB, shape, dtype): who owns the resident memory."""
    import gc
    seen = {}
    for o in gc.get_objects():
        if torch.is_tensor(o) and o.is_cuda:
            st = o.untyped_storage()
            seen.setdefault(st.data_ptr(), (st.nbytes() / 2**30, tuple(o.shape), str(o.dtype)[6:]))
    big = sorted(seen.values(), key=lambda v: -v[0])
    return sum(v[0] for v in big), [(round(g, 3), sh, dt) for g, sh, dt in big[:top]]


def dyadic(rng, m, r):
    a = (rng.integers(-4, 5, (m, r)) * 2.0 ** rng.integers(-2, 3, (m, r))).astype(np.float32)
    a[a == 0] = 1.0
    return a


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    try:
        import mpf_tpu_torch as T
    except ModuleNotFoundError:
        print("chip_smoke: the mpf_tpu_torch package is not importable; run this script "
              "from the root of the repository", file=sys.stderr)
        return 2
    from mpf_tpu_torch.ops import _lib
    from mpf_tpu_torch.models.mpf import _factor_block_column_fused
    from mpf_tpu_torch.ops.blas3 import (
        _leaves, tri_inv_leaves, tri_inv_leaves_plain, u12_product,
        u12_product_plain, unit_lower_inv_blocked)
    from mpf_tpu_torch.ops.exchange import (
        copy_rows_block, copy_rows_block_plain, flush_overflow, flush_overflow_plain,
        rows_exchange, rows_exchange3, rows_exchange_plain)
    from mpf_tpu_torch.ops.gemmx import gemm_trailing, gemm_trailing_plain
    from mpf_tpu_torch.ops.panel_fused import (
        l21_trim, l21_trim_plain, panel_apply_update, panel_apply_update_plain,
        panel_apply_update_trim, panel_apply_update_trim_plain,
        rowblock_assemble, rowblock_assemble_plain, rows_gather, rows_gather_plain,
        rows_scatter_from_band, rows_scatter_from_band_plain, rows_scatter_inplace,
        rows_scatter_inplace_plain, _trailing_launch, trailing_gemm_sub,
        trailing_gemm_sub_plain, trailing_staged, upd_wide, upd_wide_plain)
    from mpf_tpu_torch.ops.pair3d import (
        as_matrix, band_write_rows, band_write_rows_plain, slab_extract, slab_extract_plain,
        slab_writeback, slab_writeback_plain, trailing_sub3, u12_transform, u12_transform_plain)
    from mpf_tpu_torch.ops.panel_pallas import (
        getf2_npv_block, getf2_npv_inv_block, getf2_npv_inv_plain, hgetf2_panel_plain,
        hgetf2_panel_swaps, laswp_apply, laswp_plain)
    from mpf_tpu_torch.ops.panel_strip import (
        SENT, barrier_probe, exchange_polls, strip_panel_pivots, strip_panel_pivots_plain)
    from mpf_tpu_torch.precision import cast_to_panel
    from mpf_tpu_torch.utils import matgen
    from mpf_tpu_torch.utils.oracle import (
        check_factorization_device, ipiv_to_perm, sum_slack, tri_inv_slack, within_bf16_ulp,
        within_ulp)
    from mpf_tpu_torch.utils.timing import cuda_time, event_ms, graph_ms, tflops

    dev = torch.device("cuda", 0)
    wall0 = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = smi_line()
    print(f"device: {kind} count={count} torch={torch.__version__} "
          f"cuda={torch.version.cuda} smi='{smi}'", flush=True)
    t0 = time.perf_counter()
    so = _lib.build()
    _lib.lib()
    phase("build", True, lib=so.name, seconds=f"{time.perf_counter() - t0:.1f}")
    # the FFMA routine's kernels (kernel 6 and 13, 16- and 4-byte copies),
    # the L21 pass of kernels 3 and 12 (fp32 and bf16, TMA and copies) and
    # kernel 5 (fp32, bf16): what ptxas -v said of their registers, and no
    # spill; the Hopper routine's kernels (6, 12's update pass and 17)
    # printed
    want_regs = {"ffma": 4, "l21_kernel": 4, "tri_inv_kernel": 2}
    regs = {pat: _lib.ptxas_report(pat)
            for pat in (*want_regs, "trailing_kernel", "u12_product_kernel")}
    for pat, rep in regs.items():
        for name, v in sorted(rep.items()):
            print(f"[INFO] ptxas {name}: {json.dumps(v)}", flush=True)
    checked = [v for pat in want_regs for v in regs[pat].values()]
    phase("ffma_no_spill", all(len(regs[p]) == k for p, k in want_regs.items()) and all(
        v.get("spill_stores", 1) == 0 and v.get("spill_loads", 1) == 0 for v in checked),
          kernels=len(checked),
          registers="/".join(str(v.get("registers")) for p in want_regs
                             for _, v in sorted(regs[p].items())))
    # the panel kernels (twelve instances of kernel 1: slab and panel
    # dtypes, one to three rows a thread, and three with more rows in shared
    # memory; both launches of kernel 2, fp32 and bf16; kernel 7's ten: five
    # (panel, input) dtype pairs, with and without rows past the registers;
    # kernel 8's register-tile instances: without the inverses, and with
    # them and the back substitution):
    # registers, and no spill
    want_panel = {"strip_kernel": 12, "diag_kernel": 2, "tail_kernel": 2,
                  "hgetf2_kernel": 10, "npv_tile_kernel": 2}
    regs12 = {pat: _lib.ptxas_report(pat) for pat in want_panel}
    for pat, rep in regs12.items():
        for name, v in sorted(rep.items()):
            print(f"[INFO] ptxas {name}: {json.dumps(v)}", flush=True)
    checked12 = [v for rep in regs12.values() for v in rep.values()]
    phase("panel_no_spill", all(len(regs12[p]) == k for p, k in want_panel.items()) and all(
        v.get("spill_stores", 1) == 0 and v.get("spill_loads", 1) == 0 for v in checked12),
          kernels=len(checked12),
          registers="/".join(str(v.get("registers")) for v in checked12))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    n, r, bc = SLICE_N, SLICE_R, SLICE_BC
    kern = {}  # name -> result dict for the JSON line
    replaces = {
        "strip_pivots": "mpf_tpu/ops/panel_strip.py:373",
        "rowblock": "mpf_tpu/ops/panel_fused.py:93",
        "panel_update": "mpf_tpu/ops/panel_fused.py:931",
        "rows_exchange": "mpf_tpu/ops/exchange.py:88",
        "tri_inv": "mpf_tpu/ops/panel_pallas.py:466",
        "trailing_sub": "mpf_tpu/ops/panel_fused.py:687",
        "hgetf2": "mpf_tpu/ops/panel_pallas.py:51",
        "npv_inv": "mpf_tpu/ops/panel_pallas.py:219",
        "npv": "mpf_tpu/ops/panel_pallas.py:388",
        "laswp": "mpf_tpu/ops/panel_pallas.py:283",
        "l21_trim": "mpf_tpu/ops/panel_fused.py:806",
        "upd_wide": "mpf_tpu/ops/panel_fused.py:870",
        "rows_gather": "mpf_tpu/ops/panel_fused.py:394",
        "rows_scatter": "mpf_tpu/ops/panel_fused.py:582",
        "gemmx": "mpf_tpu/ops/gemmx.py:627",
        "copy_rows": "mpf_tpu/ops/exchange.py:676",
        "flush_overflow": "mpf_tpu/ops/exchange.py:432",
        "panel_update_full": "mpf_tpu/ops/panel_fused.py:286",
        "slab_extract": "mpf_tpu/ops/pair3d.py:90",
        "slab_writeback": "mpf_tpu/ops/pair3d.py:113",
        "band_write": "mpf_tpu/ops/pair3d.py:205",
        "u12_inplace": "mpf_tpu/ops/pair3d.py:281",
        "u12_product": "no pallas_call: mpf_tpu/models/mpf.py:545 (jnp.dot)",
        **PROBES,
    }
    source = {
        "strip_pivots": "mpf_tpu_torch/csrc/strip_pivots.cu",
        "rowblock": "mpf_tpu_torch/csrc/rowblock.cu",
        "panel_update": "mpf_tpu_torch/csrc/panel_update.cu",
        "rows_exchange": "mpf_tpu_torch/csrc/exchange.cu",
        "tri_inv": "mpf_tpu_torch/csrc/tri_inv.cu",
        "trailing_sub": "mpf_tpu_torch/csrc/gemm_sub.cu",
        "hgetf2": "mpf_tpu_torch/csrc/hgetf2.cu",
        "npv_inv": "mpf_tpu_torch/csrc/npv.cu",
        "npv": "mpf_tpu_torch/csrc/npv.cu",
        "laswp": "mpf_tpu_torch/csrc/laswp.cu",
        "l21_trim": "mpf_tpu_torch/csrc/l21_trim.cu",
        "upd_wide": "mpf_tpu_torch/csrc/l21_trim.cu",
        "rows_gather": "mpf_tpu_torch/csrc/rows.cu",
        "rows_scatter": "mpf_tpu_torch/csrc/rows.cu",
        "gemmx": "mpf_tpu_torch/csrc/gemmx.cu",
        "copy_rows": "mpf_tpu_torch/csrc/overflow.cu",
        "flush_overflow": "mpf_tpu_torch/csrc/overflow.cu",
        "panel_update_full": "mpf_tpu_torch/csrc/panel_update_full.cu",
        "u12_product": "mpf_tpu_torch/csrc/u12.cu",
        **{k: "mpf_tpu_torch/csrc/pair3d.cu" for k in PAIRS},
        **{k: "mpf_tpu_torch/csrc/probes.cu" for k in PROBES},
        "probe_overlap": "mpf_tpu_torch/csrc/probes_gemm.cu",
        "probe_dot": "mpf_tpu_torch/csrc/probes_gemm.cu",
        "probe_gemm3d": "mpf_tpu_torch/csrc/gemm_sub.cu",
    }

    def record(name, abs_err, rel_err, ms, plain_ms, bnd, library_ms, **extra):
        kern[name] = {"name": name, "route": "cuda", "source": source[name],
                      "replaces": replaces[name], "launches": 0,
                      "max_abs_err": float(abs_err),
                      "rel_err": None if rel_err is None else float(rel_err),
                      "ms": float(ms), "plain_ms": float(plain_ms),
                      "bound_ms": float(bnd[0]), "bound_by": bnd[1],
                      "library_ms": None if library_ms is None else float(library_ms),
                      **extra}

    def record_bf16(name, abs_err, ms, plain_ms, bnd, library_ms, **extra):
        """The bf16-storage (ALL_BF16) instance of a kernel recorded above."""
        kern[name]["all_bf16"] = {
            "max_abs_err": float(abs_err), "ms": float(ms), "plain_ms": float(plain_ms),
            "bound_ms": float(bnd[0]), "bound_by": bnd[1],
            "library_ms": None if library_ms is None else float(library_ms), **extra}

    def library(fn, reps: int = 5):
        """ms of a PyTorch call that computes a kernel's function, or None
        where this PyTorch build has no such call."""
        try:
            return event_ms(fn, reps)
        except (RuntimeError, TypeError, NotImplementedError) as exc:
            print(f"[INFO] library call unavailable: {exc}", flush=True)
            return None

    def rate(tag, ops, ms, library_ms, bnd=None):
        """Print a GEMM instance's TF/s and its share of the peak of its
        operation type (bf16 tensor cores; fp32 FFMA where the bound
        ``bnd`` is given) beside the library call's time; return the
        TF/s."""
        tf = ops / ms / 1e9
        peak, kind = (BF16_FLOPS, "bf16") if bnd is None else (FP32_FLOPS, "fp32")
        lib = ("none" if library_ms is None
               else f"{library_ms:.3f} ms, kernel / library {ms / library_ms:.2f}")
        extra = "" if bnd is None else f"; bound {bnd[0]:.3f} ms ({bnd[1]})"
        print(f"[INFO] {tag}: {ms:.3f} ms, {tf:.1f} TF/s, "
              f"{100 * tf * 1e12 / peak:.1f}% of the {peak / 1e12:.0f} TFLOP/s "
              f"{kind} peak; library {lib}{extra}", flush=True)
        return tf

    def panel_ops(m, off, r):
        """fp32 operations of an r-column pivoted panel LU whose diagonal
        is at row off of m rows: a divide and an update of the later
        columns for every row below each diagonal."""
        return sum((m - off - j - 1) * (1 + 2 * (r - j - 1)) for j in range(r))

    # ---------------- phase 2: kernels vs plain at the slice's shapes -------
    rng = np.random.default_rng(0)
    hpl = torch.from_numpy(matgen.hpl_ai_matrix(n, seed=1)).to(dev)
    slab0 = hpl[:, :bc].contiguous()           # first block column, m = n
    pos0 = torch.arange(n, dtype=torch.int32, device=dev)

    def polls_per_column(fn, reps=10):
        """Block 0's poll rounds a column of kernel 1 over ``reps`` calls
        of ``fn`` (r columns each): 1 when every candidate was there at the
        first read."""
        exchange_polls()
        for _ in range(reps):
            fn()
        return exchange_polls() / (reps * r)

    def piv_eq(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    def errs(pairs):
        """Largest absolute difference over (got, ref) pairs, and that
        difference over the largest |ref| entry."""
        a = max(float((g.double() - f.double()).abs().max()) for g, f in pairs)
        m = max(float(f.double().abs().max()) for _, f in pairs)
        return a, a / m

    # #1 exact piv/pos/glist: dyadic r=16 panel, both searches
    dy = torch.from_numpy(dyadic(rng, n, 16)).to(dev)
    for q16, pdt in ((True, torch.bfloat16), (False, torch.float32)):
        got = strip_panel_pivots(dy, 8, pos0, pdt, 0, 16, quant16=q16)
        ref = strip_panel_pivots_plain(dy, 8, pos0, pdt, 0, 16, quant16=q16)
        phase(f"k1_dyadic_r16_{'quant16' if q16 else 'exact'}", piv_eq(got, ref))
    # #1 exact on the HPL-AI panel at the slice's shape, both searches
    pairs1 = []
    for q16, pdt in ((True, torch.bfloat16), (False, torch.float32)):
        for jj0, off in ((0, 0), (384, 384)):
            got = strip_panel_pivots(slab0, off, pos0, pdt, jj0, r, quant16=q16)
            ref = strip_panel_pivots_plain(slab0, off, pos0, pdt, jj0, r, quant16=q16)
            pairs1 += zip(got, ref)
            phase(f"k1_hpl_{'quant16' if q16 else 'exact'}_jj0={jj0}", piv_eq(got, ref))
    # #1 on a uniform panel: report differing pivots (fp32 sum order may
    # differ inside the 8-term sums; the gate is the phase-3 oracle)
    uni = torch.from_numpy(matgen.random_dense(n, seed=2)[:, :bc].copy()).to(dev)
    got = strip_panel_pivots(uni, 0, pos0, torch.bfloat16, 0, r)
    ref = strip_panel_pivots_plain(uni, 0, pos0, torch.bfloat16, 0, r)
    ndiff = int((got[0] != ref[0]).sum())
    print(f"[INFO] k1_uniform_quant16 differing_pivots={ndiff} of {r}", flush=True)
    ms = event_ms(lambda: strip_panel_pivots(slab0, 0, pos0, torch.bfloat16, 0, r))
    pms = event_ms(lambda: strip_panel_pivots_plain(slab0, 0, pos0, torch.bfloat16, 0, r), 2)
    # the device times (CUDA graph replays) beside the wrapper's, bf16 and
    # fp32 panels; block 0's poll rounds a column; and what one exchange of
    # one block an SM costs alone (cooperative groups' grid.sync(), an
    # arrival counter, the counter with a read of the G keys behind it,
    # kernel 1's flagged slots, the slots behind a released record): r of
    # them a panel
    dms1 = graph_ms(lambda: strip_panel_pivots(slab0, 0, pos0, torch.bfloat16, 0, r))
    dms1f = graph_ms(lambda: strip_panel_pivots(slab0, 0, pos0, torch.float32, 0, r))
    polls1 = polls_per_column(lambda: strip_panel_pivots(slab0, 0, pos0, torch.bfloat16, 0, r))
    bar_iters = 2000
    bar_us = {kind: 1e3 * event_ms(lambda: barrier_probe(k, bar_iters), 3) / bar_iters
              for k, kind in enumerate(("grid_sync", "counter", "counter_and_keys", "slots",
                                        "slots_release"))}
    print(f"[INFO] k1 exchange alone, us: {json.dumps(bar_us)}; kernel 1 device "
          f"{dms1:.4f} ms bf16 panel, {dms1f:.4f} ms fp32 panel ({r} exchanges), "
          f"polls a column {polls1:.3f}", flush=True)
    # panel read once (fp32), positions read and written, pivots written
    record("strip_pivots", *errs(pairs1), ms, pms,
           bound(4 * n * r + 8 * n + 8 * r, panel_ops(n, 0, r)), None,
           device_ms=dms1, fp32_panel_device_ms=dms1f, barrier_us=bar_us,
           polls_per_column=polls1)

    # #2 and #3 on panels of the uniform slab, where L21 is O(1), so a
    # missing L11^{-1} or update GEMM moves the result by O(1), and on the
    # HPL-AI slab (L21 ~ 1e-4).  Each part a kernel writes is held against
    # the plain version relative to that part's own largest entry.
    def rel(got, ref):
        return float((got.double() - ref.double()).abs().max()
                     / ref.double().abs().max())

    def absd(got, ref):
        return float((got.double() - ref.double()).abs().max())

    err2 = err3 = abs2 = abs3 = 0.0
    for corpus, slab, jj0 in (("uniform", uni, 0), ("uniform", uni, 384), ("hpl", slab0, 0)):
        tag = f"{corpus}_jj0={jj0}"
        _, pos1, glist1 = strip_panel_pivots(slab, jj0, pos0, torch.bfloat16, jj0, r)
        rb_k, ui_k, info_k = rowblock_assemble(slab, glist1, jj0)
        rb_p, ui_p, info_p = rowblock_assemble_plain(slab, glist1, jj0)
        left_exact = torch.equal(rb_k[:, :jj0], rb_p[:, :jj0])
        e = max(rel(rb_k[:, jj0:jj0 + r], rb_p[:, jj0:jj0 + r]),
                rel(rb_k[:, jj0 + r:], rb_p[:, jj0 + r:]), rel(ui_k, ui_p))
        err2, abs2 = max(err2, e), max(abs2, absd(rb_k, rb_p), absd(ui_k, ui_p))
        phase(f"k2_rowblock_{tag}", e <= 1e-5 and left_exact
              and int(info_k) == int(info_p) == 0,
              rel_err=f"{e:.3e}", left_of_panel_exact=left_exact, info=int(info_k))

        below = pos1 >= jj0 + r
        u12 = rb_p[:, jj0 + r:]
        for gemm_bf16 in (True, False):
            s_k, s_p = slab.clone(), slab.clone()
            panel_apply_update_trim(s_k, pos1, rb_p, ui_p, jj0, jj0, gemm_bf16)
            panel_apply_update_trim_plain(s_p, pos1, rb_p, ui_p, jj0, jj0, gemm_bf16)
            untouched = (torch.equal(s_k[~below], slab[~below])
                         and torch.equal(s_k[:, :jj0], slab[:, :jj0]))
            l21_k = s_k[below, jj0:jj0 + r]
            e_l21 = rel(l21_k, s_p[below, jj0:jj0 + r])
            # the update, A[:, jj0+r:] - A_after, against L21 @ U12 in fp64
            # from the kernel's own L21 rounded as the plain version rounds
            # it: with bf16 operands a one-ulp fp32 difference in L21 can
            # flip a bf16 rounding, so the plain version's L21 is no
            # reference for the product at fp32 tolerance
            if gemm_bf16:
                ref = (l21_k.to(torch.bfloat16).double()
                       @ u12.to(torch.bfloat16).double())
            else:
                ref = l21_k.double() @ u12.double()
            after = s_k[below, jj0 + r:]
            upd_k = slab[below, jj0 + r:].double() - after.double()
            # storing A - update rounds to fp32: up to half an ulp of the
            # result (~2.4e-4 on the 4096 diagonal) is not the kernel's error
            mag = after.abs()
            half_ulp = (torch.nextafter(mag, torch.full_like(mag, float("inf")))
                        - mag).double() / 2
            e_upd = float(((upd_k - ref).abs() - half_ulp).clamp_min(0).max()
                          / ref.abs().max())
            e = max(e_l21, e_upd)
            err3, abs3 = max(err3, e), max(abs3, absd(s_k, s_p))
            phase(f"k3_panel_update_{tag}_{'bf16' if gemm_bf16 else 'fp32'}",
                  e <= 1e-5 and untouched, rel_err_l21=f"{e_l21:.3e}",
                  rel_err_update=f"{e_upd:.3e}", frozen_rows_untouched=untouched)
            del s_k, s_p
        if corpus == "uniform" and jj0 == 0:
            ms2 = event_ms(lambda: rowblock_assemble(slab, glist1, jj0))
            pms2 = event_ms(lambda: rowblock_assemble_plain(slab, glist1, jj0), 2)
            s_t = slab.clone()
            ms3 = event_ms(lambda: panel_apply_update_trim(s_t, pos1, rb_p, ui_p, 0, 0, True))
            pms3 = event_ms(lambda: panel_apply_update_trim_plain(s_t, pos1, rb_p, ui_p,
                                                                  0, 0, True))
            # the fp32-operand form (MPF_REF, PURE_FP32: the FFMA routine with
            # the row mask), and beside it the update alone as one addmm_
            # over as many rows as the mask leaves (n - r), not those rows
            ms3f = event_ms(lambda: panel_apply_update_trim(s_t, pos1, rb_p, ui_p, 0, 0,
                                                            False))
            pms3f = event_ms(lambda: panel_apply_update_trim_plain(s_t, pos1, rb_p, ui_p,
                                                                   0, 0, False))
            l21x = s_t[r:, :r].clone()
            lib3f = library(lambda: s_t[r:, r:].addmm_(l21x, rb_p[:, r:], alpha=-1))
            del s_t, l21x
            slab_z = slab.clone()
            g0, g1 = int(glist1[0]), int(glist1[1])
            # second pivot row := first pivot row, so the second pivot is 0
            slab_z[g1, :r] = slab_z[g0, :r]
            _, _, iz_k = rowblock_assemble(slab_z, glist1, 0)
            _, _, iz_p = rowblock_assemble_plain(slab_z, glist1, 0)
            phase("k2_rowblock_zero_pivot", int(iz_k) == int(iz_p) == 2,
                  info_kernel=int(iz_k), info_plain=int(iz_p))
            del slab_z
    # k2 at jj0 = 0: r pivot rows read, the row block and U11^-1 written;
    # LU 2r^3/3, L^-1 and U^-1 r^3/3 each, U12 2 r^2 (bc - r); its device
    # time (CUDA graph replays) beside the wrapper's
    glist_u = strip_panel_pivots(uni, 0, pos0, torch.bfloat16, 0, r)[2]
    dms2 = graph_ms(lambda: rowblock_assemble(uni, glist_u, 0))
    record("rowblock", abs2, err2, ms2, pms2,
           bound(4 * (2 * r * bc + r * r), 4 * r ** 3 / 3 + 2 * r * r * (bc - r)), None,
           device_ms=dms2)
    # k3 at jj0 = 0 (gemm_bf16): the rows below read and written; L21 in
    # fp32 (2 m r^2), the update on bf16 operands (2 m r (bc - r))
    m3 = n - r
    record("panel_update", abs3, err3, ms3, pms3,
           bound(8 * n * bc + 4 * r * bc, 2 * m3 * r * r, 2 * m3 * r * (bc - r)), None)
    b3f = bound(8 * n * bc + 4 * r * bc, 2 * m3 * r * r + 2 * m3 * r * (bc - r))
    kern["panel_update"].update(fp32_ms=ms3f, fp32_plain_ms=pms3f, fp32_bound_ms=b3f[0],
                                fp32_bound_by=b3f[1], fp32_update_addmm_ms=lib3f)
    print(f"[INFO] k3 fp32 operands (L21 + FFMA update): {ms3f:.4f} ms, plain "
          f"{pms3f:.4f} ms, bound {b3f[0]:.4f} ms ({b3f[1]}); the update alone as one "
          f"addmm_ over {m3} rows: {lib3f} ms; bf16 update {ms3:.4f} ms", flush=True)

    # #4 exchange at block column k=1024: bit-exact
    k = bc
    src = torch.from_numpy(rng.choice(np.arange(k, n), size=bc, replace=False)
                           .astype(np.int32)).to(dev)
    a_k, a_p = hpl.clone(), hpl.clone()
    pr_k = rows_exchange(a_k, k, src, src)
    pr_p = rows_exchange_plain(a_p, k, src, src)
    phase("k4_rows_exchange", torch.equal(pr_k, pr_p) and torch.equal(a_k, a_p))
    err4 = errs([(pr_k, pr_p), (a_k, a_p)])
    ms = event_ms(lambda: rows_exchange(a_k, k, src, src))
    pms = event_ms(lambda: rows_exchange_plain(a_p, k, src, src))
    src_l = src.long()
    band_rows = torch.arange(k, k + bc, device=dev)
    # index_select + index_copy_: the gather then the scatter of the rows
    lib4 = library(lambda: a_p.index_copy_(0, src_l, a_p.index_select(0, band_rows)))
    # bc pivot rows read and written, bc displaced band rows read and written
    record("rows_exchange", *err4, ms, pms, bound(4 * n * 4 * bc), lib4)
    del a_k, a_p

    # #5 tri-inv leaves of a 1024 block: bit-exact
    l11 = torch.tril(torch.from_numpy(rng.uniform(-0.5, 0.5, (bc, bc)).astype(np.float32)
                                      / 16).to(dev), -1)
    leaves = _leaves(bc, min(r, 128))
    t_k = tri_inv_leaves(l11, leaves)
    t_p = tri_inv_leaves_plain(l11, leaves)
    pairs5 = [(t_k[o:o + s, o:o + s], t_p[o:o + s, o:o + s]) for o, s in leaves]
    same = all(torch.equal(x, y) for x, y in pairs5)
    phase("k5_tri_inv", same, leaves=len(leaves))
    err5 = errs(pairs5)
    ms = event_ms(lambda: tri_inv_leaves(l11, leaves))
    pms = event_ms(lambda: tri_inv_leaves_plain(l11, leaves), 2)
    sz = leaves[0][1]
    stack = torch.stack([torch.tril(l11[o:o + s, o:o + s], -1)
                         + torch.eye(s, device=dev) for o, s in leaves])
    eye = torch.eye(sz, device=dev).expand_as(stack)
    trsm5 = lambda: torch.linalg.solve_triangular(stack, eye, upper=False, unitriangular=True)
    lib5 = library(trsm5)
    # the wrapper's ms above is the host's issue time where that exceeds the
    # kernel's: the device times of both, from CUDA graph replays
    dms5, dlib5 = graph_ms(lambda: tri_inv_leaves(l11, leaves)), graph_ms(trsm5)
    # each leaf read and its inverse written; ~s^3/3 operations per leaf
    record("tri_inv", *err5, ms, pms,
           bound(sum(8 * s * s for _, s in leaves), sum(s ** 3 / 3 for _, s in leaves)), lib5,
           device_ms=dms5, library_device_ms=dlib5)

    # #6 trailing GEMM at e = 1024 (bf16 operands, fp32 accumulation)
    e = bc
    l21 = (torch.rand((n - e, bc), device=dev) - 0.5).to(torch.bfloat16)
    u12 = (torch.rand((bc, n - e), device=dev) - 0.5).to(torch.bfloat16)
    a_k, a_p = hpl.clone(), hpl.clone()
    trailing_gemm_sub(a_k, l21, u12, e)
    trailing_gemm_sub_plain(a_p, l21, u12, e)
    err6 = float((a_k - a_p).abs().max())
    rel6 = err6 / float(a_p.abs().max())
    untouched = torch.equal(a_k[:e], hpl[:e]) and torch.equal(a_k[:, :e], hpl[:, :e])
    # fp32 sums of 1024 exact bf16 products in another order: a few ulps
    phase("k6_trailing_sub", rel6 <= 1e-6 and untouched, max_abs_err=f"{err6:.3e}",
          rel_err=f"{rel6:.3e}",
          outside_untouched=untouched)
    ms = event_ms(lambda: trailing_gemm_sub(a_k, l21, u12, e))
    pms = event_ms(lambda: trailing_gemm_sub_plain(a_p, l21, u12, e))
    c6 = a_p[e:, e:]
    lib6 = library(lambda: torch.addmm(c6, l21, u12, alpha=-1, out_dtype=torch.float32))
    mt = n - e
    tf6 = rate("k6 bf16 operands, fp32 C", 2 * mt * mt * bc, ms, lib6)
    record("trailing_sub", err6, rel6, ms, pms,
           bound(8 * mt * mt + 2 * 2 * mt * bc, 0, 2 * mt * mt * bc), lib6, tflops=tf6)
    del a_k, a_p, l21, u12, c6
    torch.cuda.empty_cache()

    # #6 fp32 instance (the FFMA routine; MPF_FP16, MPF_REF, PURE_FP32) at
    # e = 1024 on fp32 operands: the update against the fp64 product, past
    # half an ulp of the stored result, 1e-5 relative; everything outside the
    # trailing block exact; the same update as four calls on quadrants split
    # at a row and a column that are no tile multiple bitwise equal (each
    # entry is one fmaf chain in ascending k, whatever the tiling)
    gen = torch.Generator(device=dev).manual_seed(6)
    l21f = torch.rand((mt, bc), generator=gen, device=dev) - 0.5
    u12f = torch.rand((bc, mt), generator=gen, device=dev) - 0.5
    a_k = hpl.clone()
    _lib.reset_counts()
    trailing_gemm_sub(a_k, l21f, u12f, e)
    one6 = _lib.launches["trailing_sub"] == 1 and _lib.copies["gemm_operand"] == 0
    after = a_k[e:, e:]
    upd = hpl[e:, e:].double() - after.double()
    ref = l21f.double() @ u12f.double()
    mag = after.abs()
    half_ulp = (torch.nextafter(mag, torch.full_like(mag, float("inf"))) - mag).double() / 2
    dev6 = (upd - ref).abs()
    err6f = float(dev6.max())
    e_upd6 = float((dev6 - half_ulp).clamp_min(0).max() / ref.abs().max())
    del upd, ref, mag, half_ulp, dev6
    untouched = torch.equal(a_k[:e], hpl[:e]) and torch.equal(a_k[:, :e], hpl[:, :e])
    a_q = hpl.clone()
    rs, cs = 7001, 5003
    for r0, r1 in ((0, rs), (rs, mt)):
        for c0, c1 in ((0, cs), (cs, mt)):
            # a_q[r0 + e :, c0 + e :] is the quadrant's corner of the view
            trailing_gemm_sub(a_q[r0:, c0:], l21f[r0:r1], u12f[:, c0:c1], e, ncols=c1 - c0)
    quad = torch.equal(a_q, a_k)
    del a_q
    phase("k6_fp32_trailing_sub", e_upd6 <= 1e-5 and untouched and quad and one6,
          rel_err_update=f"{e_upd6:.3e}", outside_untouched=untouched,
          quadrants_bitwise=quad, split_at=f"{rs}x{cs}", one_launch_no_copy=one6)
    a_p = hpl.clone()
    ms6f = event_ms(lambda: trailing_gemm_sub(a_k, l21f, u12f, e))
    pms6f = event_ms(lambda: trailing_gemm_sub_plain(a_p, l21f, u12f, e), 2)
    c6 = a_p[e:, e:]
    lib6f = library(lambda: c6.addmm_(l21f, u12f, alpha=-1))
    b6f = bound(8 * mt * mt + 2 * 4 * mt * bc, 2 * mt * mt * bc)
    tf6f = rate("k6 fp32 operands", 2 * mt * mt * bc, ms6f, lib6f, b6f)
    kern["trailing_sub"].update(fp32_ms=ms6f, fp32_plain_ms=pms6f, fp32_library_ms=lib6f,
                                fp32_bound_ms=b6f[0], fp32_bound_by=b6f[1],
                                fp32_max_abs_err=err6f, fp32_tflops=tf6f,
                                fp32_quadrants_bitwise=quad)
    del a_k, a_p, c6, l21f, u12f, after
    torch.cuda.empty_cache()

    # ---------------- phase 2b: the masked path's kernels vs plain ----------
    # #7 hgetf2: exact piv / perm / composed perm / srcs on the first panels
    # of both matrices, in each panel dtype (fp16 saturated first, as
    # MPF_FP16 does), at the diagonal offsets of the first and a middle panel
    prev = torch.randperm(n, generator=torch.Generator().manual_seed(3)).to(
        torch.int32).to(dev)
    first_panels = {"hpl": slab0[:, :r], "uniform": uni[:, :r]}
    pairs7, n7 = [], 0
    for corpus, pan in first_panels.items():
        for pdt in (torch.float16, torch.bfloat16, torch.float32):
            inp = cast_to_panel(pan, T.MPF_FP16).contiguous() if pdt == torch.float16 else pan
            for off in (0, 8192):
                got = hgetf2_panel_swaps(inp, off, prev, panel_dtype=pdt)
                ref = hgetf2_panel_plain(inp, off, prev, panel_dtype=pdt)
                same = piv_eq(got, ref)
                pairs7 += zip(got, ref)
                n7 += 1
                phase(f"k7_{corpus}_{str(pdt)[6:]}_off={off}", same,
                      differing_pivots=int((got[0] != ref[0]).sum()))
    # tie-heavy dyadic panel: many equal |values|, ties to the lowest position
    dyp = torch.from_numpy(dyadic(rng, n, r)).to(dev)
    for pdt in (torch.float16, torch.bfloat16):
        got = hgetf2_panel_swaps(dyp, 0, prev, panel_dtype=pdt)
        ref = hgetf2_panel_plain(dyp, 0, prev, panel_dtype=pdt)
        pairs7 += zip(got, ref)
        phase(f"k7_dyadic_ties_{str(pdt)[6:]}", piv_eq(got, ref))
    p16 = cast_to_panel(uni[:, :r], T.MPF_FP16).contiguous()
    ms7 = event_ms(lambda: hgetf2_panel_swaps(p16, 0, None, panel_dtype=torch.float16))
    pms7 = event_ms(lambda: hgetf2_panel_plain(p16, 0, None, panel_dtype=torch.float16), 2)
    dms7 = graph_ms(lambda: hgetf2_panel_swaps(p16, 0, None, panel_dtype=torch.float16))
    # the chain floor: one grid barrier a column, as phase 2 timed it alone
    floor7 = r * bar_us["counter"] / 1e3
    print(f"[INFO] k7 device {dms7:.4f} ms ({ms7:.4f} ms wrapper), chain floor "
          f"{floor7:.4f} ms ({r} barriers of {bar_us['counter']:.3f} us)", flush=True)
    # fp16 panel read once, prev read, perm and the composed map written
    record("hgetf2", *errs(pairs7), ms7, pms7,
           bound(2 * n * r + 12 * n + 12 * r, panel_ops(n, 0, r)), None,
           device_ms=dms7)

    # #8 / #8b on the diagonal blocks of the first panel (the masked path
    # factors the pivoted slab's block), r = 128 (kernel 2's register tile)
    # and r = 256 (the earlier design, global memory); each output against
    # the plain version relative to its own largest entry, and at r <= 128
    # LU and L^-1 bitwise; info exact, including a forced zero pivot
    def npv_checks(tag, blk):
        k8, p8 = getf2_npv_inv_block(blk), getf2_npv_inv_plain(blk)
        e8 = [rel(x, y) for x, y in zip(k8[:3], p8[:3])]
        lu8b, info8b = getf2_npv_block(blk)
        exact = torch.equal(k8[0], p8[0]) and torch.equal(k8[1], p8[1])
        ok = (max(e8) <= 1e-5 and int(k8[3]) == int(p8[3]) == int(info8b)
              and rel(lu8b, p8[0]) <= 1e-5 and (exact or blk.shape[0] > 128))
        phase(f"k8_{tag}", ok, rel_lu=f"{e8[0]:.3e}", rel_linv=f"{e8[1]:.3e}",
              rel_uinv=f"{e8[2]:.3e}", info=int(k8[3]), lu_linv_exact=exact,
              lu_8b_exact=torch.equal(lu8b, p8[0]))
        return list(zip(k8[:3], p8[:3]))
    pairs8 = []
    for corpus, full in (("hpl", slab0), ("uniform", uni)):
        piv0, _, _, srcs0 = hgetf2_panel_swaps(full[:, :r], 0, None,
                                               panel_dtype=torch.bfloat16)
        blk = full[srcs0[:r].long(), :r].contiguous()     # the pivoted diagonal block
        pairs8 += npv_checks(f"{corpus}_r128", blk)
        zb = blk.clone()
        zb[1] = zb[0]                                     # second pivot exactly 0
        k8z, k8bz = getf2_npv_inv_block(zb)[3], getf2_npv_block(zb)[1]
        phase(f"k8_{corpus}_zero_pivot", int(k8z) == int(k8bz) == 2, info=int(k8z))
    w256 = torch.from_numpy(matgen.hpl_ai_matrix(256, seed=5)).to(dev)
    pairs8 += npv_checks("hpl_r256_global_memory", w256)
    blk128 = slab0[:r, :r].contiguous()
    ms8 = event_ms(lambda: getf2_npv_inv_block(blk128))
    pms8 = event_ms(lambda: getf2_npv_inv_plain(blk128), 2)
    ms8b = event_ms(lambda: getf2_npv_block(blk128))
    pms8b = event_ms(lambda: getf2_npv_inv_plain(blk128, False), 2)
    lib8b = library(lambda: torch.linalg.lu_factor_ex(blk128, pivot=False))
    dms8 = graph_ms(lambda: getf2_npv_inv_block(blk128))
    dms8b = graph_ms(lambda: getf2_npv_block(blk128))
    print(f"[INFO] k8 device {dms8:.4f} ms ({ms8:.4f} ms wrapper); k8b device "
          f"{dms8b:.4f} ms ({ms8b:.4f} ms wrapper; lu_factor_ex {lib8b} ms)", flush=True)
    record("npv_inv", *errs(pairs8), ms8, pms8,
           bound(16 * r * r, 4 * r ** 3 / 3), None, device_ms=dms8)
    lu_pairs = [pr for i, pr in enumerate(pairs8) if i % 3 == 0]
    record("npv", *errs(lu_pairs), ms8b, pms8b, bound(8 * r * r, 2 * r ** 3 / 3), lib8b,
           device_ms=dms8b)

    # #9 on the slab view (16384, 1024) at block column 1024 with the 2r rows
    # of a panel, and on the whole matrix with the 2 bc rows of a block
    # column, both with duplicate cand entries carrying equal sources: exact
    big = torch.from_numpy(matgen.random_dense(n, seed=4)).to(dev)
    perm9 = torch.from_numpy(np.random.default_rng(5).permutation(n).astype(np.int32)).to(dev)
    err9 = [0.0, 0.0]
    cases9 = (("slab", lambda t: t[:, bc:2 * bc], 2 * r, 5000),
              ("matrix", lambda t: t, 2 * bc, 0))
    for tag, view, nswap, k9 in cases9:
        cand = torch.cat([k9 + torch.arange(nswap // 2, device=dev, dtype=torch.int32),
                          torch.from_numpy(np.random.default_rng(nswap).integers(
                              k9, n, nswap // 2).astype(np.int32)).to(dev)])
        src9 = perm9[cand.long()]
        x9, y9 = big.clone(), big.clone()
        laswp_apply(view(x9), cand, src9)
        laswp_plain(view(y9), cand, src9)
        dup = int(cand.numel() - torch.unique(cand).numel())
        phase(f"k9_{tag}_nswap={nswap}", torch.equal(x9, y9), duplicate_cand=dup)
        e9 = errs([(x9, y9)])
        err9 = [max(err9[0], e9[0]), max(err9[1], e9[1])]
        # timed on the same tensors after the check: each call exchanges again
        if tag == "slab":
            sl_x, sl_y = view(x9), view(y9)
            ms9 = event_ms(lambda: laswp_apply(sl_x, cand, src9))
            pms9 = event_ms(lambda: laswp_plain(sl_y, cand, src9))
            src9l, cand9l = src9.long(), cand.long()
            lib9 = library(lambda: sl_y.index_copy_(0, cand9l, sl_y.index_select(0, src9l)))
            w9 = bc
            b9 = bound(2 * nswap * w9 * 4)
        else:
            ms9m = event_ms(lambda: laswp_apply(x9, cand, src9), 3)
            b9m = bound(2 * nswap * n * 4)[0]
    del x9, y9, sl_x, sl_y, big
    record("laswp", *err9, ms9, pms9, b9, lib9, matrix_ms=ms9m, matrix_bound_ms=b9m)
    # ---------------- phase 2c: bf16-storage instances vs plain -------------
    # ALL_BF16 keeps the matrix in bf16: the same slab and matrix rounded
    hpl_b, slab0_b, uni_b = hpl.to(BF), slab0.to(BF), uni.to(BF)
    # #1 on bf16 slabs: exact against the plain version and against the
    # kernel on an fp32 slab holding the same (bf16) values
    pairs1b = []
    for q16 in (True, False):
        for corpus, sl, jj0 in (("hpl", slab0_b, 0), ("hpl", slab0_b, 384), ("uniform", uni_b, 0)):
            got = strip_panel_pivots(sl, jj0, pos0, BF, jj0, r, quant16=q16)
            ref = strip_panel_pivots_plain(sl, jj0, pos0, BF, jj0, r, quant16=q16)
            f32 = strip_panel_pivots(sl.float(), jj0, pos0, BF, jj0, r, quant16=q16)
            pairs1b += zip(got, ref)
            phase(f"k1_bf16_slab_{corpus}_{'quant16' if q16 else 'exact'}_jj0={jj0}",
                  piv_eq(got, ref) and piv_eq(got, f32))
    ms = event_ms(lambda: strip_panel_pivots(slab0_b, 0, pos0, BF, 0, r))
    pms = event_ms(lambda: strip_panel_pivots_plain(slab0_b, 0, pos0, BF, 0, r), 2)
    # #1 on the largest slices it takes: m = 65536 (phase 5b's slab, timed
    # too) and m = 73728, the deferred exchange's pre-extended n = 65536 slab
    # with S = 8 (phase 7b; three rows a thread), with dead rows: exact
    big_ms = {}
    for mb_ in (BIG_N, BIG_N + DEFER_S * bc):
        gen = torch.Generator(device=dev).manual_seed(mb_)
        big = ((torch.rand((mb_, 2 * r), generator=gen, device=dev) * 2 - 1) * 4).to(BF)
        posb = torch.arange(mb_, dtype=torch.int32, device=dev)
        posb[torch.randperm(mb_, generator=torch.Generator().manual_seed(3))[:mb_ // 10]
             .to(dev)] = SENT
        for q16 in (True, False):
            got = strip_panel_pivots(big, 64, posb, BF, r, r, quant16=q16)
            ref = strip_panel_pivots_plain(big, 64, posb, BF, r, r, quant16=q16)
            phase(f"k1_bf16_m{mb_}_{'quant16' if q16 else 'exact'}", piv_eq(got, ref),
                  rows_a_block=-(-mb_ // torch.cuda.get_device_properties(dev)
                                 .multi_processor_count))
        if mb_ == BIG_N:
            big_ms = {"ms": event_ms(lambda: strip_panel_pivots(big, 0, posb, BF, 0, r)),
                      "device_ms": graph_ms(lambda: strip_panel_pivots(big, 0, posb, BF, 0, r)),
                      "polls_per_column": polls_per_column(
                          lambda: strip_panel_pivots(big, 0, posb, BF, 0, r))}
        del big, posb
    big_ms["bound_ms"] = bound(2 * BIG_N * r + 8 * BIG_N + 8 * r, panel_ops(BIG_N, 0, r))[0]
    print(f"[INFO] k1 bf16 m={BIG_N}: {json.dumps(big_ms)}", flush=True)
    dms1b = graph_ms(lambda: strip_panel_pivots(slab0_b, 0, pos0, BF, 0, r))
    record_bf16("strip_pivots", errs(pairs1b)[0], ms, pms,
                bound(2 * n * r + 8 * n + 8 * r, panel_ops(n, 0, r)), None,
                device_ms=dms1b, m65536_ms=big_ms["ms"], m65536_device_ms=big_ms["device_ms"])

    # #2 and #12 on the bf16 slabs.  #12's passes are each held against
    # their plain version on the same inputs: the update pass is fed the
    # kernel's own L21, since a one-ulp L21 difference moves the update by
    # more than one ulp of a small result.  #2's gathered columns and
    # diagonal LU (the same operations in the same order) are held to one
    # ulp; its U12 and U^-1 come out of fp32 sums that the kernel takes in
    # a chain and the plain version through cuBLAS, so they get the
    # sum-order slack, from L^-1, U11 and U^-1 in fp32 (kernel 8's plain
    # version on the gathered block: the same operations).  Four more
    # uniform slabs, made on the card from seeds 1-4, measure how much of
    # the slack the kernels use
    abs2b = abs12a = abs12b = used2 = used12 = 0.0
    cases = [("uniform", uni_b, 0), ("uniform", uni_b, 384), ("hpl", slab0_b, 0)]
    for seed in range(1, 5):
        gen = torch.Generator(device=dev).manual_seed(seed)
        slab_s = (torch.rand((n, bc), generator=gen, device=dev) * 9.9).to(BF)
        cases += [(f"uniform_seed{seed}", slab_s, 0), (f"uniform_seed{seed}", slab_s, 384)]
    del slab_s
    for corpus, slab, jj0 in cases:
        tag = f"{corpus}_jj0={jj0}"
        _, pos1, glist1 = strip_panel_pivots(slab, jj0, pos0, BF, jj0, r)
        rb_k, ui_k, info_k = rowblock_assemble(slab, glist1, jj0)
        rb_p, ui_p, info_p = rowblock_assemble_plain(slab, glist1, jj0)
        left_exact = torch.equal(rb_k[:, :jj0], rb_p[:, :jj0])
        c1 = jj0 + r
        staged = slab[glist1.long()].float()
        lu_f, linv_f, uinv_f, _ = getf2_npv_inv_plain(staged[:, jj0:c1])
        rep_lu = within_bf16_ulp(rb_k[:, :c1], rb_p[:, :c1])
        rep_u12 = within_bf16_ulp(rb_k[:, c1:], rb_p[:, c1:],
                                  sum_slack(staged.new_zeros(()), linv_f.to(BF), staged[:, c1:]))
        rep_ui = within_bf16_ulp(ui_k, ui_p, tri_inv_slack(uinv_f, torch.triu(lu_f)))
        ok2 = rep_lu.ok and rep_u12.ok and rep_ui.ok
        used2 = max(used2, rep_u12.slack_used, rep_ui.slack_used)
        abs2b = max(abs2b, absd(rb_k, rb_p), absd(ui_k, ui_p))
        phase(f"k2_bf16_rowblock_{tag}", ok2 and left_exact and rb_k.dtype == BF
              and int(info_k) == int(info_p) == 0, lu_within_one_bf16_ulp=rep_lu.ok,
              u12_uinv_within_ulp_and_sum_order=rep_u12.ok and rep_ui.ok,
              beyond_one_ulp=rep_lu.beyond + rep_u12.beyond + rep_ui.beyond,
              slack_used=f"{max(rep_u12.slack_used, rep_ui.slack_used):.4f}",
              left_of_panel_exact=left_exact, info=int(info_k))
        del staged, lu_f, linv_f, uinv_f
        below = pos1 >= jj0 + r
        s_k, s_p = slab.clone(), slab.clone()
        l_k = l21_trim(s_k, pos1, ui_p, jj0, jj0)
        l_p = l21_trim_plain(s_p, pos1, ui_p, jj0, jj0)
        ok_l21 = within_bf16_ulp(l_k, l_p).ok and within_bf16_ulp(s_k, s_p).ok
        frozen_ok = (torch.equal(s_k[~below], slab[~below]) and not l_k[~below].any()
                     and torch.equal(s_k[:, :jj0], slab[:, :jj0]))
        abs12a = max(abs12a, absd(l_k, l_p))
        after_l21 = s_k.clone()
        s_u = s_k.clone()
        upd_wide(s_k, l_k, rb_p, jj0)
        upd_wide_plain(s_u, l_k, rb_p, jj0)
        c0 = jj0 + r
        slack = sum_slack(after_l21[:, c0:], l_k, rb_p[:, c0:])
        rep_upd = within_bf16_ulp(s_k[:, c0:], s_u[:, c0:], slack)
        used12 = max(used12, rep_upd.slack_used)
        frozen_ok = (frozen_ok and torch.equal(s_k[~below], slab[~below])
                     and torch.equal(s_k[:, :c0], after_l21[:, :c0]))
        # the same check on a copy whose update pass was left out must fail
        no_update_fails = not within_bf16_ulp(after_l21[:, c0:], s_u[:, c0:], slack).ok
        abs12b = max(abs12b, absd(s_k, s_u))
        phase(f"k12_{tag}", ok_l21 and rep_upd.ok and frozen_ok and no_update_fails,
              l21_within_one_bf16_ulp=ok_l21, update_within_ulp_and_sum_order=rep_upd.ok,
              update_beyond_one_ulp=rep_upd.beyond, slack_used=f"{rep_upd.slack_used:.4f}",
              frozen_rows_and_left_exact=frozen_ok,
              copy_without_update_fails=no_update_fails)
        del slack
        if corpus == "uniform" and jj0 == 0:
            ms2 = event_ms(lambda: rowblock_assemble(slab, glist1, 0))
            pms2 = event_ms(lambda: rowblock_assemble_plain(slab, glist1, 0), 2)
            s_t = slab.clone()
            ms12a = event_ms(lambda: l21_trim(s_t, pos1, ui_p, 0, 0))
            pms12a = event_ms(lambda: l21_trim_plain(s_t, pos1, ui_p, 0, 0))
            # the L21 pass as one PyTorch call: the bf16 panel by U11^-1
            # (bf16 operands, fp32 sums, no row mask)
            p12 = s_t[:, :r]
            lib12a = library(lambda: torch.matmul(p12, ui_p))
            # the update pass's two instances of the Hopper routine (C through
            # shared memory, the default; C in registers) in turns, and
            # bitwise equal (the same products, the same subtract)
            ms12s, ms12g = [], []
            for _ in range(2):
                ms12s.append(event_ms(lambda: upd_wide(s_t, l_k, rb_p, 0)))
                ms12g.append(event_ms(lambda: upd_wide(s_t, l_k, rb_p, 0, smem_c=False)))
                ms12g.append(event_ms(lambda: upd_wide(s_t, l_k, rb_p, 0, smem_c=False)))
                ms12s.append(event_ms(lambda: upd_wide(s_t, l_k, rb_p, 0)))
            ms12b = sum(ms12s) / len(ms12s)
            ms12b_regs = sum(ms12g) / len(ms12g)
            pms12b = event_ms(lambda: upd_wide_plain(s_t, l_k, rb_p, 0))
            c12, u12_12 = s_t[:, r:], rb_p[:, r:]
            lib12b = library(lambda: torch.addmm(c12, l_k, u12_12, alpha=-1))
            # device times (CUDA graph replays) of both passes, both update
            # instances and both library calls
            dev12 = {"l21": graph_ms(lambda: l21_trim(s_t, pos1, ui_p, 0, 0)),
                     "l21_lib": graph_ms(lambda: torch.matmul(p12, ui_p)),
                     "upd": graph_ms(lambda: upd_wide(s_t, l_k, rb_p, 0)),
                     "upd_regs": graph_ms(lambda: upd_wide(s_t, l_k, rb_p, 0, smem_c=False)),
                     "upd_lib": graph_ms(lambda: torch.addmm(c12, l_k, u12_12, alpha=-1))}
            s_x, s_y = slab.clone(), slab.clone()
            upd_wide(s_x, l_k, rb_p, 0)
            upd_wide(s_y, l_k, rb_p, 0, smem_c=False)
            phase("k12_update_instances_bitwise", torch.equal(s_x, s_y),
                  smem_c_ms="/".join(f"{t:.4f}" for t in ms12s),
                  registers_ms="/".join(f"{t:.4f}" for t in ms12g))
            del s_t, s_x, s_y, p12
        del s_k, s_p, s_u, after_l21
    del cases, slab
    # k2 bf16 at jj0 = 0: r pivot rows read, row block and U11^-1 written in
    # bf16; the diagonal in fp32, U12 on bf16 operands
    glist_ub = strip_panel_pivots(uni_b, 0, pos0, BF, 0, r)[2]
    record_bf16("rowblock", abs2b, ms2, pms2,
                bound(2 * (2 * r * bc + r * r), 4 * r ** 3 / 3, 2 * r * r * (bc - r)), None,
                device_ms=graph_ms(lambda: rowblock_assemble(uni_b, glist_ub, 0)))
    # k12 at jj0 = 0, m = n: the L21 pass reads the panel and writes it and
    # the side buffer (bf16), 2 m r^2 bf16-operand operations; the update
    # pass reads and writes the m x (bc - r) columns, reads L21 and U12
    # (the L21 pass runs on FFMA: its floor there, 2 m r^2 over the fp32 rate,
    # is recorded beside the bound)
    record("l21_trim", abs12a, abs12a / max(float(uni_b.float().abs().max()), 1.0), ms12a,
           pms12a, bound(6 * n * r + 4 * n + 2 * r * r, 0, 2 * n * r * r), lib12a,
           device_ms=dev12["l21"],
           library_device_ms=dev12["l21_lib"])
    record("upd_wide", abs12b, abs12b / float(uni_b.float().abs().max()), ms12b, pms12b,
           bound(4 * n * (bc - r) + 2 * n * r + 2 * r * (bc - r), 0,
                 2 * n * r * (bc - r)), lib12b, registers_epilogue_ms=ms12b_regs,
           device_ms=dev12["upd"], registers_epilogue_device_ms=dev12["upd_regs"],
           library_device_ms=dev12["upd_lib"])
    print(f"[INFO] k12 L21 pass {ms12a:.4f} ms, device {dev12['l21']:.4f} ms (FFMA floor "
          f"{bound(0, 2 * n * r * r)[0]:.4f} ms; torch.matmul {lib12a} ms, device "
          f"{dev12['l21_lib']:.4f} ms); update pass, C through shared memory {ms12b:.4f} ms, "
          f"device {dev12['upd']:.4f} ms; C in registers {ms12b_regs:.4f} ms, device "
          f"{dev12['upd_regs']:.4f} ms (addmm {lib12b} ms, device {dev12['upd_lib']:.4f} ms)",
          flush=True)

    # #4 on the bf16 matrix: exact
    a_k, a_p = hpl_b.clone(), hpl_b.clone()
    pr_k = rows_exchange(a_k, k, src, src)
    pr_p = rows_exchange_plain(a_p, k, src, src)
    phase("k4_bf16_rows_exchange", torch.equal(pr_k, pr_p) and torch.equal(a_k, a_p))
    err4b = errs([(pr_k, pr_p), (a_k, a_p)])[0]
    ms = event_ms(lambda: rows_exchange(a_k, k, src, src))
    pms = event_ms(lambda: rows_exchange_plain(a_p, k, src, src))
    lib4b = library(lambda: a_p.index_copy_(0, src_l, a_p.index_select(0, band_rows)))
    record_bf16("rows_exchange", err4b, ms, pms, bound(2 * n * 4 * bc), lib4b)
    del a_k, a_p

    # #5 on bf16 leaves: exact
    l11_b = l11.to(BF)
    t_k, t_p = tri_inv_leaves(l11_b, leaves), tri_inv_leaves_plain(l11_b, leaves)
    pairs5b = [(t_k[o:o + s, o:o + s], t_p[o:o + s, o:o + s]) for o, s in leaves]
    phase("k5_bf16_tri_inv", all(torch.equal(x, y) for x, y in pairs5b), leaves=len(leaves))
    ms = event_ms(lambda: tri_inv_leaves(l11_b, leaves))
    pms = event_ms(lambda: tri_inv_leaves_plain(l11_b, leaves), 2)
    stack_b = stack.to(BF)
    lib5b = library(lambda: torch.linalg.solve_triangular(stack_b, eye.to(BF), upper=False,
                                                          unitriangular=True))
    record_bf16("tri_inv", errs(pairs5b)[0], ms, pms,
                bound(sum(4 * s * s for _, s in leaves), 0,
                      sum(s ** 3 / 3 for _, s in leaves)), lib5b,
                device_ms=graph_ms(lambda: tri_inv_leaves(l11_b, leaves)))

    # #6 bf16-C instance at e = 1024: within one bf16 ulp of the plain
    # version plus sum_slack (operands from three seeds), everything outside
    # the trailing block untouched
    used6 = 0.0
    for seed in range(3):
        gen = torch.Generator(device=dev).manual_seed(seed)
        l21 = (torch.rand((n - e, bc), generator=gen, device=dev) - 0.5).to(BF)
        u12 = (torch.rand((bc, n - e), generator=gen, device=dev) - 0.5).to(BF)
        a_k, a_p = hpl_b.clone(), hpl_b.clone()
        trailing_gemm_sub(a_k, l21, u12, e)
        trailing_gemm_sub_plain(a_p, l21, u12, e)
        rep6 = within_bf16_ulp(a_k[e:, e:], a_p[e:, e:], sum_slack(hpl_b[e:, e:], l21, u12))
        untouched = torch.equal(a_k[:e], hpl_b[:e]) and torch.equal(a_k[:, :e], hpl_b[:, :e])
        phase(f"k6_bf16_trailing_sub_seed={seed}", rep6.ok and untouched,
              within_ulp_and_sum_order=rep6.ok, beyond_one_ulp=rep6.beyond,
              slack_used=f"{rep6.slack_used:.4f}", outside_untouched=untouched)
        used6 = max(used6, rep6.slack_used)
        torch.cuda.empty_cache()
    print(f"[INFO] sum_slack_used_at_most k2_bf16={used2:.4f} k12_update={used12:.4f} "
          f"k6_bf16={used6:.4f}", flush=True)
    err6b = absd(a_k, a_p)
    ms = event_ms(lambda: trailing_gemm_sub(a_k, l21, u12, e))
    pms = event_ms(lambda: trailing_gemm_sub_plain(a_p, l21, u12, e))
    c6b = a_p[e:, e:]
    lib6b = library(lambda: torch.addmm(c6b, l21, u12, alpha=-1))
    tf6b = rate("k6 bf16 operands, bf16 C", 2 * mt * mt * bc, ms, lib6b)
    record_bf16("trailing_sub", err6b, ms, pms,
                bound(4 * mt * mt + 2 * 2 * mt * bc, 0, 2 * mt * mt * bc), lib6b, tflops=tf6b)
    # kernel 6's bf16-C instances: C through shared memory (the wrapper's
    # choice for every ALL_BF16 trailing block; four A/B stages, one 32 KB
    # half-tile slot) and C in registers (four stages): bitwise equal at
    # 15360^2 x 1024, then timed in turns there and at 64512^2 x 1024 (phase
    # 5b's first update); the first faster than the last
    insts6 = {"staged": "4 stages + 32 KB C slot", "registers": "4 stages, C in registers"}
    outs6 = {}
    for inst in insts6:
        z = hpl_b.clone()
        _trailing_launch(z[e:, e:], l21, u12, inst)
        outs6[inst] = z
    same6 = all(torch.equal(z, outs6["registers"]) for z in outs6.values())
    del outs6, z

    def k6_turns(mk, c, l21_, u12_, reps, rounds):
        """Mean ms of each instance on C = ``c``, in turns; TF/s printed."""
        t = {inst: [] for inst in insts6}
        for _ in range(rounds):
            for inst in [*insts6, *reversed(insts6)]:
                t[inst].append(event_ms(lambda: _trailing_launch(c, l21_, u12_, inst), reps))
        means = {inst: sum(v) / len(v) for inst, v in t.items()}
        for inst, v in t.items():
            rate(f"k6 bf16 C {mk}, {inst} ({insts6[inst]}), turns "
                 + "/".join(f"{x:.4f}" for x in v), 2 * c.shape[0] * c.shape[1] * bc,
                 means[inst], None)
        return means

    staged_ok = trailing_staged(a_k[e:, e:])
    k6c = {"m15360": k6_turns("m15360", a_k[e:, e:], l21, u12, 10, 2)}
    del a_k, a_p, c6b
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(17)
    mb = BIG_N - bc
    big6 = torch.rand((BIG_N, BIG_N), generator=gen, device=dev, dtype=BF) - 0.5
    l21_b = torch.rand((mb, bc), generator=gen, device=dev, dtype=BF) - 0.5
    u12_b = torch.rand((bc, mb), generator=gen, device=dev, dtype=BF) - 0.5
    staged_ok = staged_ok and trailing_staged(big6[bc:, bc:])
    k6c["m64512"] = k6_turns("m64512", big6[bc:, bc:], l21_b, u12_b, 3, 1)
    del big6, l21_b, u12_b
    torch.cuda.empty_cache()
    faster6 = k6c["m15360"]["staged"] < k6c["m15360"]["registers"]
    phase("k6_bf16c_instances", same6 and staged_ok and faster6, bitwise_equal=same6,
          staged_is_the_wrappers_choice=staged_ok, staged_faster_at_m15360=faster6,
          **{f"{mk}_{inst}_ms": f"{v:.4f}" for mk, d in k6c.items() for inst, v in d.items()})
    del l21, u12, hpl_b, slab0_b, uni_b
    torch.cuda.empty_cache()

    # ---------------- phase 2h: kernel 17, U12 under bf16 storage ----------
    # (1024 x 1024) @ (1024 x w) for the widths of n = 65536's first block
    # column, of n = 32768's and of the last but one: linv the blocked
    # inverse of a random unit-lower block (entries below 2 / kw), A12 a
    # view of a 1024 x 65536 bf16 matrix.  Kernel 17 within one bf16 ulp
    # plus sum_slack of its plain version and at least 99.9% bit-equal, the
    # matrix untouched; the wrapper's time and its device time alone beside
    # the bound, the plain version (the parent's route: IEEE fp32 cuBLAS on
    # upcast copies, then the cast) and PyTorch's bf16 matmul
    kw17 = bc
    gen = torch.Generator(device=dev).manual_seed(23)
    l11_17 = ((torch.rand((kw17, kw17), generator=gen, device=dev) - 0.5)
              * (4.0 / kw17)).to(BF)
    linv17 = unit_lower_inv_blocked(l11_17, base=128)
    wide17 = torch.rand((kw17, BIG_N), generator=gen, device=dev, dtype=BF) - 0.5
    before17 = wide17.clone()
    tiles17 = kw17 // 128
    res17 = {}
    for w17 in (BIG_N - bc, BIG_N // 2 - bc, bc):
        a12 = wide17[:, bc:bc + w17]
        got = u12_product(linv17, a12)
        ref = u12_product_plain(linv17, a12)
        rep17 = within_bf16_ulp(got, ref, sum_slack(torch.zeros(ref.shape, device=dev),
                                                    linv17, a12))
        equal17 = float((got == ref).double().mean())
        kept17 = torch.equal(wide17, before17)
        ms17 = event_ms(lambda: u12_product(linv17, a12), 10)
        dev17 = graph_ms(lambda: u12_product(linv17, a12))
        pms17 = event_ms(lambda: u12_product_plain(linv17, a12), 3)
        lib17 = library(lambda: torch.matmul(linv17, a12))
        bnd17 = bound(2 * 2 * kw17 * w17 + 2 * kw17 * kw17, 0,
                      w17 * 128 * 128 * tiles17 * (tiles17 + 1))
        phase(f"k17_u12_product_w={w17}", rep17.ok and equal17 >= 0.999 and kept17,
              within_ulp_and_sum_order=rep17.ok, beyond_one_ulp=rep17.beyond,
              slack_used=f"{rep17.slack_used:.4f}", bit_equal_share=f"{equal17:.6f}",
              matrix_untouched=kept17, ms=f"{ms17:.4f}", device_ms=f"{dev17:.4f}",
              bound_ms=f"{bnd17[0]:.4f}", bound_by=bnd17[1], plain_ms=f"{pms17:.4f}",
              torch_matmul_bf16_ms="none" if lib17 is None else f"{lib17:.4f}",
              card=f"'{smi}'")
        res17[w17] = (errs([(got, ref)]), ms17, pms17, bnd17, dev17)
        del got, ref
    (abs17, rel17), ms17, pms17, bnd17, dev17 = res17[BIG_N - bc]
    record("u12_product", abs17, rel17, ms17, pms17, bnd17, pms17, device_ms=dev17,
           library="the parent's route: matmul_in (IEEE fp32 cuBLAS) and the casts")
    del l11_17, linv17, wide17, before17
    torch.cuda.empty_cache()

    # ---------------- phase 2d: kernels 13 and 11 vs plain -----------------
    # the lookahead driver's first wide update: rows [e, n) x columns [c0, n)
    # of block column 0, K = 1024, and block column 1's exchange (band
    # [k, k + bc) with k = e): a band map of bc sequential swaps, band row i
    # with a row >= k + i (swap chains bottom out in the band)
    e, c0 = bc, 2 * bc
    k = e
    mt, wt = n - e, n - c0
    perm = np.arange(k, n)
    for i in range(bc):
        j = rng.integers(i, n - k)
        perm[[i, j]] = perm[[j, i]]
    inv = np.empty(n - k, dtype=np.int64)
    inv[perm - k] = np.arange(n - k)
    glist = torch.from_numpy(perm[:bc].astype(np.int32)).to(dev)
    dests = torch.from_numpy((inv[:bc] + k).astype(np.int32)).to(dev)
    glist_l, dests_l = glist.long(), dests.long()
    band_rows = torch.arange(k, k + bc, device=dev)
    moved = int(((dests < k) | (dests >= k + bc)).sum())
    # exchange bytes: bc pivot rows read and written, moved band rows read
    # and written, over the full width
    x_bytes = 2 * (bc + moved) * n
    gen = torch.Generator(device=dev).manual_seed(13)
    l21b = (torch.rand((mt, bc), generator=gen, device=dev) - 0.5).to(BF)
    u12b = (torch.rand((bc, wt), generator=gen, device=dev) - 0.5).to(BF)
    hpl_b = hpl.to(BF)
    ms13 = {}
    for tag, a13, l21, u12 in (("bf16_operands", hpl, l21b, u12b),
                               ("fp32_operands", hpl, l21b.float(), u12b.float()),
                               ("bf16_c", hpl_b, l21b, u12b)):
        x, y = a13.clone(), a13.clone()
        _lib.reset_counts()
        _, pk = gemm_trailing(x, l21, u12, e, c0, xargs=(k, glist, dests))
        launched13 = _lib.launches["gemmx"]
        trailing_gemm_sub(y[:, c0 - e:], l21, u12, e, ncols=wt)     # kernel 6
        py = rows_exchange(y, k, glist, dests)                       # kernel 4
        x[k:k + bc], y[k:k + bc] = pk, py
        bitwise = torch.equal(pk, py) and torch.equal(x, y)
        del y, py
        z = a13.clone()
        _, pz = gemm_trailing_plain(z, l21, u12, e, c0, xargs=(k, glist, dests))
        z[k:k + bc] = pz
        left_exact = torch.equal(x[:, :c0], z[:, :c0]) and torch.equal(x[:e], a13[:e])
        if tag == "bf16_c":
            # the GEMM region's slack, moved with its rows as the exchange
            # moves them (the same row map on both sides)
            sl = torch.zeros(a13.shape, dtype=torch.float32, device=dev)
            sl[e:, c0:] = sum_slack(a13[e:, c0:], l21, u12)
            sp = rows_exchange_plain(sl, k, glist, dests)
            sl[k:k + bc] = sp
            rep13 = within_bf16_ulp(x, z, sl)
            ok = rep13.ok
            fields = dict(within_ulp_and_sum_order=ok, beyond_one_ulp=rep13.beyond,
                          slack_used=f"{rep13.slack_used:.4f}")
            del sl, sp
        else:
            rel13 = float((x - z).abs().max() / z.abs().max())
            ok = rel13 <= 1e-6
            fields = dict(rel_err=f"{rel13:.3e}")
        err13 = absd(x, z)
        phase(f"k13_gemmx_{tag}", ok and bitwise and left_exact and launched13 == 1,
              bitwise_kernel6_then_kernel4=bitwise, left_and_above_exact=left_exact,
              max_abs_err=f"{err13:.3e}", **fields)
        del z, pz
        ms13[tag] = event_ms(lambda: gemm_trailing(x, l21, u12, e, c0, xargs=(k, glist, dests)))
        pms = event_ms(lambda: gemm_trailing_plain(x, l21, u12, e, c0,
                                                   xargs=(k, glist, dests)), 2)
        reg = x[e:, c0:]

        def lib13():
            if tag == "bf16_operands":
                reg.copy_(torch.addmm(reg, l21, u12, alpha=-1, out_dtype=torch.float32))
            else:
                reg.addmm_(l21, u12, alpha=-1)
            x.index_select(0, glist_l)
            x.index_copy_(0, dests_l, x.index_select(0, band_rows))
        lib = library(lib13, 3)
        # kernel 6 then kernel 4 on the same shapes and instance: the serial
        # pair kernel 13 replaces
        y = a13.clone()

        def serial():
            trailing_gemm_sub(y[:, c0 - e:], l21, u12, e, ncols=wt)
            rows_exchange(y, k, glist, dests)
        serial_ms = event_ms(serial)
        el = x.element_size()
        ops = 2 * mt * wt * bc
        # C read and written, each operand read once, the exchange's rows
        b13 = bound(2 * el * mt * wt + l21.element_size() * (mt * bc + bc * wt)
                    + el * x_bytes, ops if tag == "fp32_operands" else 0,
                    0 if tag == "fp32_operands" else ops)
        tf13 = rate(f"k13 {tag} (+ exchange)", ops, ms13[tag], lib,
                    b13 if tag == "fp32_operands" else None)
        if tag == "bf16_operands":
            record("gemmx", err13, err13 / float(a13.abs().max()), ms13[tag], pms, b13, lib,
                   moved_rows=moved, kernel6_then_kernel4_ms=serial_ms, tflops=tf13)
        elif tag == "fp32_operands":
            kern["gemmx"].update(fp32_ms=ms13[tag], fp32_plain_ms=pms, fp32_library_ms=lib,
                                 fp32_bound_ms=b13[0], fp32_max_abs_err=err13,
                                 fp32_kernel6_then_kernel4_ms=serial_ms, fp32_tflops=tf13)
        else:
            record_bf16("gemmx", err13, ms13[tag], pms, b13, lib,
                        kernel6_then_kernel4_ms=serial_ms, tflops=tf13)
        print(f"[INFO] k13 {tag}: {ms13[tag]:.3f} ms, kernel 6 then kernel 4 "
              f"{serial_ms:.3f} ms, bound {b13[0]:.3f} ms ({b13[1]})", flush=True)
        del x, y, reg
        torch.cuda.empty_cache()
    del l21b, u12b

    # #11 at the same band, fp32 and bf16: bitwise equal to the plain versions
    err11 = 0.0
    launched11 = {name: _lib.launches[name] for name in ROWS11}
    for dt, a11 in ((torch.float32, hpl), (BF, hpl_b)):
        tag = str(dt)[6:]
        g_k, g_p = rows_gather(a11, glist), rows_gather_plain(a11, glist)
        x, y = a11.clone(), a11.clone()
        rows_scatter_from_band(x, k, dests)
        rows_scatter_from_band_plain(y, k, dests)
        band_ok = torch.equal(x, y)
        # values scatter: self-moves, dropped rows colliding, the band's values
        vals = a11[k:k + bc].clone()
        self_src = torch.where(torch.arange(bc, device=dev) % 7 == 0, dests, band_rows.int())
        active = torch.arange(bc, device=dev) % 5 != 1
        x2, y2 = a11.clone(), a11.clone()
        rows_scatter_inplace(x2, dests, vals, self_src=self_src, active=active)
        rows_scatter_inplace_plain(y2, dests, vals, self_src=self_src, active=active)
        phase(f"k11_rows_{tag}", torch.equal(g_k, g_p) and band_ok and torch.equal(x2, y2),
              gather_exact=torch.equal(g_k, g_p), scatter_from_band_exact=band_ok,
              scatter_values_exact=torch.equal(x2, y2), moved_rows=moved)
        err11 = max(err11, absd(g_k, g_p), absd(x, y), absd(x2, y2))
        el = a11.element_size()
        gms = event_ms(lambda: rows_gather(a11, glist))
        gpms = event_ms(lambda: rows_gather_plain(a11, glist))
        glib = library(lambda: a11.index_select(0, glist_l))
        sms = event_ms(lambda: rows_scatter_from_band(x, k, dests))
        spms = event_ms(lambda: rows_scatter_from_band_plain(y, k, dests))
        out_d = dests_l[(dests_l < k) | (dests_l >= k + bc)]
        out_s = band_rows[(dests_l < k) | (dests_l >= k + bc)]
        slib = library(lambda: y.index_copy_(0, out_d, y.index_select(0, out_s)))
        if dt == torch.float32:
            record("rows_gather", err11, 0.0, gms, gpms, bound(2 * el * bc * n), glib)
            record("rows_scatter", err11, 0.0, sms, spms, bound(2 * el * moved * n), slib,
                   moved_rows=moved)
        else:
            record_bf16("rows_gather", err11, gms, gpms, bound(2 * el * bc * n), glib)
            record_bf16("rows_scatter", err11, sms, spms, bound(2 * el * moved * n), slib)
        del x, y, x2, y2, g_k, g_p
    launched11 = {name: _lib.launches[name] - launched11[name] for name in ROWS11}
    del hpl_b
    torch.cuda.empty_cache()

    # ---------------- phase 2e: kernels 14 and 10 vs plain ----------------
    # #14 at the deferred driver's shapes (S = 8, block 1024: 8192 overflow
    # slots below n = 16384 rows): block column 1's band copied to slot 3,
    # and a flush of every slot, 4096 live with distinct destinations and
    # the rest dead (the sentinel); bitwise
    ov = DEFER_S * bc
    live_n = 4096
    grng = np.random.default_rng(17)
    live_slots = grng.choice(ov, live_n, replace=False)
    dests_np = np.full(ov, SENT, np.int32)
    dests_np[live_slots] = grng.choice(n, live_n, replace=False)
    dests14 = torch.from_numpy(dests_np).to(dev)
    lib_src = torch.from_numpy(live_slots.astype(np.int64) + n).to(dev)
    lib_dst = dests14[lib_src - n].long()
    dst0 = n + 3 * bc
    for dt in (torch.float32, BF):
        tag = str(dt)[6:]
        x = torch.empty((n + ov, n), dtype=dt, device=dev)
        x[:n] = hpl
        x[n:] = -hpl[:ov]
        y = x.clone()
        _lib.reset_counts()
        copy_rows_block(x, bc, dst0, bc)
        copy_rows_block_plain(y, bc, dst0, bc)
        ok_c = torch.equal(x, y)
        flush_overflow(x, n, dests14)
        flush_overflow_plain(y, n, dests14)
        ok_f = torch.equal(x, y)
        launched14 = [_lib.launches[k] for k in DEFER]
        phase(f"k14_{tag}", ok_c and ok_f and launched14 == [1, 1], copy_rows_exact=ok_c,
              flush_exact=ok_f, slots=ov, live_rows=live_n)
        err14 = 0.0 if ok_c and ok_f else absd(x, y)
        el = x.element_size()
        ms_c = event_ms(lambda: copy_rows_block(x, bc, dst0, bc))
        pms_c = event_ms(lambda: copy_rows_block_plain(y, bc, dst0, bc))
        band_v, slot_v = y[bc:2 * bc], y[dst0:dst0 + bc]
        lib_c = library(lambda: slot_v.copy_(band_v))
        ms_f = event_ms(lambda: flush_overflow(x, n, dests14))
        pms_f = event_ms(lambda: flush_overflow_plain(y, n, dests14))
        lib_f = library(lambda: y.index_copy_(0, lib_dst, y.index_select(0, lib_src)))
        # the band read and the slots written; the live rows read and
        # written and the slots' destinations read
        b_c, b_f = bound(2 * el * bc * n), bound(2 * el * live_n * n + 4 * ov)
        if dt == torch.float32:
            record("copy_rows", err14, 0.0, ms_c, pms_c, b_c, lib_c)
            record("flush_overflow", err14, 0.0, ms_f, pms_f, b_f, lib_f, slots=ov,
                   live_rows=live_n)
        else:
            record_bf16("copy_rows", err14, ms_c, pms_c, b_c, lib_c)
            record_bf16("flush_overflow", err14, ms_f, pms_f, b_f, lib_f)
        print(f"[INFO] k14 {tag}: copy_rows {ms_c:.4f} ms (bound {b_c[0]:.4f}, copy_ "
              f"{lib_c}), flush {ms_f:.4f} ms (bound {b_f[0]:.4f}, index_select + "
              f"index_copy_ {lib_f})", flush=True)
        del x, y, band_v, slot_v
        torch.cuda.empty_cache()
    del dests14, lib_src, lib_dst

    # #10 (on no driver path) at the fused path's B shapes, m = 16384, bc =
    # 1024, r = 128, on the uniform slab's panels at jj0 = 0 and 384: L21
    # against the plain version (fp32 slabs 1e-5 relative, bf16 one ulp);
    # the update against the product of the kernel's own L21 (fp32 slabs:
    # in fp64, past the half ulp of the stored result, 1e-5 relative; bf16:
    # one ulp plus sum_slack); frozen rows and the columns left of the
    # panel exact.  The fp32-operand instance must also equal kernel 3
    # bitwise (its L21 pass and the FFMA routine sum in the same order)
    uni_b = uni.to(BF)
    ms10 = {}
    err10 = {}
    for inst, slab, gbf in (("fp32_bf16_update", uni, True), ("fp32", uni, False),
                            ("bf16", uni_b, False)):
        for jj0 in (0, 384):
            c0 = jj0 + r
            _, pos1, glist1 = strip_panel_pivots(slab, jj0, pos0, BF, jj0, r)
            rb_p, ui_p, _ = rowblock_assemble_plain(slab, glist1, jj0)
            below = pos1 >= c0
            s_k, s_p = slab.clone(), slab.clone()
            _lib.reset_counts()
            panel_apply_update(s_k, pos1, rb_p, ui_p, jj0, jj0, gbf)
            one_launch = _lib.launches["panel_update_full"] == 1
            panel_apply_update_plain(s_p, pos1, rb_p, ui_p, jj0, jj0, gbf)
            untouched = (torch.equal(s_k[~below], slab[~below])
                         and torch.equal(s_k[:, :jj0], slab[:, :jj0]))
            fields = {}
            if inst == "bf16":
                ok_l21 = within_bf16_ulp(s_k[:, jj0:c0], s_p[:, jj0:c0]).ok
                l21m = torch.where(below[:, None], s_k[:, jj0:c0], 0.0).to(BF)
                ref = slab[:, c0:].float() - l21m.float() @ rb_p[:, c0:].float()
                ref = torch.where(below[:, None], ref.to(BF), slab[:, c0:])
                rep10 = within_bf16_ulp(s_k[:, c0:], ref, sum_slack(slab[:, c0:], l21m,
                                                                    rb_p[:, c0:]))
                ok = ok_l21 and rep10.ok
                fields = dict(l21_within_one_bf16_ulp=ok_l21,
                              update_within_ulp_and_sum_order=rep10.ok,
                              slack_used=f"{rep10.slack_used:.4f}")
                del l21m, ref
            else:
                l21_k = s_k[below, jj0:c0]
                e_l21 = rel(l21_k, s_p[below, jj0:c0])
                u12 = rb_p[:, c0:]
                if gbf:
                    ref = l21_k.to(BF).double() @ u12.to(BF).double()
                else:
                    ref = l21_k.double() @ u12.double()
                after = s_k[below, c0:]
                mag = after.abs()
                half_ulp = (torch.nextafter(mag, torch.full_like(mag, float("inf")))
                            - mag).double() / 2
                upd_k = slab[below, c0:].double() - after.double()
                e_upd = float(((upd_k - ref).abs() - half_ulp).clamp_min(0).max()
                              / ref.abs().max())
                ok = e_l21 <= 1e-5 and e_upd <= 1e-5
                fields = dict(rel_err_l21=f"{e_l21:.3e}", rel_err_update=f"{e_upd:.3e}")
                if not gbf:
                    # kernel 3's L21 pass and FFMA routine sum in the same order
                    s_3 = slab.clone()
                    panel_apply_update_trim(s_3, pos1, rb_p, ui_p, jj0, jj0, False)
                    fields["bitwise_kernel3"] = torch.equal(s_k, s_3)
                    ok = ok and fields["bitwise_kernel3"]
                    del s_3
                del l21_k, ref, after, mag, half_ulp, upd_k
            err10[inst] = max(err10.get(inst, 0.0), absd(s_k, s_p))
            phase(f"k10_{inst}_jj0={jj0}", ok and untouched and one_launch,
                  frozen_rows_and_left_exact=untouched, **fields)
            if jj0 == 0:
                s_t = slab.clone()
                ms10[inst] = (event_ms(lambda: panel_apply_update(s_t, pos1, rb_p, ui_p, 0, 0,
                                                                  gbf)),
                              event_ms(lambda: panel_apply_update_plain(s_t, pos1, rb_p, ui_p,
                                                                        0, 0, gbf)))
                del s_t
            del s_k, s_p
    # at jj0 = 0: the slab read and written, the row block, U^-1 and the
    # positions read; L21 2 m r^2 fp32 (bf16 operands on a bf16 slab), the
    # update 2 m r (bc - r) on the update's operand type
    ops_l21, ops_upd = 2 * n * r * r, 2 * n * r * (bc - r)
    b10 = {"fp32_bf16_update": bound(8 * n * bc + 4 * r * bc + 4 * r * r + 4 * n, ops_l21,
                                     ops_upd),
           "fp32": bound(8 * n * bc + 4 * r * bc + 4 * r * r + 4 * n, ops_l21 + ops_upd),
           "bf16": bound(4 * n * bc + 2 * r * bc + 2 * r * r + 4 * n, 0, ops_l21 + ops_upd)}
    for inst in ms10:
        print(f"[INFO] k10 {inst}: {ms10[inst][0]:.4f} ms, plain {ms10[inst][1]:.4f} ms, "
              f"bound {b10[inst][0]:.4f} ms ({b10[inst][1]})", flush=True)
    record("panel_update_full", err10["fp32_bf16_update"],
           err10["fp32_bf16_update"] / float(uni.abs().max()), *ms10["fp32_bf16_update"],
           b10["fp32_bf16_update"], None, fp32_ms=ms10["fp32"][0],
           fp32_plain_ms=ms10["fp32"][1], fp32_bound_ms=b10["fp32"][0],
           fp32_bound_by=b10["fp32"][1], fp32_max_abs_err=err10["fp32"])
    record_bf16("panel_update_full", err10["bf16"], *ms10["bf16"], b10["bf16"], None)
    del uni_b

    # ---------------- phase 2f: the pair-layout kernels vs plain ------------
    # #15a-15c at block column 0 of n = 16384 on the HPL-AI matrix as a pair
    # tensor (the slab m = n, bc = 1024; the band write of 1024 gathered
    # rows at k = 1024): bitwise.  #15d with L^-1 of the uniform matrix's
    # first block column (made on the card, factored by the panel kernels,
    # as the path factors it) on its A12 (1024 x 15360): within one ulp of
    # the working dtype plus sum_slack
    nr15, w15 = bc, n - bc
    pivsrc = src.long()                       # phase 2's 1024 rows from [k, n)
    for dt in (torch.float32, BF):
        tag = str(dt)[6:]
        a3 = (hpl if dt == torch.float32 else hpl.to(BF)).view(n // 2, 2, n)
        el = a3.element_size()
        _lib.reset_counts()
        s_k, s_p = slab_extract(a3, 0, 0, n, bc), slab_extract_plain(a3, 0, 0, n, bc)
        ok_x = torch.equal(s_k, s_p)
        x3, y3 = a3.clone(), a3.clone()
        neg = -s_k
        slab_writeback(x3, neg, 0, 0)
        slab_writeback_plain(y3, neg, 0, 0)
        ok_w = torch.equal(x3, y3)
        rows15 = as_matrix(a3)[pivsrc]
        band_write_rows(x3, rows15, bc)
        band_write_rows_plain(y3, rows15, bc)
        ok_b = torch.equal(x3, y3)
        launched15 = [_lib.launches[k] for k in PAIRS[:3]]
        phase(f"k15abc_{tag}", ok_x and ok_w and ok_b and launched15 == [1, 1, 1],
              extract_exact=ok_x, writeback_exact=ok_w, band_write_exact=ok_b)
        err15 = 0.0 if ok_x and ok_w and ok_b else max(absd(s_k, s_p), absd(x3, y3))
        view0 = as_matrix(a3)[:, :bc]
        xv, band_v = as_matrix(x3)[:, :bc], as_matrix(x3)[bc:2 * bc]
        times = {
            "slab_extract": (event_ms(lambda: slab_extract(a3, 0, 0, n, bc)),
                             event_ms(lambda: slab_extract_plain(a3, 0, 0, n, bc)),
                             library(lambda: s_p.copy_(view0))),
            "slab_writeback": (event_ms(lambda: slab_writeback(x3, neg, 0, 0)),
                               event_ms(lambda: slab_writeback_plain(y3, neg, 0, 0)),
                               library(lambda: xv.copy_(neg))),
            "band_write": (event_ms(lambda: band_write_rows(x3, rows15, bc)),
                           event_ms(lambda: band_write_rows_plain(y3, rows15, bc)),
                           library(lambda: band_v.copy_(rows15))),
        }
        # each element read once and written once
        b15 = {"slab_extract": bound(2 * el * n * bc), "slab_writeback": bound(2 * el * n * bc),
               "band_write": bound(2 * el * nr15 * n)}
        for name, (ms, pms, lib) in times.items():
            if dt == torch.float32:
                record(name, err15, 0.0, ms, pms, b15[name], lib)
            else:
                record_bf16(name, err15, ms, pms, b15[name], lib)
            print(f"[INFO] k15 {name} {tag}: {ms:.4f} ms (bound {b15[name][0]:.4f}, plain "
                  f"{pms:.4f}, copy_ {lib})", flush=True)
        del s_k, s_p, neg, rows15, view0, xv, band_v
        # rows_exchange3 and trailing_sub3: kernels 4 and 6 on the pair
        # tensor (phase 2's exchange at k = 1024, a K = 1024 update at e =
        # 1024), bitwise equal to the plain exchange and to kernel 6 on the
        # (n, n) view
        x3, y3 = a3.clone(), a3.clone()
        _lib.reset_counts()
        pr_k = rows_exchange3(x3, bc, src, src)
        pr_p = rows_exchange_plain(as_matrix(y3), bc, src, src)
        ok_x3 = torch.equal(pr_k, pr_p) and torch.equal(x3, y3)
        gen = torch.Generator(device=dev).manual_seed(15)
        l21 = (torch.rand((n - bc, bc), generator=gen, device=dev) - 0.5).to(BF)
        u12 = (torch.rand((bc, n - bc), generator=gen, device=dev) - 0.5).to(BF)
        trailing_sub3(x3, l21, u12, bc)
        trailing_gemm_sub(as_matrix(y3), l21, u12, bc)
        ok_s3 = torch.equal(x3, y3)
        counted = (_lib.launches["rows_exchange"], _lib.launches["trailing_sub"]) == (1, 2)
        fields = {}
        if dt == torch.float32:
            # the fp32-operand instance (the FFMA routine) on the pair tensor
            l21f, u12f = l21.float(), u12.float()
            x3f, y3f = a3.clone(), a3.clone()
            trailing_sub3(x3f, l21f, u12f, bc)
            trailing_gemm_sub(as_matrix(y3f), l21f, u12f, bc)
            fields["fp32_operands_equal_kernel6"] = torch.equal(x3f, y3f)
            del y3f
        phase(f"rows_exchange3_trailing_sub3_{tag}", ok_x3 and ok_s3 and counted
              and fields.get("fp32_operands_equal_kernel6", True),
              rows_exchange3_exact=ok_x3, trailing_sub3_equals_kernel6=ok_s3, **fields)
        kern["rows_exchange"].setdefault("pair_layout", {})[tag] = {
            "ms": event_ms(lambda: rows_exchange3(x3, bc, src, src)),
            "plain_ms": event_ms(lambda: rows_exchange_plain(as_matrix(y3), bc, src, src))}
        kern["trailing_sub"].setdefault("pair_layout", {})[tag] = {
            "ms": event_ms(lambda: trailing_sub3(x3, l21, u12, bc))}
        if dt == torch.float32:
            kern["trailing_sub"]["pair_layout"][tag]["fp32_operands_ms"] = event_ms(
                lambda: trailing_sub3(x3f, l21f, u12f, bc))
            del x3f, l21f, u12f
        print(f"[INFO] rows_exchange3 / trailing_sub3 {tag}: "
              f"{json.dumps(kern['rows_exchange']['pair_layout'][tag])} / "
              f"{json.dumps(kern['trailing_sub']['pair_layout'][tag])}", flush=True)
        del pr_k, pr_p, l21, u12
        # #15d: a real L^-1 (the uniform matrix's block column 0, factored by
        # kernels 1-3 or 1, 2, 12) on that matrix's A12, in place
        policy = T.MPF_BF16 if dt == torch.float32 else T.ALL_BF16
        u3 = matgen.random_dense_device(n, seed=2, dtype=dt, device=dev, pairs=True)
        sub = slab_extract(u3, 0, 0, n, bc)
        u_all = _factor_block_column_fused(sub, 0, r, policy)[3]
        linv = unit_lower_inv_blocked(u_all, base=r)
        del sub, u_all
        a12 = as_matrix(u3)[:bc, bc:].clone()
        x3, y3 = u3.clone(), u3.clone()
        _lib.reset_counts()
        u12_transform(x3, linv, 0, bc, w15)
        one = _lib.launches["u12_inplace"] == 1
        u12_transform_plain(y3, linv, 0, bc, w15)
        got, ref = as_matrix(x3)[:bc, bc:], as_matrix(y3)[:bc, bc:]
        rep15 = within_ulp(got, ref, sum_slack(torch.zeros((), device=dev), linv, a12), dt)
        err_u = absd(got, ref)
        rel_u = err_u / float(ref.double().abs().max())
        got.zero_()
        ref.zero_()
        outside = torch.equal(x3, y3)
        phase(f"k15d_u12_inplace_{tag}", rep15.ok and outside and one,
              within_ulp_and_sum_order=rep15.ok, beyond_one_ulp=rep15.beyond,
              slack_used=f"{rep15.slack_used:.4f}", outside_exact=outside,
              max_abs_err=f"{err_u:.3e}")
        x3.copy_(u3)
        ms = event_ms(lambda: u12_transform(x3, linv, 0, bc, w15))
        pms = event_ms(lambda: u12_transform_plain(x3, linv, 0, bc, w15), 2)
        linv_f, a12_f = linv.float(), a12.float()
        lib = library(lambda: torch.matmul(linv_f, a12_f))
        # A12 read and U12 written, L^-1 read; kw^2 w flops (the j <= i
        # terms) on operands of the working dtype
        ops, nbytes = bc * bc * w15, el * (2 * bc * w15 + bc * bc)
        b = bound(nbytes, ops) if dt == torch.float32 else bound(nbytes, 0, ops)
        extra = dict(slack_used=rep15.slack_used, fp32_ffma_bound_ms=bound(0, ops)[0])
        if dt == torch.float32:
            record("u12_inplace", err_u, rel_u, ms, pms, b, lib, **extra)
        else:
            record_bf16("u12_inplace", err_u, ms, pms, b, lib, **extra)
        print(f"[INFO] k15d u12_inplace {tag}: {ms:.4f} ms (bound {b[0]:.4f} {b[1]}, IEEE "
              f"fp32 FFMA bound {extra['fp32_ffma_bound_ms']:.4f}, plain {pms:.4f}, matmul "
              f"{lib})", flush=True)
        del a3, x3, y3, u3, linv, a12, got, ref, linv_f, a12_f
        torch.cuda.empty_cache()

    del hpl, slab0, uni, dyp, p16
    torch.cuda.empty_cache()

    # ---------------- phase 2g: the tools/ probes (16a-16k) ----------------
    # The path of this slice is the probes' entry points: each module's run()
    # at the TPU tool's default shapes, with the counts set to 0 just before
    # and read just after.  Each leg applies the tool's own check, holds the
    # kernel's output (from that run, no extra launch) to its plain version
    # and returns its bytes and operations, from which the bound is stated
    # here; the heaviest leg of each kernel gives its row of the JSON line.
    from mpf_tpu_torch.tools import (
        crash_bisect_r5, granule_r5, micro_3d, probe_r4, refview_r5, xsel_micro)
    t2g = time.perf_counter()
    _lib.reset_counts()
    probe_legs = []
    for mod in (probe_r4, granule_r5, refview_r5, xsel_micro, micro_3d, crash_bisect_r5):
        probe_legs += mod.run(dev)
        torch.cuda.empty_cache()
    probe_counts = {k: _lib.launches[k] for k in PROBES}
    for lg in probe_legs:
        lg["bound"] = bound(lg["bytes"], lg["fp32_ops"], lg["bf16_ops"])
        phase(f"k16 {lg['kernel']} {lg['leg'].strip()}", lg["ok"], ms=f"{lg['ms']:.4f}",
              bound_ms=f"{lg['bound'][0]:.4f}", max_abs_err=f"{lg['max_abs_err']:.3e}",
              rel_err="none" if lg["rel_err"] is None else f"{lg['rel_err']:.3e}")
    phase("k16_probe_path", all(probe_counts[k] > 0 for k in PROBES),
          seconds=f"{time.perf_counter() - t2g:.1f}", launches=json.dumps(probe_counts))
    for name in PROBES:
        mine = [lg for lg in probe_legs if lg["kernel"] == name]
        head = max(mine, key=lambda lg: lg["bound"][0])
        rels = [lg["rel_err"] for lg in mine if lg["rel_err"] is not None]
        record(name, max(lg["max_abs_err"] for lg in mine), max(rels) if rels else None,
               head["ms"], head["plain_ms"], head["bound"], head["library_ms"],
               headline_leg=head["leg"].strip(),
               legs=[{"leg": lg["leg"].strip(), "ms": lg["ms"], "plain_ms": lg["plain_ms"],
                      "library_ms": lg["library_ms"], "bound_ms": lg["bound"][0],
                      "bound_by": lg["bound"][1], "max_abs_err": lg["max_abs_err"],
                      "rel_err": lg["rel_err"]}
                     for lg in mine])
    del probe_legs
    torch.cuda.empty_cache()
    print(f"[INFO] resident_gib_after_2g={torch.cuda.memory_allocated() / 2**30:.2f}", flush=True)

    # ---------------- phase 3: the main path --------------------------------
    fac = T.make_mpf(n, r=r, policy=T.MPF_BF16)
    main_counts = None
    bf16_policy_ms = {}
    classic = {}   # corpus -> phase 3's result, the reference of phases 6, 7 and 8
    for corpus, gen in (("hpl_ai", matgen.hpl_ai_matrix), ("uniform", matgen.random_dense)):
        a0 = torch.from_numpy(gen(n, seed=0)).to(dev)
        work = a0.clone()
        torch.cuda.synchronize()
        _lib.reset_counts()
        t1 = time.perf_counter()
        res = fac(work)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t1
        launched = dict(_lib.launches)
        plain = dict(_lib.plain_calls)
        copies = _lib.copies["gemm_operand"]
        if main_counts is None:
            main_counts = launched
        counters_ok = (all(launched[k] > 0 for k in FUSED) and not any(plain.values())
                       and not any(launched[k] for k in _lib.KERNELS if k not in FUSED))
        rep = check_factorization_device(a0, res.lu, res.ipiv, nbe_tol=NBE_TOL)
        perm = res.perm.long()
        is_perm = torch.equal(torch.sort(perm).values, torch.arange(n, device=dev))
        consistent = torch.equal(ipiv_to_perm(res.ipiv).to(dev), perm)
        finite = bool(torch.isfinite(res.lu).all())
        med, runs = cuda_time(fac, a0, warmup=1, iters=3,
                              setup=lambda x: (x.clone(),))[:2]
        bf16_policy_ms[corpus] = med * 1e3
        phase(f"mpf_factorize_{corpus}",
              rep.ok and is_perm and consistent and finite and counters_ok
              and int(res.info) == 0 and copies == 0,
              n=n, policy="mpf_bf16", r=r, nbe=f"{rep.normwise_backward_err:.3e}",
              max_abs=f"{rep.max_abs_err:.3e}", perm_ok=is_perm and consistent,
              info=int(res.info), launches=json.dumps(launched, separators=(",", ":")),
              plain_calls=sum(plain.values()), operand_copies=copies,
              first_run_s=f"{first_s:.3f}", median_ms=f"{med * 1e3:.2f}",
              runs_ms="/".join(f"{t * 1e3:.2f}" for t in runs),
              tflops=f"{tflops(n, med):.2f}", card=f"'{smi}'")
        classic[corpus] = res
        del a0, work, res
        torch.cuda.empty_cache()

    # ---------------- phase 4: the masked path -----------------------------
    def masked_run(tag, n4, r4, policy, corpus, gen, pivot, block, tol, timed,
                   fused_panels, masked_panels):
        """One factorization off the fused path.  ``fused_panels`` and
        ``masked_panels`` are the routing the run must show, stated here and
        not derived from the driver: a block column the fused gate admits
        takes the fused path (the JAX package's routing) and launches kernels
        1-3 once a panel; a masked panel launches kernel 8 once, and kernel 7
        once when it pivots."""
        a0 = torch.from_numpy(gen(n4, seed=0)).to(dev)
        fac4 = T.make_mpf(n4, r=r4, policy=policy, pivot=pivot, block=block)
        work = a0.clone()
        torch.cuda.synchronize()
        _lib.reset_counts()
        t1 = time.perf_counter()
        res = fac4(work)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t1
        launched = dict(_lib.launches)
        plain = dict(_lib.plain_calls)
        copies = _lib.copies["gemm_operand"]
        bf16 = policy.working == BF
        masked = MASKED_BF16 if bf16 else MASKED
        want = set(masked if pivot else ("tri_inv", "trailing_sub")
                   + (("u12_product",) if bf16 else ("npv_inv",)))
        if fused_panels:
            want |= set(FUSED_BF16 if bf16 else FUSED)
        counters_ok = (all(launched[k] > 0 for k in want) and not any(plain.values())
                       and not any(launched[k] for k in _lib.KERNELS if k not in want)
                       and launched["strip_pivots"] == fused_panels
                       and launched["npv_inv"] == (0 if bf16 else masked_panels)
                       and launched["hgetf2"] == (masked_panels if pivot else 0))
        rep = check_factorization_device(a0, res.lu, res.ipiv, nbe_tol=tol)
        perm = res.perm.long()
        is_perm = torch.equal(torch.sort(perm).values, torch.arange(n4, device=dev))
        consistent = torch.equal(ipiv_to_perm(res.ipiv).to(dev), perm)
        ident = torch.equal(res.ipiv.cpu(), torch.arange(1, n4 + 1, dtype=torch.int32))
        finite = bool(torch.isfinite(res.lu).all())
        fields = {}
        if timed:
            med, runs = cuda_time(fac4, a0, warmup=1, iters=3,
                                  setup=lambda x: (x.clone(),))[:2]
            fields = {"median_ms": f"{med * 1e3:.2f}",
                      "runs_ms": "/".join(f"{t * 1e3:.2f}" for t in runs),
                      "tflops": f"{tflops(n4, med):.2f}"}
        phase(f"masked_{tag}_{corpus}",
              rep.ok and is_perm and consistent and finite and counters_ok
              and int(res.info) == 0 and (pivot or ident) and copies == 0,
              n=n4, policy=policy.name, r=r4, block=block, pivot=pivot,
              nbe=f"{rep.normwise_backward_err:.3e}", max_abs=f"{rep.max_abs_err:.3e}",
              perm_ok=is_perm and consistent, ipiv_identity=ident, info=int(res.info),
              fused_panels=fused_panels, masked_panels=masked_panels,
              launches=json.dumps(launched, separators=(",", ":")),
              plain_calls=sum(plain.values()), operand_copies=copies,
              first_run_s=f"{first_s:.3f}", **fields,
              card=f"'{smi}'")
        del a0, work, res
        torch.cuda.empty_cache()
        return launched

    # MPF_FP16 saturates, so nothing is fused: 128 masked panels of 128
    masked_counts = None
    for corpus, gen in (("hpl_ai", matgen.hpl_ai_matrix), ("uniform", matgen.random_dense)):
        cnt = masked_run("mpf_fp16", n, r, T.MPF_FP16, corpus, gen, True, None,
                         NBE_TOL_FP16, True, fused_panels=0, masked_panels=n // r)
        masked_counts = masked_counts or cnt
    # block columns 0..3000 are 1000 wide (1000 % 48 != 0): 4 x 21 masked
    # panels; the last is 96 wide and passes the fused gate: 2 fused panels
    masked_run("mpf_bf16_r48_block1000", 4096, 48, T.MPF_BF16, "uniform",
               matgen.random_dense, True, 1000, NBE_TOL, False,
               fused_panels=2, masked_panels=84)
    # pivot=False is never fused
    masked_run("pivot_false_pure_fp32", n, r, T.PURE_FP32, "hpl_ai", matgen.hpl_ai_matrix,
               False, None, NBE_TOL_FP32, True, fused_panels=0, masked_panels=n // r)

    # ---------------- phase 5: ALL_BF16 on the fused path ------------------
    fac5 = T.make_mpf(n, r=r, policy=T.ALL_BF16)
    want5 = fused_counts(n, r, bc, bf16=True)
    bf16_counts = None
    classic_bf16 = {}  # corpus -> phase 5's result, the reference of phase 6b
    all_bf16_ms = {}
    for corpus, gen in (("hpl_ai", matgen.hpl_ai_matrix), ("uniform", matgen.random_dense)):
        a0 = torch.from_numpy(gen(n, seed=0)).to(dev)
        a0b = a0.to(BF)                    # the working copy's values
        work = a0b.clone()
        torch.cuda.synchronize()
        _lib.reset_counts()
        t1 = time.perf_counter()
        res = fac5(work)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t1
        launched = dict(_lib.launches)
        plain = dict(_lib.plain_calls)
        copies = _lib.copies["gemm_operand"]
        inst5 = dict(_lib.trailing_instances)
        bf16_counts = bf16_counts or launched
        counters_ok = (not any(plain.values())
                       and all(launched[k] == want5.get(k, 0) for k in _lib.KERNELS)
                       and inst5["staged"] == launched["trailing_sub"])
        rep5 = check_factorization_device(a0, res.lu, res.ipiv, nbe_tol=NBE_TOL_BF16)
        perm = res.perm.long()
        is_perm = torch.equal(torch.sort(perm).values, torch.arange(n, device=dev))
        consistent = torch.equal(ipiv_to_perm(res.ipiv).to(dev), perm)
        finite = bool(torch.isfinite(res.lu).all())
        in_place = res.lu.data_ptr() == work.data_ptr() and res.lu.dtype == BF
        med, runs = cuda_time(fac5, a0b, warmup=1, iters=3, setup=lambda x: (x.clone(),))[:2]
        phase(f"all_bf16_{corpus}",
              rep5.ok and is_perm and consistent and finite and counters_ok and in_place
              and int(res.info) == 0 and copies == 0,
              n=n, policy="all_bf16", r=r, nbe=f"{rep5.normwise_backward_err:.3e}",
              max_abs=f"{rep5.max_abs_err:.3e}", perm_ok=is_perm and consistent,
              info=int(res.info), launches=json.dumps(launched, separators=(",", ":")),
              trailing_instances=json.dumps(inst5, separators=(",", ":")),
              plain_calls=sum(plain.values()), operand_copies=copies,
              first_run_s=f"{first_s:.3f}", median_ms=f"{med * 1e3:.2f}",
              runs_ms="/".join(f"{t * 1e3:.2f}" for t in runs), mpf_bf16_median_ms=f"{bf16_policy_ms[corpus]:.2f}",
              tflops=f"{tflops(n, med):.2f}", card=f"'{smi}'")
        classic_bf16[corpus] = res
        all_bf16_ms[corpus] = med * 1e3
        del a0, a0b, work, res
        torch.cuda.empty_cache()

    # ---------------- phase 5b: ALL_BF16 at n = 65536 ----------------------
    nb = BIG_N
    t1 = time.perf_counter()
    big_a = matgen.hpl_ai_matrix_device(nb, seed=0, dtype=BF, device=dev)
    work = big_a.clone()
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t1
    fac5b = T.make_mpf(nb, r=r, policy=T.ALL_BF16)
    resident = torch.cuda.memory_allocated()   # the matrix, its copy, earlier phases'
    live_gib, largest = live_cuda_tensors()
    print(f"[INFO] before 5b: {resident / 2**30:.2f} GiB allocated, {live_gib:.2f} GiB held by "
          f"live tensors, largest {largest}", flush=True)
    torch.cuda.reset_peak_memory_stats()
    _lib.reset_counts()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    res = fac5b(work)
    end.record()
    end.synchronize()
    big_ms = start.elapsed_time(end)
    fac_peak = torch.cuda.max_memory_allocated()
    launched = dict(_lib.launches)
    copies = _lib.copies["gemm_operand"]
    inst5b = dict(_lib.trailing_instances)
    want5b = fused_counts(nb, r, bc, bf16=True)
    counters_ok = (not any(_lib.plain_calls.values())
                   and all(launched[k] == want5b.get(k, 0) for k in _lib.KERNELS)
                   and inst5b["staged"] == launched["trailing_sub"])
    lu, ipiv, info = res.lu, res.ipiv, int(res.info)
    perm5b = res.perm                # 5b's pivots and row map, the reference of 7b
    finite = bool(torch.isfinite(lu).all())
    del res
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rep5b = check_factorization_device(big_a, lu, ipiv, nbe_tol=NBE_TOL_BF16, chunk=2048)
    oracle_peak = torch.cuda.max_memory_allocated()
    phase("all_bf16_n65536_hpl_ai",
          rep5b.ok and counters_ok and finite and info == 0 and copies == 0,
          n=nb, policy="all_bf16", r=r, nbe=f"{rep5b.normwise_backward_err:.3e}",
          info=info, launches=json.dumps(launched, separators=(",", ":")), operand_copies=copies,
          trailing_instances=json.dumps(inst5b, separators=(",", ":")),
          ms=f"{big_ms:.2f}", tflops=f"{tflops(nb, big_ms / 1e3):.2f}",
          generate_s=f"{gen_s:.2f}", resident_gib_before=f"{resident / 2**30:.2f}",
          peak_gib_factorization=f"{fac_peak / 2**30:.2f}",
          peak_gib_oracle=f"{oracle_peak / 2**30:.2f}", card=f"'{smi}'")
    del work, lu
    torch.cuda.empty_cache()

    # ---------------- phase 6b at n = 65536: lookahead beside 5b -----------
    fac6b = T.make_mpf(nb, r=r, policy=T.ALL_BF16, lookahead=True)
    work = big_a.clone()
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _lib.reset_counts()
    start.record()
    res = fac6b(work)
    end.record()
    end.synchronize()
    la_ms = start.elapsed_time(end)
    la_peak = torch.cuda.max_memory_allocated()
    launched = dict(_lib.launches)
    copies = _lib.copies["gemm_operand"]
    want6b = fused_counts(nb, r, bc, bf16=True, lookahead=True)
    counters_ok = (not any(_lib.plain_calls.values())
                   and all(launched[k] == want6b.get(k, 0) for k in _lib.KERNELS))
    lu, info = res.lu, int(res.info)
    same_piv = torch.equal(res.ipiv, ipiv)
    finite = bool(torch.isfinite(lu).all())
    rep6b = check_factorization_device(big_a, lu, res.ipiv, nbe_tol=NBE_TOL_BF16, chunk=2048)
    phase("lookahead_all_bf16_n65536_hpl_ai",
          rep6b.ok and counters_ok and finite and info == 0 and same_piv and copies == 0,
          n=nb, policy="all_bf16", r=r, nbe=f"{rep6b.normwise_backward_err:.3e}", info=info,
          pivots_equal_5b=same_piv, launches=json.dumps(launched, separators=(",", ":")),
          operand_copies=copies,
          ms=f"{la_ms:.2f}", classic_5b_ms=f"{big_ms:.2f}",
          tflops=f"{tflops(nb, la_ms / 1e3):.2f}", resident_gib_before=f"{resident / 2**30:.2f}",
          peak_gib_factorization=f"{la_peak / 2**30:.2f}", card=f"'{smi}'")
    del big_a, work, lu, res
    torch.cuda.empty_cache()

    # ---------------- phase 7b: deferred ALL_BF16 at n = 65536 -------------
    # the pre-extended input made on the card: its first n rows are 5b's
    # matrix bit for bit, so 5b's pivots and row map are the reference
    ov7 = DEFER_S * bc
    t1 = time.perf_counter()
    ext = matgen.hpl_ai_matrix_device(nb, seed=0, dtype=BF, device=dev, ext_rows=ov7)
    big_a = ext[:nb].clone()                  # the oracle's A
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t1
    fac7b = T.make_mpf(nb, r=r, policy=T.ALL_BF16, defer=DEFER_S)
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _lib.reset_counts()
    start.record()
    res = fac7b(ext)
    end.record()
    end.synchronize()
    d_ms = start.elapsed_time(end)
    d_peak = torch.cuda.max_memory_allocated()
    launched = dict(_lib.launches)
    copies = _lib.copies["gemm_operand"]
    want7b = fused_counts(nb, r, bc, bf16=True, defer_s=DEFER_S)
    counters_ok = (not any(_lib.plain_calls.values())
                   and all(launched[k] == want7b.get(k, 0) for k in _lib.KERNELS))
    in_place = res.lu.data_ptr() == ext.data_ptr()
    same_piv = torch.equal(res.ipiv, ipiv) and torch.equal(res.perm, perm5b)
    info = int(res.info)
    finite = bool(torch.isfinite(res.lu).all())
    rep7b = check_factorization_device(big_a, res.lu, res.ipiv, nbe_tol=NBE_TOL_BF16, chunk=2048)
    phase("defer_all_bf16_n65536_hpl_ai",
          rep7b.ok and counters_ok and finite and info == 0 and same_piv and in_place
          and copies == 0,
          n=nb, policy="all_bf16", r=r, defer=DEFER_S, overflow_rows=ov7,
          nbe=f"{rep7b.normwise_backward_err:.3e}", info=info, pivots_and_perm_equal_5b=same_piv,
          pre_extended_in_place=in_place, launches=json.dumps(launched, separators=(",", ":")),
          operand_copies=copies,
          ms=f"{d_ms:.2f}", classic_5b_ms=f"{big_ms:.2f}",
          tflops=f"{tflops(nb, d_ms / 1e3):.2f}", generate_s=f"{gen_s:.2f}",
          resident_gib_before=f"{resident / 2**30:.2f}",
          peak_gib_factorization=f"{d_peak / 2**30:.2f}", card=f"'{smi}'")
    del ext, big_a, res
    torch.cuda.empty_cache()

    # ---------------- phase 8b: the pair layout, ALL_BF16 at n = 65536 -----
    # hpl_ai_matrix_device(pairs=True) is 5b's matrix bit for bit, as an
    # (n/2, 2, n) tensor factored in place: 5b's pivots and row map are the
    # reference
    t1 = time.perf_counter()
    a3 = matgen.hpl_ai_matrix_device(nb, seed=0, dtype=BF, device=dev, pairs=True)
    big_a = as_matrix(a3).clone()             # the oracle's A
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t1
    fac8b = T.make_mpf(nb, r=r, policy=T.ALL_BF16)
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _lib.reset_counts()
    start.record()
    res = fac8b(a3)
    end.record()
    end.synchronize()
    p_ms = start.elapsed_time(end)
    p_peak = torch.cuda.max_memory_allocated()
    launched = dict(_lib.launches)
    copies = _lib.copies["gemm_operand"]
    want8b = fused_counts(nb, r, bc, bf16=True, pairs=True)
    counters_ok = (not any(_lib.plain_calls.values())
                   and all(launched[k] == want8b.get(k, 0) for k in _lib.KERNELS))
    in_place = res.lu.data_ptr() == a3.data_ptr() and tuple(res.lu.shape) == (nb // 2, 2, nb)
    same_piv = torch.equal(res.ipiv, ipiv) and torch.equal(res.perm, perm5b)
    info = int(res.info)
    lu8b = as_matrix(res.lu)
    finite = bool(torch.isfinite(lu8b).all())
    rep8b = check_factorization_device(big_a, lu8b, res.ipiv, nbe_tol=NBE_TOL_BF16, chunk=2048)
    phase("pairs_all_bf16_n65536_hpl_ai",
          rep8b.ok and counters_ok and finite and info == 0 and same_piv and in_place
          and copies == 0,
          n=nb, policy="all_bf16", r=r, nbe=f"{rep8b.normwise_backward_err:.3e}", info=info,
          pivots_and_perm_equal_5b=same_piv, pair_layout_in_place=in_place,
          launches=json.dumps(launched, separators=(",", ":")), operand_copies=copies,
          ms=f"{p_ms:.2f}",
          classic_5b_ms=f"{big_ms:.2f}", ratio_to_5b=f"{p_ms / big_ms:.4f}",
          tflops=f"{tflops(nb, p_ms / 1e3):.2f}", generate_s=f"{gen_s:.2f}",
          resident_gib_before=f"{resident / 2**30:.2f}",
          peak_gib_factorization=f"{p_peak / 2**30:.2f}", card=f"'{smi}'")
    del a3, big_a, res, lu8b, ipiv, perm5b
    torch.cuda.empty_cache()

    # ---------------- phases 5c, 5d: ALL_BF16 off the fused path -----------
    # block columns 0..3000 are 1000 wide: 4 x 21 masked panels, and the
    # 96-wide last one 2 fused panels, as phase 4 routes MPF_BF16
    masked_run("all_bf16_r48_block1000", 4096, 48, T.ALL_BF16, "uniform",
               matgen.random_dense, True, 1000, NBE_TOL_BF16, False,
               fused_panels=2, masked_panels=84)
    masked_run("all_bf16_pivot_false", 4096, r, T.ALL_BF16, "hpl_ai", matgen.hpl_ai_matrix,
               False, None, NBE_TOL_BF16, False, fused_panels=0, masked_panels=4096 // r)

    # ---------------- phases 6-8: lookahead, deferred exchange, pairs -----
    def variant_run(tag, fac6, policy, corpus, gen, want, tol, ref, ref_ms,
                    same_pivots: bool, bitwise: bool = False, pairs: bool = False,
                    keep=None):
        """One n = 16384 factorization through a variant of the fused loop.
        Counts set to 0 just before it and read just after must equal
        ``want`` exactly; the device oracle at ``tol``; pivots and row map
        against ``ref`` (the classic loop's in this run): equal where
        ``same_pivots``, else the first differing pivot is printed; with
        ``bitwise`` the factors too; median of 3 beside ``ref_ms``.
        ``ref`` None: the classic loop itself, compared with nothing.
        ``pairs``: the matrix goes in as its (n/2, 2, n) view, the factors
        come back so, and their largest difference from ``ref``'s is
        printed.  ``keep``: a dict that takes ``corpus -> (result, median
        ms)``."""
        a0 = torch.from_numpy(gen(n, seed=0)).to(dev)
        a0w = a0.to(policy.working)
        if pairs:
            a0w = a0w.view(n // 2, 2, n)
        work = a0w.clone()
        torch.cuda.synchronize()
        _lib.reset_counts()
        t1 = time.perf_counter()
        res = fac6(work)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t1
        launched = dict(_lib.launches)
        plain = dict(_lib.plain_calls)
        copies = _lib.copies["gemm_operand"]
        counters_ok = (not any(plain.values())
                       and all(launched[k] == want.get(k, 0) for k in _lib.KERNELS))
        fields = {}
        lu = res.lu
        if pairs:
            ok_shape = tuple(lu.shape) == (n // 2, 2, n) and lu.data_ptr() == work.data_ptr()
            counters_ok = counters_ok and ok_shape
            lu = as_matrix(lu)
            fields = dict(pair_layout_in_place=ok_shape,
                          max_abs_diff_lu_vs_2d=f"{absd(lu, ref.lu):.3e}")
        rep6 = check_factorization_device(a0, lu, res.ipiv, nbe_tol=tol)
        perm = res.perm.long()
        is_perm = torch.equal(torch.sort(perm).values, torch.arange(n, device=dev))
        consistent = torch.equal(ipiv_to_perm(res.ipiv).to(dev), perm)
        finite = bool(torch.isfinite(lu).all())
        first_diff, piv_eq = None, None
        if ref is not None:
            diff = (res.ipiv != ref.ipiv).nonzero()
            first_diff = int(diff[0]) if diff.numel() else None
            piv_eq = first_diff is None and torch.equal(res.perm, ref.perm)
            if bitwise:
                fields["bitwise_equal_classic"] = piv_eq and torch.equal(res.lu, ref.lu)
            else:
                fields["factors_bitwise_equal_classic"] = piv_eq and torch.equal(lu, ref.lu)
        med, runs = cuda_time(fac6, a0w, warmup=1, iters=3, setup=lambda x: (x.clone(),))[:2]
        if ref_ms is not None:
            fields["classic_median_ms"] = f"{ref_ms:.2f}"
        phase(f"{tag}_{corpus}",
              rep6.ok and is_perm and consistent and finite and counters_ok
              and int(res.info) == 0 and (piv_eq or not same_pivots) and copies == 0
              and fields.get("bitwise_equal_classic", True),
              n=n, policy=policy.name, r=r, nbe=f"{rep6.normwise_backward_err:.3e}",
              perm_ok=is_perm and consistent, info=int(res.info),
              pivots_equal_classic=piv_eq, first_differing_pivot=first_diff, **fields,
              launches=json.dumps(launched, separators=(",", ":")),
              plain_calls=sum(plain.values()), operand_copies=copies,
              first_run_s=f"{first_s:.3f}", median_ms=f"{med * 1e3:.2f}",
              runs_ms="/".join(f"{t * 1e3:.2f}" for t in runs), tflops=f"{tflops(n, med):.2f}",
              card=f"'{smi}'")
        if keep is not None:
            keep[corpus] = (res, med * 1e3)
        del a0, a0w, work, res
        torch.cuda.empty_cache()
        return launched

    corpora = (("hpl_ai", matgen.hpl_ai_matrix), ("uniform", matgen.random_dense))
    # 3b: MPF_REF on the fused path (kernels 3 and 6 with fp32 operands, the
    # FFMA routine), then the lookahead driver (kernel 13's FFMA instance);
    # lookahead's pivots equal to the classic loop's on HPL-AI
    fac3b = T.make_mpf(n, r=r, policy=T.MPF_REF)
    fac3b_la = T.make_mpf(n, r=r, policy=T.MPF_REF, lookahead=True)
    mpf_ref = {}
    for corpus, gen in corpora:
        variant_run("mpf_ref", fac3b, T.MPF_REF, corpus, gen, fused_counts(n, r, bc),
                    NBE_TOL_FP32, None, None, same_pivots=False, keep=mpf_ref)
        variant_run("lookahead_mpf_ref", fac3b_la, T.MPF_REF, corpus, gen,
                    fused_counts(n, r, bc, lookahead=True), NBE_TOL_FP32, mpf_ref[corpus][0],
                    mpf_ref[corpus][1], same_pivots=corpus == "hpl_ai")
        del mpf_ref[corpus]
        torch.cuda.empty_cache()
    # 6: lookahead, MPF_BF16 (kernel 13 in place of kernel 4 for block
    # columns 1-14); HPL-AI's pivots must equal phase 3's
    fac6 = T.make_mpf(n, r=r, policy=T.MPF_BF16, lookahead=True)
    want6 = fused_counts(n, r, bc, lookahead=True)
    lookahead_counts = None
    for corpus, gen in corpora:
        cnt = variant_run("lookahead_mpf_bf16", fac6, T.MPF_BF16, corpus, gen, want6,
                          NBE_TOL, classic[corpus], bf16_policy_ms[corpus],
                          same_pivots=corpus == "hpl_ai")
        lookahead_counts = lookahead_counts or cnt
    # 6b: lookahead under ALL_BF16 at n = 16384, beside phase 5
    fac6b = T.make_mpf(n, r=r, policy=T.ALL_BF16, lookahead=True)
    want6b = fused_counts(n, r, bc, bf16=True, lookahead=True)
    for corpus, gen in corpora:
        variant_run("lookahead_all_bf16", fac6b, T.ALL_BF16, corpus, gen, want6b,
                    NBE_TOL_BF16, classic_bf16[corpus], all_bf16_ms[corpus],
                    same_pivots=corpus == "hpl_ai")
    # 7: the deferred exchange, S = 8 (two groups): bitwise the classic
    # loop's result, the band copy in every block column and one flush a group
    fac7 = T.make_mpf(n, r=r, policy=T.MPF_BF16, defer=DEFER_S)
    want7 = fused_counts(n, r, bc, defer_s=DEFER_S)
    defer_counts = None
    for corpus, gen in corpora:
        cnt = variant_run("defer_8_mpf_bf16", fac7, T.MPF_BF16, corpus, gen, want7, NBE_TOL,
                          classic[corpus], bf16_policy_ms[corpus], same_pivots=True,
                          bitwise=True)
        defer_counts = defer_counts or cnt
    # 8: the pair layout, MPF_BF16 beside phase 3 and ALL_BF16 beside phase
    # 5, on the same matrices viewed as (n/2, 2, n): HPL-AI's pivots and row
    # map equal to the 2D loop's
    pair_counts = None
    for policy, ref2d, ref_ms, tol in ((T.MPF_BF16, classic, bf16_policy_ms, NBE_TOL),
                                       (T.ALL_BF16, classic_bf16, all_bf16_ms, NBE_TOL_BF16)):
        fac8 = T.make_mpf(n, r=r, policy=policy)
        want8 = fused_counts(n, r, bc, bf16=policy is T.ALL_BF16, pairs=True)
        for corpus, gen in corpora:
            cnt = variant_run(f"pairs_{policy.name}", fac8, policy, corpus, gen, want8, tol,
                              ref2d[corpus], ref_ms[corpus], same_pivots=corpus == "hpl_ai",
                              pairs=True)
            pair_counts = pair_counts or cnt
    del classic, classic_bf16
    torch.cuda.empty_cache()

    for name in _lib.KERNELS:
        if name in PROBES:
            kern[name].update(launches=int(probe_counts[name]), launches_per_factorization=0,
                              path="tools (python -m mpf_tpu_torch.tools.*, phase 2g)")
            continue
        if name in ROWS11:
            kern[name].update(launches=int(launched11[name]), launches_per_factorization=0,
                              path="none (tests and phase 2d)")
            continue
        counts = (main_counts if name in FUSED else masked_counts if name in MASKED
                  else lookahead_counts if name == "gemmx"
                  else defer_counts if name in DEFER
                  else pair_counts if name in PAIRS else bf16_counts)
        kern[name]["launches"] = int(counts[name])
        if name in FUSED and name in MASKED:
            kern[name]["launches_masked"] = int(masked_counts[name])
        if name in FUSED_BF16 and name in FUSED + MASKED:
            kern[name]["launches_all_bf16"] = int(bf16_counts[name])
        paths = [p for p, ks in (("fused", FUSED), ("masked", MASKED),
                                 ("all_bf16", FUSED_BF16 + ("u12_product",)),
                                 ("lookahead", ("gemmx",)),
                                 ("deferred_exchange", DEFER),
                                 ("pair_layout", FUSED + FUSED_BF16 + PAIRS))
                 if name in ks]
        kern[name]["path"] = "+".join(paths) if paths else (
            "none (tests only)" if name == "panel_update_full" else "none (distributed path)")
    print(f"[INFO] wall_s={time.perf_counter() - wall0:.1f}", flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": [kern[k] for k in _lib.KERNELS]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeError as exc:
        print(f"chip_smoke: {exc}", file=sys.stderr)
        sys.exit(1)
