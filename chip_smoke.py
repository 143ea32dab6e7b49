"""GPU smoke test of the PyTorch port (mpf_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, one line each:
  1. device check and the kernel build (nvcc, sm_90a) from csrc/;
  2. each of the six kernels against its plain PyTorch version on the card,
     at the main path's shapes (n = 16384, r = 128, block 1024, MPF_BF16);
  3. mpf_factorize at n = 16384, MPF_BF16, r = 128 on the HPL-AI matrix and
     on the uniform (pivot-heavy) matrix: device fp64 oracle (nbe <= 1e-3),
     perm consistent with ipiv, every kernel launched and no plain version
     called in the main path's run, and the median of 3 timed runs.
Then the card's name and power limit, one JSON line of per-kernel results,
and as the last line the contract line
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
NBE_TOL = 1e-3  # the JAX package's MPF_BF16 oracle bound


class SmokeError(RuntimeError):
    pass


def fail(msg: str):
    raise SmokeError(msg)


def phase(name: str, ok: bool, **fields) -> None:
    parts = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[{'PASS' if ok else 'FAIL'}] {name} {parts}", flush=True)
    if not ok:
        fail(f"phase {name} failed")


def event_ms(fn, reps: int = 5) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` runs, CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def dyadic(rng, m, r):
    a = (rng.integers(-4, 5, (m, r)) * 2.0 ** rng.integers(-2, 3, (m, r))).astype(np.float32)
    a[a == 0] = 1.0
    return a


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    import mpf_tpu_torch as T
    from mpf_tpu_torch.ops import _lib
    from mpf_tpu_torch.ops.blas3 import _leaves, tri_inv_leaves, tri_inv_leaves_plain
    from mpf_tpu_torch.ops.exchange import rows_exchange, rows_exchange_plain
    from mpf_tpu_torch.ops.panel_fused import (
        panel_apply_update_trim, panel_apply_update_trim_plain,
        rowblock_assemble, rowblock_assemble_plain,
        trailing_gemm_sub, trailing_gemm_sub_plain)
    from mpf_tpu_torch.ops.panel_strip import strip_panel_pivots, strip_panel_pivots_plain
    from mpf_tpu_torch.utils import matgen
    from mpf_tpu_torch.utils.oracle import check_factorization_device, ipiv_to_perm
    from mpf_tpu_torch.utils.timing import cuda_time, tflops

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = smi_line()
    print(f"device: {kind} count={count} torch={torch.__version__} "
          f"cuda={torch.version.cuda} smi='{smi}'", flush=True)
    t0 = time.perf_counter()
    so = _lib.build()
    _lib.lib()
    phase("build", True, lib=so.name, seconds=f"{time.perf_counter() - t0:.1f}")
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
    }
    source = {
        "strip_pivots": "mpf_tpu_torch/csrc/strip_pivots.cu",
        "rowblock": "mpf_tpu_torch/csrc/rowblock.cu",
        "panel_update": "mpf_tpu_torch/csrc/panel_update.cu",
        "rows_exchange": "mpf_tpu_torch/csrc/exchange.cu",
        "tri_inv": "mpf_tpu_torch/csrc/tri_inv.cu",
        "trailing_sub": "mpf_tpu_torch/csrc/gemm_sub.cu",
    }

    def record(name, abs_err, rel_err, ms, plain_ms):
        kern[name] = {"name": name, "route": "cuda", "source": source[name],
                      "replaces": replaces[name], "launches": 0,
                      "max_abs_err": float(abs_err), "rel_err": float(rel_err),
                      "ms": float(ms), "plain_ms": float(plain_ms)}

    # ---------------- phase 2: kernels vs plain at the slice's shapes -------
    rng = np.random.default_rng(0)
    hpl = torch.from_numpy(matgen.hpl_ai_matrix(n, seed=1)).to(dev)
    slab0 = hpl[:, :bc].contiguous()           # first block column, m = n
    pos0 = torch.arange(n, dtype=torch.int32, device=dev)

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
    record("strip_pivots", *errs(pairs1), ms, pms)

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
            del s_t
            slab_z = slab.clone()
            g0, g1 = int(glist1[0]), int(glist1[1])
            # second pivot row := first pivot row, so the second pivot is 0
            slab_z[g1, :r] = slab_z[g0, :r]
            _, _, iz_k = rowblock_assemble(slab_z, glist1, 0)
            _, _, iz_p = rowblock_assemble_plain(slab_z, glist1, 0)
            phase("k2_rowblock_zero_pivot", int(iz_k) == int(iz_p) == 2,
                  info_kernel=int(iz_k), info_plain=int(iz_p))
            del slab_z
    record("rowblock", abs2, err2, ms2, pms2)
    record("panel_update", abs3, err3, ms3, pms3)

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
    record("rows_exchange", *err4, ms, pms)
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
    record("tri_inv", *err5, ms, pms)

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
    record("trailing_sub", err6, rel6, ms, pms)
    del a_k, a_p, l21, u12, hpl
    torch.cuda.empty_cache()

    # ---------------- phase 3: the main path --------------------------------
    fac = T.make_mpf(n, r=r, policy=T.MPF_BF16)
    main_counts = None
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
        if main_counts is None:
            main_counts = launched
        counters_ok = all(v > 0 for v in launched.values()) and not any(plain.values())
        rep = check_factorization_device(a0, res.lu, res.ipiv, nbe_tol=NBE_TOL)
        perm = res.perm.long()
        is_perm = torch.equal(torch.sort(perm).values, torch.arange(n, device=dev))
        consistent = torch.equal(ipiv_to_perm(res.ipiv).to(dev), perm)
        finite = bool(torch.isfinite(res.lu).all())
        med, runs, _ = cuda_time(fac, a0, warmup=1, iters=3,
                                 setup=lambda x: (x.clone(),))
        phase(f"mpf_factorize_{corpus}",
              rep.ok and is_perm and consistent and finite and counters_ok
              and int(res.info) == 0,
              n=n, policy="mpf_bf16", r=r, nbe=f"{rep.normwise_backward_err:.3e}",
              max_abs=f"{rep.max_abs_err:.3e}", perm_ok=is_perm and consistent,
              info=int(res.info), launches=json.dumps(launched, separators=(",", ":")),
              plain_calls=sum(plain.values()), first_run_s=f"{first_s:.3f}",
              median_ms=f"{med * 1e3:.2f}",
              runs_ms="/".join(f"{t * 1e3:.2f}" for t in runs),
              tflops=f"{tflops(n, med):.2f}", card=f"'{smi}'")
        del a0, work, res
        torch.cuda.empty_cache()

    for name in _lib.KERNELS:
        kern[name]["launches"] = int(main_counts[name])
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
