"""Port of tools/tpu_3d_micro.py: the relayouts and the 3-D-operand GEMM tile
of the pair layout, on the card.

On the TPU these legs asked whether leading-dimension reshapes of on-chip
values compile and run at speed.  On the card a contiguous (c, 2, w) tensor
and its (2c, w) view are the same bytes, so the functions are copies and a
transpose:

  collapse  (c, 2, w) -> (2c, w)   a copy (kernel 15a's mpf_block_copy)   16g
  split     (2c, w) -> (c, 2, w)   a copy (mpf_block_copy)                16g
  tchunk    (c, 2, w) -> (w, 2c)   the transpose (mpf_probe_transpose)    16g
  gemm3d    out (s/2, 2, w) = T(f32(C3) - reshape(A3)(s, k) @ B), the forms
            ``reshape`` and ``dotg`` being one function: C3 copied into out
            (mpf_block_copy), then kernel 6 (mpf_trailing_sub) in place on
            it: bf16 on the tensor cores, fp32 on FFMA (never TF32)       16h

Usage: python -m mpf_tpu_torch.tools.micro_3d [--device cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from mpf_tpu_torch.ops import _lib
from mpf_tpu_torch.ops.blas3 import ieee_fp32
from mpf_tpu_torch.ops.pair3d import _block_copy
from mpf_tpu_torch.ops.panel_fused import trailing_staged
from mpf_tpu_torch.tools import device, errors, finish, leg, max_abs, parser, rate, time_ms
from mpf_tpu_torch.utils.oracle import sum_slack, within_bf16_ulp

C, WC = 1024, 512             # the copy legs' (c, 2, w)
S, K, WG = 2048, 1024, 2048   # the GEMM legs' (s, k, w)
RELAYOUTS = ("collapse", "split", "tchunk")
FORMS = ("reshape", "dotg")
DTYPES = (torch.bfloat16, torch.float32)


# --------------------------------------------------------------------------
# 16g: collapse, split, tchunk
# --------------------------------------------------------------------------

def _relayout_check(a, mode):
    _lib.check(mode in RELAYOUTS, f"relayout: mode must be one of {RELAYOUTS}")
    split = mode == "split"
    if split:
        shape_ok = a.dim() == 2 and a.shape[0] % 2 == 0
    else:
        shape_ok = a.dim() == 3 and a.shape[1] == 2
    _lib.check(shape_ok and a.is_contiguous() and a.dtype in DTYPES,
               f"relayout {mode}: a contiguous fp32 or bf16 "
               f"{'(2c, w)' if split else '(c, 2, w)'} array")


def relayout_plain(a, mode: str):
    """Plain version of :func:`relayout`."""
    _lib.counted_plain("probe_relayout")
    _relayout_check(a, mode)
    w = a.shape[-1]
    if mode == "collapse":
        return a.reshape(-1, w).clone()
    if mode == "split":
        return a.reshape(a.shape[0] // 2, 2, w).clone()
    return a.reshape(-1, w).t().contiguous()


def relayout(a, mode: str):
    """A new tensor: ``collapse`` (c, 2, w) -> (2c, w), ``split`` (2c, w) ->
    (c, 2, w) (a copy each), ``tchunk`` (c, 2, w) -> (w, 2c), the transpose.
    CPU tensors take the plain version; CUDA tensors launch kernel 15a's
    ``mpf_block_copy`` or ``mpf_probe_transpose``."""
    _relayout_check(a, mode)
    if not _lib.on_cuda(a):
        return relayout_plain(a, mode)
    w = a.shape[-1]
    flat = a.view(-1, w)
    if mode == "tchunk":
        out = torch.empty((w, flat.shape[0]), dtype=a.dtype, device=a.device)
        _lib.call("mpf_probe_transpose", flat.shape[0], w, flat.data_ptr(), flat.stride(0),
                  out.data_ptr(), out.stride(0), a.element_size())
    else:
        shape = (flat.shape[0], w) if mode == "collapse" else (flat.shape[0] // 2, 2, w)
        out = torch.empty(shape, dtype=a.dtype, device=a.device)
        _block_copy(out.view(-1, w), flat)
    _lib.counted_launch("probe_relayout")
    return out


# --------------------------------------------------------------------------
# 16h: out = T(f32(C3) - reshape(A3) @ B)
# --------------------------------------------------------------------------

def _gemm3d_check(a3, b, c3):
    _lib.check(a3.dim() == 3 and a3.shape[1] == 2 and c3.dim() == 3 and c3.shape[1] == 2
               and b.dim() == 2 and a3.shape[2] == b.shape[0] and c3.shape[0] == a3.shape[0]
               and c3.shape[2] == b.shape[1],
               "gemm3d: A3 (s/2, 2, k), B (k, w), C3 (s/2, 2, w)")
    _lib.check(a3.dtype == b.dtype == c3.dtype and a3.dtype in DTYPES,
               "gemm3d: one dtype, fp32 or bf16")


def gemm3d_plain(a3, b, c3):
    """Plain version of :func:`gemm3d`: an IEEE fp32 product, one rounding."""
    _lib.counted_plain("probe_gemm3d")
    _gemm3d_check(a3, b, c3)
    s, w = 2 * a3.shape[0], b.shape[1]
    with ieee_fp32():
        prod = a3.reshape(s, -1).float() @ b.float()
    return (c3.reshape(s, w).float() - prod).to(c3.dtype).reshape(c3.shape)


def gemm3d(a3, b, c3):
    """A new (s/2, 2, w) tensor ``T(f32(C3) - reshape(A3)(s, k) @ B)`` with
    fp32 sums.  CPU tensors take the plain version; CUDA tensors copy C3
    into the output (``mpf_block_copy``) and run kernel 6 in place on its
    (s, w) view: bf16 operands on the tensor cores with a bf16 store (C
    through shared memory where :func:`trailing_staged` allows), fp32
    operands on FFMA."""
    _gemm3d_check(a3, b, c3)
    if not _lib.on_cuda(a3, b, c3):
        return gemm3d_plain(a3, b, c3)
    a3, b, c3 = a3.contiguous(), b.contiguous(), c3.contiguous()
    s, k, w = 2 * a3.shape[0], b.shape[0], b.shape[1]
    out = torch.empty_like(c3)
    o2 = out.view(s, w)
    _block_copy(o2, c3.view(s, w))
    bf16 = c3.dtype == torch.bfloat16
    # c_mode: bf16 C as kernel 6 takes it, through shared memory (2) where
    # TMA can address it, else in registers (1); fp32 C (0)
    c_mode = (2 if trailing_staged(o2) else 1) if bf16 else 0
    a2, b = _lib.gemm_operand(a3.view(s, k)), _lib.gemm_operand(b)
    _lib.call("mpf_trailing_sub", 0 if bf16 else 2, s, w, k, a2.data_ptr(), a2.stride(0),
              b.data_ptr(), b.stride(0), o2.data_ptr(), c_mode, w)
    _lib.counted_launch("probe_gemm3d")
    return out


def gemm3d_close(got, ref, a3, b, c3):
    """The tolerance of the GEMM legs, the sum order being the kernel's:
    bf16, one bf16 ulp plus ``utils/oracle.sum_slack`` (an IEEE sum against
    a tensor-core sum of the same exact products); fp32, 1e-6 of max |ref|
    (two IEEE fp32 sums in other orders)."""
    s, w = 2 * a3.shape[0], b.shape[1]
    g2, r2 = got.reshape(s, w), ref.reshape(s, w)
    if got.dtype == torch.bfloat16:
        return within_bf16_ulp(g2, r2, sum_slack(c3.reshape(s, w), a3.reshape(s, -1), b)).ok
    return max_abs(g2, r2) <= 1e-6 * float(r2.abs().max())


# --------------------------------------------------------------------------
# the tool's legs
# --------------------------------------------------------------------------

def run(dev, c: int = C, wc: int = WC, s: int = S, k: int = K, wg: int = WG) -> list:
    """The tool's legs on its inputs (``default_rng(0)``)."""
    rng = np.random.default_rng(0)
    res = []
    a2 = torch.from_numpy(rng.standard_normal((2 * c, wc)).astype(np.float32)).to(dev)
    for mode in RELAYOUTS:
        for dt in DTYPES:
            av = a2.to(dt)
            inp = av if mode == "split" else av.view(c, 2, wc)
            out, plain = relayout(inp, mode), relayout_plain(inp, mode)
            ref = av.view(c, 2, wc) if mode == "split" else av.t() if mode == "tchunk" else av
            ok = torch.equal(out, ref) and torch.equal(out, plain)
            ms = time_ms(lambda: relayout(inp, mode), dev, iters=5)
            pms = time_ms(lambda: relayout_plain(inp, mode), dev, iters=1, warmup=0)
            lib = time_ms((lambda: inp.view(-1, wc).t().contiguous()) if mode == "tchunk" else
                             (lambda: torch.empty_like(out).copy_(inp.view(out.shape))), dev)
            res.append(leg("probe_relayout", f"{mode:9s} {str(dt)[6:]}", ok, f"ok={ok}",
                           ms=ms, plain_ms=pms, library=lib,
                           nbytes=2 * av.numel() * av.element_size(), **errors(out, plain)))
    an = torch.from_numpy(rng.standard_normal((s, k)).astype(np.float32)).to(dev)
    bn = torch.from_numpy(rng.standard_normal((k, wg)).astype(np.float32)).to(dev)
    cn = torch.from_numpy(rng.standard_normal((s, wg)).astype(np.float32)).to(dev)
    for form in FORMS:
        for dt in DTYPES:
            a3, b, c3 = an.to(dt).view(s // 2, 2, k), bn.to(dt), cn.to(dt).view(s // 2, 2, wg)
            got, ref = gemm3d(a3, b, c3), gemm3d_plain(a3, b, c3)
            ok = gemm3d_close(got, ref, a3, b, c3)
            err = errors(got, ref)
            ms = time_ms(lambda: gemm3d(a3, b, c3), dev, iters=5)
            pms = time_ms(lambda: gemm3d_plain(a3, b, c3), dev, iters=1, warmup=0)
            a2d, c2d = a3.view(s, k), c3.view(s, wg)
            with ieee_fp32():
                lib = time_ms(lambda: torch.addmm(c2d, a2d, b, alpha=-1), dev)
            flops = 2.0 * s * k * wg
            tf = rate(ms, lambda t: flops / t / 1e12, "TF/s")
            el = a3.element_size()
            res.append(leg("probe_gemm3d", f"gemm3d/{form:7s} {str(dt)[6:]}", ok,
                           tf, ms=ms, plain_ms=pms, library=lib,
                           nbytes=(s * k + k * wg + 2 * s * wg) * el, **err,
                           **({"bf16_ops": flops} if dt == torch.bfloat16
                              else {"fp32_ops": flops})))
    return res


def main(argv=None) -> int:
    args = parser(__doc__).parse_args(argv)
    dev = device(args.device)
    print(f"device={dev}", flush=True)
    return finish(run(dev))


if __name__ == "__main__":
    sys.exit(main())
