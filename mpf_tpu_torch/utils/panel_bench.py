"""The panel kernels alone on the card, at the main paths' shapes; and a
re-runnable bits check.

    python -m mpf_tpu_torch.utils.panel_bench [--reps 5]
    python -m mpf_tpu_torch.utils.panel_bench --hashes

Times ``strip_panel_pivots`` (kernel 1: the first panel, r = 128, of the
HPL-AI slab of n = 16384 rows, bf16 and fp32 panels from the fp32 slab, a
bf16 panel from the bf16 slab; and of a uniform bf16 slab of 65536 rows),
``rowblock_assemble`` (kernel 2: the pivot rows kernel 1 picks on the
uniform slab, r = 128, 1024 columns, fp32 and bf16), ``hgetf2_panel_swaps``
(kernel 7: the first panel of the HPL-AI matrix at n = 16384 saturated to
fp16, as MPF_FP16 gives it; the same fp32 panel cast to bf16 in the
kernel; a uniform fp16 panel of 65536 rows), ``getf2_npv_inv_block`` and
``getf2_npv_block`` (kernels 8 and 8b on the HPL-AI matrix's leading 128 x
128 block, a view of row stride 1024, as the masked path passes it) and,
beside 8b, ``torch.linalg.lu_factor_ex(pivot=False)`` on the same block,
and prints one JSON line: per case the wrapper's time (CUDA events over
``--reps`` calls back to back, the host's launch time where that is
longer) and the device's (``device_ms``: the calls captured in one CUDA
graph and replayed), with the timers of ``utils/timing.py`` that
``chip_smoke.py`` uses; for kernel 1, where the tree counts them, block
0's poll rounds a column (``polls_per_column``).

``--hashes`` prints one JSON line of SHA-256 digests instead: kernel 1's
outputs (piv, pos, glist) on both slabs at m = 16384, fp32 and bf16, quant16
and exact, from the identity positions and from shuffled ones at offset 512,
with an fp32 panel, and on a bf16 slab of 65536 rows; kernel 7's
outputs (piv, perm, composed map, srcs) on both matrices' first panels at
m = 16384 in each panel dtype at the diagonal offsets 0 and 8192, and at
m = 65536; kernel 8's and 8b's (LU, L^-1, U^-1, info) on the pivoted
diagonal blocks of both matrices (r = 128) and at r = 48 and 256; kernel
2's (row block, U^-1, info) on both slabs, fp32 and bf16; and the factors
(lu, ipiv, perm, info) of MPF_FP16, ``pivot=False`` PURE_FP32, MPF_BF16,
ALL_BF16 and MPF_REF at n = 4096 and 16384 on HPL-AI and uniform.  Two
trees compare by their lines.

Both modes call only the package's public wrappers and entry points, so
they measure another tree of the package once that tree has this file and
``utils/timing.py``: ``PYTHONPATH=<tree> python
<tree>/mpf_tpu_torch/utils/panel_bench.py``.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import hashlib
import json

import torch

_N, _R, _BC, _BIG = 16384, 128, 1024, 65536


def _slabs(dev):
    from mpf_tpu_torch.utils import matgen
    hpl = torch.from_numpy(matgen.hpl_ai_matrix(_N, seed=1)[:, :_BC].copy()).to(dev)
    uni = torch.from_numpy(matgen.random_dense(_N, seed=2)[:, :_BC].copy()).to(dev)
    return hpl, uni


def panel_times(reps: int = 5) -> dict:
    """{case: {"ms", "device_ms"}} for kernels 1, 2, 7, 8 and 8b (see the
    module docstring), with the device's name."""
    import mpf_tpu_torch as T
    from mpf_tpu_torch.ops.panel_fused import rowblock_assemble
    from mpf_tpu_torch.ops.panel_pallas import (
        getf2_npv_block, getf2_npv_inv_block, hgetf2_panel_swaps)
    from mpf_tpu_torch.ops.panel_strip import strip_panel_pivots
    from mpf_tpu_torch.precision import cast_to_panel
    from mpf_tpu_torch.utils.timing import event_ms, graph_ms

    if not torch.cuda.is_available():
        raise RuntimeError("panel_bench needs a CUDA device")
    dev = torch.device("cuda", 0)
    bf, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    hpl, uni = _slabs(dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    big = (torch.rand((_BIG, _BC), generator=gen, device=dev) * 2 - 1).to(bf)
    big16 = (torch.rand((_BIG, _R), generator=gen, device=dev) * 2 - 1).to(f16)
    pos = torch.arange(_N, dtype=torch.int32, device=dev)
    pos_big = torch.arange(_BIG, dtype=torch.int32, device=dev)
    hpl_b, uni_b = hpl.to(bf), uni.to(bf)
    glist = strip_panel_pivots(uni, 0, pos, bf, 0, _R)[2]
    glist_b = strip_panel_pivots(uni_b, 0, pos, bf, 0, _R)[2]
    p16 = cast_to_panel(hpl[:, :_R], T.MPF_FP16).contiguous()
    blk = hpl[:_R, :_R]
    cases = {
        "k1_m16384_fp32slab_bf16panel": lambda: strip_panel_pivots(hpl, 0, pos, bf, 0, _R),
        "k1_m16384_fp32panel": lambda: strip_panel_pivots(hpl, 0, pos, f32, 0, _R),
        "k1_m16384_bf16slab": lambda: strip_panel_pivots(hpl_b, 0, pos, bf, 0, _R),
        "k1_m65536_bf16slab": lambda: strip_panel_pivots(big, 0, pos_big, bf, 0, _R),
        "k2_fp32": lambda: rowblock_assemble(uni, glist, 0),
        "k2_bf16": lambda: rowblock_assemble(uni_b, glist_b, 0),
        "k7_m16384_fp16": lambda: hgetf2_panel_swaps(p16, 0, None, panel_dtype=f16),
        "k7_m16384_bf16_from_fp32": lambda: hgetf2_panel_swaps(hpl[:, :_R], 0, None,
                                                               panel_dtype=bf),
        "k7_m65536_fp16": lambda: hgetf2_panel_swaps(big16, 0, None, panel_dtype=f16),
        "k8_r128": lambda: getf2_npv_inv_block(blk),
        "k8b_r128": lambda: getf2_npv_block(blk),
        "k8b_library_lu_factor_ex": lambda: torch.linalg.lu_factor_ex(blk, pivot=False),
    }
    out = {name: {"ms": event_ms(fn, reps), "device_ms": graph_ms(fn)}
           for name, fn in cases.items()}
    try:  # a tree whose kernel 1 counts its exchange's poll rounds
        from mpf_tpu_torch.ops.panel_strip import exchange_polls
    except ImportError:
        exchange_polls = None
    if exchange_polls is not None:
        for name, fn in cases.items():
            if name.startswith("k1_"):
                exchange_polls()
                for _ in range(reps):
                    fn()
                out[name]["polls_per_column"] = exchange_polls() / (reps * _R)
    out["device"] = torch.cuda.get_device_name(0)
    return out


def _digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        t = t.detach().reshape(-1).contiguous().cpu()
        if t.dtype in (torch.bfloat16, torch.float16):
            t = t.view(torch.int16)
        h.update(str(t.dtype).encode())
        h.update(t.numpy().tobytes())
    return h.hexdigest()


def hashes() -> dict:
    """{name: SHA-256} of the kernels' outputs and the factorizations listed
    in the module docstring, with the device's name."""
    import mpf_tpu_torch as T
    from mpf_tpu_torch.ops.panel_fused import rowblock_assemble
    from mpf_tpu_torch.ops.panel_pallas import (
        getf2_npv_block, getf2_npv_inv_block, hgetf2_panel_swaps)
    from mpf_tpu_torch.ops.panel_strip import strip_panel_pivots
    from mpf_tpu_torch.precision import cast_to_panel
    from mpf_tpu_torch.utils import matgen

    if not torch.cuda.is_available():
        raise RuntimeError("panel_bench needs a CUDA device")
    dev = torch.device("cuda", 0)
    bf, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    hpl, uni = _slabs(dev)
    pos = torch.arange(_N, dtype=torch.int32, device=dev)
    prev = torch.randperm(_N, generator=torch.Generator().manual_seed(3)).to(torch.int32).to(dev)
    out = {}
    for corpus, slab in (("hpl", hpl), ("uniform", uni)):
        pan = slab[:, :_R]
        for pdt in (f16, bf, f32):
            inp = cast_to_panel(pan, T.MPF_FP16).contiguous() if pdt == f16 else pan
            for off in (0, 8192):
                got = hgetf2_panel_swaps(inp, off, prev, panel_dtype=pdt)
                out[f"k7_{corpus}_{str(pdt)[6:]}_off{off}"] = _digest(*got)
        srcs = hgetf2_panel_swaps(pan, 0, None, panel_dtype=bf)[3]
        diag = slab[srcs[:_R].long(), :_R].contiguous()
        out[f"k8_{corpus}_r128"] = _digest(*getf2_npv_inv_block(diag))
        out[f"k8b_{corpus}_r128"] = _digest(*getf2_npv_block(diag))
        for sdt in (f32, bf):
            s = slab.to(sdt)
            glist = strip_panel_pivots(s, 0, pos, bf, 0, _R)[2]
            out[f"k2_{corpus}_{str(sdt)[6:]}"] = _digest(*rowblock_assemble(s, glist, 0))
            for q16 in (True, False):
                for p, off in ((pos, 0), (prev, 512)):
                    tag = f"k1_{corpus}_{str(sdt)[6:]}slab_{'quant16' if q16 else 'exact'}_off{off}"
                    out[tag] = _digest(*strip_panel_pivots(s, off, p, bf, off, _R, quant16=q16))
        out[f"k1_{corpus}_fp32panel"] = _digest(*strip_panel_pivots(slab, 0, pos, f32, 0, _R))
    gen = torch.Generator(device=dev).manual_seed(7)
    big = (torch.rand((_BIG, 2 * _R), generator=gen, device=dev) * 2 - 1).to(bf)
    pos_big = torch.arange(_BIG, dtype=torch.int32, device=dev)
    for q16 in (True, False):
        got = strip_panel_pivots(big, 0, pos_big, bf, 0, _R, quant16=q16)
        out[f"k1_m65536_bf16slab_{'quant16' if q16 else 'exact'}"] = _digest(*got)
    del big
    gen = torch.Generator(device=dev).manual_seed(7)
    big16 = (torch.rand((_BIG, _R), generator=gen, device=dev) * 2 - 1).to(f16)
    out["k7_m65536_fp16"] = _digest(*hgetf2_panel_swaps(big16, 0, None, panel_dtype=f16))
    for r in (48, 256):
        w = torch.from_numpy(matgen.hpl_ai_matrix(r, seed=5)).to(dev)
        out[f"k8_hpl_r{r}"] = _digest(*getf2_npv_inv_block(w))
        out[f"k8b_hpl_r{r}"] = _digest(*getf2_npv_block(w))
    runs = (("mpf_fp16", T.MPF_FP16, True), ("pivot_false", T.PURE_FP32, False),
            ("mpf_bf16", T.MPF_BF16, True), ("all_bf16", T.ALL_BF16, True),
            ("mpf_ref", T.MPF_REF, True))
    for n in (4096, _N):
        for corpus in ("hpl", "uniform"):
            a = (matgen.hpl_ai_matrix(n, seed=1) if corpus == "hpl"
                 else matgen.random_dense(n, seed=2))
            a = torch.from_numpy(a).to(dev)
            for name, policy, pivot in runs:
                res = T.mpf_factorize(a, r=_R, policy=policy, pivot=pivot)
                out[f"{name}_n{n}_{corpus}"] = _digest(res.lu, res.ipiv, res.perm, res.info)
                del res
            del a
            torch.cuda.empty_cache()
    out["device"] = torch.cuda.get_device_name(0)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--hashes", action="store_true",
                    help="print SHA-256 digests of the outputs instead of times")
    args = ap.parse_args()
    print(json.dumps(hashes() if args.hashes else panel_times(args.reps)))


if __name__ == "__main__":
    main()
