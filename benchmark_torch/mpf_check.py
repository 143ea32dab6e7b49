"""Hold the program to the plain MPF reference on a cell's own matrices.

    python3 -m benchmark_torch.mpf_check --workload <cell> --seeds 11,12 [--device cuda]

For each seed, matrix 0 of the cell's pool (the matrix a run of that seed
factors first) is factored by the program, as the cell's configuration
builds it, and by :func:`benchmark_torch.reference_mpf.mpf_plain` with the
configuration's panel search and GEMM operands; both answers are held to
``L U = A[perm]`` in fp64 (:func:`benchmark_torch.reference.residual`).
One JSON line a seed: both nbe and their ratio, both ``info``, the first
index at which ``ipiv`` differs (None where it never does), with the count
of differing entries, and whether the reference's pivot search
(:func:`benchmark_torch.reference_mpf.prepivot`), run on the program's own
cast panel where the pivots first part, gives the program's pivots there
(the program factored again, its kernel 7 call watched).  The benchmark's
own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

from benchmark_torch import run, spec


def check(cell, seed: int, device: str = "cuda") -> dict:
    """The comparison of one seed's matrix."""
    import torch

    from benchmark_torch import reference, traffic
    from benchmark_torch.reference import DTYPES
    from benchmark_torch.reference_mpf import mpf_plain

    conf = cell.config
    n, mk = conf["n"], conf["make_mpf"]
    a = traffic.make_matrix(n, cell.traffic, seed, 0, DTYPES[conf["storage"]], device)
    fac = run.program_factorizer(conf)
    t0 = time.perf_counter()
    prog = fac(a.clone())
    prog_info = int(prog.info)
    t_prog = time.perf_counter() - t0
    prog_ipiv = prog.ipiv.clone()
    nbe_prog, max_prog = reference.residual(a, prog.lu, prog.perm)
    del prog, fac
    gc.collect()
    t0 = time.perf_counter()
    ref = mpf_plain(a, mk["r"], mk["block"], panel=conf["panel_search"],
                    saturate=conf["saturate_panel"], gemm_in=conf["gemm_operands"])
    ref_info = int(ref.info)
    t_ref = time.perf_counter() - t0
    nbe_ref, max_ref = reference.residual(a, ref.lu, ref.perm)
    diff = (prog_ipiv != ref.ipiv).nonzero()
    first = int(diff[0]) if len(diff) else None
    del ref
    gc.collect()
    agrees = None if first is None else _search_agrees(conf, a, prog_ipiv, first)
    return {"seed": seed, "n": n, "nbe_program": nbe_prog, "nbe_reference": nbe_ref,
            "nbe_ratio": nbe_prog / nbe_ref, "max_err_program": max_prog,
            "max_err_reference": max_ref, "info_program": prog_info, "info_reference": ref_info,
            "ipiv_first_divergence": first, "ipiv_differing": len(diff),
            "search_agrees_at_divergence": agrees, "program_s": t_prog, "reference_s": t_ref}


def _search_agrees(conf: dict, a, ipiv, first: int) -> bool:
    """Whether the reference's search on the program's cast panel that
    holds pivot ``first`` gives the program's pivots of that panel."""
    import mpf_tpu_torch.models.mpf as loop

    from benchmark_torch.reference import DTYPES
    from benchmark_torch.reference_mpf import prepivot

    r = conf["make_mpf"]["r"]
    j0 = first - first % r
    seen = {}
    orig = loop.hgetf2_panel_swaps

    def watch(panel, row_offset, prev_perm, panel_dtype=None):
        if row_offset == j0:
            seen["panel"] = panel[j0:].clone()
        return orig(panel, row_offset, prev_perm, panel_dtype=panel_dtype)

    loop.hgetf2_panel_swaps = watch
    try:
        again = run.program_factorizer(conf)(a.clone())
        same = bool((again.ipiv == ipiv).all())
    finally:
        loop.hgetf2_panel_swaps = orig
    piv = prepivot(seen["panel"].float(), DTYPES[conf["panel_search"]], conf["saturate_panel"])
    return same and [j0 + p + 1 for p in piv] == ipiv[j0:j0 + r].tolist()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated whole numbers")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run.pin_caches()
    run.unset_knobs()
    cell = spec.cell(spec.load(), args.workload)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    for seed in [int(s) for s in args.seeds.split(",")]:
        print(json.dumps(check(cell, seed, args.device)), flush=True)
        gc.collect()
    return 0


if __name__ == "__main__":
    sys.exit(main())
