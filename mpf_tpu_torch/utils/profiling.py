"""Where one factorization's time goes on the card (torch.profiler).

    python -m mpf_tpu_torch.utils.profiling --n 16384 --corpus hpl_ai \\
        [--policy mpf_bf16] [--no-pivot] [--lookahead] [--super S] \\
        [--defer S] [--xchg split] [--pairs] [--runs 5] [--trace trace.json]

Runs one warm-up factorization, then, with ``--runs N``, N more timed with
CUDA events on fresh copies (their median, each run, each run's host issue
time and the caching allocator's device allocations), then one under
``torch.profiler`` with CPU and CUDA activities, and prints one JSON line:
wall time, summed device time by kernel name, and the device's idle share
(1 - busy time / the span from the first device activity to the last;
work on one stream does not overlap).  ``--lookahead`` runs the one-deep
lookahead driver, ``--super S`` superblocks of width S, ``--defer S`` the
deferred-overflow exchange in groups of S block columns, ``--xchg split``
the split row exchange (kernel 11; the CLI sets ``MPF_XCHG``, which
``make_mpf`` reads when it builds), ``--pairs`` the pair-layout driver on
the same matrix as an (n/2, 2, n) tensor.  The matrix (seed 0) is made on
the host (``matgen.hpl_ai_matrix`` / ``random_dense``) below n = 32768 and
on the card above (``matgen.*_device``, as ``chip_smoke.py`` makes its n =
65536 matrices: an fp64 host matrix of that size is 34 GB).  Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

#: from this n the matrix is made on the card
_DEVICE_GEN_N = 32768


def profile_factorization(n: int, corpus: str = "hpl_ai", r: int = 128,
                          trace: str | None = None, policy: str = "mpf_bf16",
                          pivot: bool = True, runs: int = 0, lookahead: bool = False,
                          super_block="auto", defer=None, pairs: bool = False) -> dict:
    """Profile one factorization; the exchange mode is the caller's
    ``MPF_XCHG`` (:func:`mpf_tpu_torch.config.combined_exchange`)."""
    from mpf_tpu_torch import config, make_mpf
    from mpf_tpu_torch.precision import POLICIES
    from mpf_tpu_torch.utils import matgen
    from mpf_tpu_torch.utils.timing import cuda_time

    if not torch.cuda.is_available():
        raise RuntimeError("profiling needs a CUDA device")
    pol = POLICIES[policy]
    if n >= _DEVICE_GEN_N:
        gen = {"hpl_ai": matgen.hpl_ai_matrix_device, "uniform": matgen.random_dense_device}
        a0 = gen[corpus](n, seed=0, dtype=pol.working)
    else:
        gen = {"hpl_ai": matgen.hpl_ai_matrix, "uniform": matgen.random_dense}[corpus]
        a0 = torch.from_numpy(gen(n, seed=0)).cuda().to(pol.working)  # factored in place
    if pairs:
        a0 = a0.view(n // 2, 2, n)
    fac = make_mpf(n, r=r, policy=pol, pivot=pivot, lookahead=lookahead,
                   super_block=super_block, defer=defer)
    xchg = "combined" if config.combined_exchange() else "split"
    fac(a0.clone())
    timed = {}
    if runs:
        # per run: the host's time to issue the factorization (a host stall
        # shows here, a device one only in runs_ms) and the caching
        # allocator's cudaMalloc calls and retries over the timed runs
        host_ms = []

        def issue(x):
            t = time.perf_counter()
            out = fac(x)
            host_ms.append((time.perf_counter() - t) * 1e3)
            return out
        keys = ("num_device_alloc", "num_device_free", "num_alloc_retries")
        before = torch.cuda.memory_stats()
        med, all_s = cuda_time(issue, a0, warmup=0, iters=runs, setup=lambda x: (x.clone(),))[:2]
        after = torch.cuda.memory_stats()
        timed = {"median_ms": med * 1e3, "runs_ms": [t * 1e3 for t in all_s],
                 "host_issue_ms": host_ms,
                 "allocator": {k: after.get(k, 0) - before.get(k, 0) for k in keys}}
    work = a0.clone()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fac(work)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if trace:
        prof.export_chrome_trace(trace)
    # device activity only (kernels, memcpys, memsets); CPU ops are skipped
    # because some report their children's device time as their own
    by_kernel = {}
    first, last = None, None
    for ev in prof.events():
        if getattr(ev, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        t0_us, t1_us = ev.time_range.start, ev.time_range.end
        by_kernel[ev.name] = by_kernel.get(ev.name, 0.0) + (t1_us - t0_us) / 1e3
        first = t0_us if first is None else min(first, t0_us)
        last = t1_us if last is None else max(last, t1_us)
    busy_ms = sum(by_kernel.values())
    span_ms = (last - first) / 1e3 if by_kernel else 0.0
    top = dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:15])
    return {"n": n, "corpus": corpus, "policy": policy, "r": r, "pivot": pivot,
            "lookahead": lookahead, "super_block": super_block, "defer": defer,
            "xchg": xchg, "pairs": pairs, "device_gen": n >= _DEVICE_GEN_N, **timed,
            "wall_ms": wall * 1e3,
            "device_busy_ms": busy_ms, "device_span_ms": span_ms,
            "idle_share": 1.0 - busy_ms / span_ms if span_ms else None,
            "kernels_ms": {k[:80]: round(v, 3) for k, v in top.items()},
            "device": torch.cuda.get_device_name(0)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=16384)
    ap.add_argument("--corpus", choices=("hpl_ai", "uniform"), default="hpl_ai")
    ap.add_argument("--policy", default="mpf_bf16",
                    choices=("mpf_bf16", "mpf_ref", "pure_fp32", "mpf_fp16", "all_bf16"))
    ap.add_argument("--no-pivot", action="store_true")
    ap.add_argument("--lookahead", action="store_true")
    ap.add_argument("--super", type=int, default=None, dest="super_block")
    ap.add_argument("--defer", type=int, default=None)
    ap.add_argument("--xchg", choices=("combined", "split"), default="combined")
    ap.add_argument("--pairs", action="store_true")
    ap.add_argument("--runs", type=int, default=0)
    ap.add_argument("--trace", default=None)
    args = ap.parse_args()
    os.environ["MPF_XCHG"] = args.xchg
    print(json.dumps(profile_factorization(args.n, args.corpus, trace=args.trace,
                                           policy=args.policy, pivot=not args.no_pivot,
                                           runs=args.runs, lookahead=args.lookahead,
                                           super_block=args.super_block or "auto",
                                           defer=args.defer, pairs=args.pairs)))


if __name__ == "__main__":
    main()
