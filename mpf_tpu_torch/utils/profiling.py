"""Where one factorization's time goes on the card (torch.profiler).

    python -m mpf_tpu_torch.utils.profiling --n 16384 --corpus hpl_ai \\
        [--trace trace.json]

Runs one warm-up factorization, then one under ``torch.profiler`` with CPU
and CUDA activities, and prints one JSON line: wall time, summed device
time by kernel name, and the device's idle share (1 - busy time / the span
from the first device activity to the last; work on one stream does not
overlap).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import time

import torch


def profile_factorization(n: int, corpus: str = "hpl_ai", r: int = 128,
                          trace: str | None = None) -> dict:
    from mpf_tpu_torch import MPF_BF16, make_mpf
    from mpf_tpu_torch.utils import matgen

    if not torch.cuda.is_available():
        raise RuntimeError("profiling needs a CUDA device")
    gen = {"hpl_ai": matgen.hpl_ai_matrix, "uniform": matgen.random_dense}[corpus]
    a0 = torch.from_numpy(gen(n, seed=0)).cuda()
    fac = make_mpf(n, r=r, policy=MPF_BF16)
    fac(a0.clone())
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
    return {"n": n, "corpus": corpus, "wall_ms": wall * 1e3,
            "device_busy_ms": busy_ms, "device_span_ms": span_ms,
            "idle_share": 1.0 - busy_ms / span_ms if span_ms else None,
            "kernels_ms": {k[:80]: round(v, 3) for k, v in top.items()},
            "device": torch.cuda.get_device_name(0)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=16384)
    ap.add_argument("--corpus", choices=("hpl_ai", "uniform"), default="hpl_ai")
    ap.add_argument("--trace", default=None)
    args = ap.parse_args()
    print(json.dumps(profile_factorization(args.n, args.corpus, trace=args.trace)))


if __name__ == "__main__":
    main()
