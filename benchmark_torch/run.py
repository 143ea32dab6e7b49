"""Run one benchmark cell and print its result as the last line.

    python3 -m benchmark_torch.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (timed as ``setup_s``): import the program, load its kernel library
(the first run in a checkout builds it into the checkout), make the pool
of matrices on the card from ``--seed``, build the factorizer with
``make_mpf`` as the configuration states, and factor once.  Then the
closed-loop window of :mod:`benchmark_torch.window`.  Once it has closed
and the memory peak is read, the program's state is dropped and the kept
answers are checked against their definition in fp64
(:mod:`benchmark_torch.reference`), each compared number beside its limit
from ``limits/<cell>.json``.

With ``--trace 0`` the result carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics and ``breakdown``; each metric is read
by ``metrics/<name>.py``.  Without a CUDA card, or with fewer than the cell
asks for, the run exits with code 2 and prints no result.  Earlier lines
give the card, its power limit and clocks, the kernel launches and plain
calls per factorization, the block used and the set-up's phases.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from benchmark_torch import spec as spec_mod  # noqa: E402

CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton",
          "CUDA_CACHE_PATH": "cuda"}
SMI_FIELDS = "name,power.limit,clocks.sm,clocks.max.sm,clocks.mem,temperature.gpu,power.draw"


def pin_caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout.
    The program's own kernel library is built into its package directory
    (``mpf_tpu_torch/_build``), which is inside the checkout too."""
    for var, sub in CACHES.items():
        os.environ[var] = str(spec_mod.HERE / "_cache" / sub)


def few_threads() -> None:
    """One host thread for the CPU operator pools: the host's issue time is
    part of what the window measures, and spinning pool workers would take
    cores from the thread that issues the launches."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"


def unset_knobs() -> None:
    """Drop the program's ``MPF_*`` environment knobs: the configuration
    passes every option itself, so the library defaults hold."""
    for key in [k for k in os.environ if k.startswith("MPF_")]:
        del os.environ[key]


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def smi() -> str | None:
    """The card's name, power limit, clocks, temperature and draw."""
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={SMI_FIELDS}",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() or None


def reader(name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = spec_mod.HERE / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(f"benchmark_torch.metrics.{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def read_metrics(metrics: list, record) -> dict:
    """Each metric's reading; one whose reader finds nothing is left out."""
    out = {}
    for m in metrics:
        value = reader(m["name"])(record)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def program_factorizer(config: dict):
    """``make_mpf`` as the configuration calls it."""
    import mpf_tpu_torch

    pol = getattr(mpf_tpu_torch, config["policy"])
    return mpf_tpu_torch.make_mpf(config["n"], policy=pol, donate=True, **config["make_mpf"])


def control_factorizer(config: dict):
    """The configuration's control, put in the program's place: the plain
    reference LU with its values or GEMM operands rounded one precision
    lower."""
    from benchmark_torch.reference import lu_plain

    c = config["control"]
    block = config["make_mpf"]["block"]
    return lambda a: lu_plain(a, block, c["store"], c.get("operands"))


def compare(a, answer, n: int) -> dict:
    """The numbers compared for one answer: nbe and max_err of L U against
    A[perm] in fp64, ``info`` (a nonzero pivot column), and the rows where
    ``perm`` differs from the swaps of ``ipiv`` composed (n + 1 for a swap
    out of range)."""
    from benchmark_torch.reference import perm_from_ipiv, residual

    try:
        composed = perm_from_ipiv(answer.ipiv)
    except ValueError:
        perm_diff = n + 1
    else:
        perm_diff = sum(int(x != y) for x, y in zip(composed, answer.perm.tolist()))
    nbe, max_err = residual(a, answer.lu, answer.perm)
    return {"nbe": nbe, "max_err": max_err, "info": int(answer.info), "perm_diff": perm_diff}


def judge(readings: list, limits: dict) -> tuple:
    """``(correct, failed, worst)``: the answers that break a limit, and
    each compared number's worst reading beside its limit (a NaN reading
    is the worst and breaks its limit)."""
    failed = sum(any(not r[k] <= lim for k, lim in limits.items()) for r in readings)
    worst = {}
    for key, lim in limits.items():
        vals = [r[key] for r in readings]
        worst[key] = {"value": next((v for v in vals if v != v), max(vals)), "limit": lim}
    return bool(readings) and failed == 0, failed, worst


def _finite(x):
    """JSON has no NaN or infinity: such a reading prints as null."""
    return x if not isinstance(x, float) or x - x == 0 else None


def _setup(cell, seed: int, dev, factorizer, warmup: bool, trace: bool, t0: float):
    """Load the program, make the pool and the factorizer, factor once;
    return ``(pool, work, fac, warm, phases)``, the phases' ends in seconds
    since ``t0``."""
    import torch

    import mpf_tpu_torch
    from benchmark_torch import traffic as traffic_mod
    from benchmark_torch.reference import DTYPES
    from mpf_tpu_torch.ops import _lib

    conf, traf = cell.config, cell.traffic
    traffic_mod.check(traf)
    cuda = dev.type == "cuda"
    phases = {}

    def mark(name):
        if cuda:
            torch.cuda.synchronize(dev)
        phases[name] = time.perf_counter() - t0

    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
        _lib.lib()
    mark("load")
    storage = DTYPES[conf["storage"]]
    if getattr(mpf_tpu_torch, conf["policy"]).working != storage:
        raise ValueError(f"policy {conf['policy']} does not store {conf['storage']}")
    pool = [traffic_mod.make_matrix(conf["n"], traf, seed, j, storage, dev)
            for j in range(traf["pool"])]
    work = torch.empty_like(pool[0])
    mark("pool")
    fac = factorizer or program_factorizer(conf)
    mark("make_mpf")
    warm = None
    if warmup:
        work.copy_(pool[0])
        warm = fac(work)
        int(warm.info)
    if trace:
        # the profiler's first start initialises the device tracer: not in the window
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts):
            torch.ones(8, device=dev).sum().item()
    mark("warmup")
    return pool, work, fac, warm, phases


def _spread(values: list) -> list | None:
    """Smallest, median and largest of ``values`` in ms."""
    v = sorted(values)
    return [1e3 * v[0], 1e3 * v[len(v) // 2], 1e3 * v[-1]] if v else None


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             factorizer=None, warmup: bool = True, t0: float | None = None, out=print):
    """Set up, run the window, check the kept answers; return ``(result,
    record)``.  ``factorizer``: a callable put in the program's place (the
    control, or a broken program in the tests); ``warmup=False`` skips the
    warm-up factorization (for a control read outside the benchmark's
    runs).  ``out`` takes the earlier line."""
    import torch

    from benchmark_torch import trace as trace_mod
    from benchmark_torch import window
    from mpf_tpu_torch.ops import _lib

    unset_knobs()
    t0 = time.perf_counter() if t0 is None else t0
    conf = cell.config
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    pool, work, fac, warm, phases = _setup(cell, seed, dev, factorizer, warmup, trace, t0)
    record = window.Record(config=conf, setup_s=phases["warmup"])
    _lib.reset_counts()
    # the set-up's peak; the window's is read less the reservoir's copies
    peak_setup = torch.cuda.max_memory_allocated(dev) if cuda else 0
    sample = conf["check_sample"]
    kept, prof = window.closed_loop(
        fac, pool, work, record, seconds, sample, seed, min_count=sample + 1,
        trace_at=sample, trace_count=conf["trace_factorizations"] if trace else 0,
        like=window.as_answer(warm) if warm is not None else None)
    del warm
    # the peak of the program's load: the pool, the working matrix and the
    # program's workspace; the reservoir's copies serve only the check and
    # are held through the whole window, so they come off the window's peak
    peak = (max(peak_setup, torch.cuda.max_memory_allocated(dev) - record.kept_bytes)
            if cuda else 0)
    per = {k: v / record.count for k, v in _lib.launches.items() if v}
    out(json.dumps({
        "card": smi() if cuda else None, "setup_phases_s": phases,
        "factorizations": record.count, "window_s": record.wall_s,
        "factor_ms_min_median_max": _spread(record.factor_s),
        "issue_ms_min_median_max": _spread(record.issue_s),
        "block": conf["make_mpf"]["block"],
        # kernel 4 runs once a block column
        "block_used": conf["n"] / per["rows_exchange"] if per.get("rows_exchange") else None,
        "launches_per_factorization": per,
        "plain_calls": {k: v for k, v in _lib.plain_calls.items() if v},
        "memory_peak_bytes": peak, "reservoir_bytes": record.kept_bytes,
        "answers_checked": len(kept)}))
    if prof is not None:
        record.trace = trace_mod.from_profiler(prof, conf["trace_factorizations"],
                                               window.RANGES)
        del prof
    # the program's state goes before the fp64 check takes its memory
    del fac, work
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    readings = []
    for k in kept:
        readings.append(compare(pool[k.pool_index], k.answer, conf["n"]))
        k.answer = None
        gc.collect()
    record.nbe_last = readings[-1]["nbe"]
    correct, failed, worst = judge(readings, cell.limits["limits"])
    metrics = read_metrics(cell.per_layer if trace else cell.end_to_end, record)
    result = {"correct": correct, "attempted": record.count, "failed": failed,
              "metrics": {k: dict(m, value=_finite(m["value"])) for k, m in metrics.items()},
              "device": {"platform": "gpu" if cuda else "cpu",
                         "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                         "count": cell.chips, "memory_peak_bytes": peak}}
    if record.trace is not None:
        t = record.trace
        result["device"].update(busy_s=t.busy_s, window_s=t.span_s)
        result["breakdown"] = {"device_ops": t.top(t.kernels), "idle_gaps": t.top(t.gaps)}
    result["checks"] = {k: {"value": _finite(v["value"]), "limit": v["limit"]}
                        for k, v in worst.items()}
    return result, record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    pin_caches()
    few_threads()
    cell = spec_mod.cell(spec_mod.load(), args.workload)
    import torch

    torch.set_num_threads(1)

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"needs {cell.chips} CUDA card(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result, _ = run_cell(cell, args.seed, args.seconds, bool(args.trace), t0=_T0)
    for key, c in result["checks"].items():
        log(f"check {key} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
