"""Timing / throughput helpers (reference: chrono wall-clock around MPF,
`benchmark.cpp:219-222`).

On the card, time is taken with CUDA events around the call: PyTorch
returns before the device finishes, so a host clock without a synchronise
would measure the enqueue.  A timer that finds no CUDA tensor raises; it
never reports a CPU time as a device time.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch


def lu_flops(n: int) -> float:
    """Canonical LU flop count 2n^3/3."""
    return 2.0 * n**3 / 3.0


def tflops(n: int, seconds: float) -> float:
    return lu_flops(n) / seconds / 1e12


def cuda_time(fn: Callable, *args, warmup: int = 1, iters: int = 3,
              setup: Callable | None = None) -> Tuple[float, list, object]:
    """Median seconds of ``fn(*args)`` on the current CUDA device, timed
    with CUDA events (one event pair per run).  ``setup(*args)`` (optional)
    runs before each call outside the timed window and returns the
    arguments to pass — e.g. a fresh copy of a matrix that ``fn`` factors
    in place.  Returns ``(median_s, all_s, last_result)``."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_time needs a CUDA device")
    out = None
    for _ in range(warmup):
        out = fn(*(setup(*args) if setup else args))
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        call_args = setup(*args) if setup else args
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*call_args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
    srt = sorted(times)
    return srt[len(srt) // 2], times, out


def event_ms(fn, reps: int = 5) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` runs back to back,
    between two CUDA events (the host's issue time where that is longer)."""
    if not torch.cuda.is_available():
        raise RuntimeError("event_ms needs a CUDA device")
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


def graph_ms(fn, reps: int = 20) -> float:
    """Device milliseconds of one ``fn()``: ``reps`` calls captured in one
    CUDA graph, the graph replayed 5 times between CUDA events.  For
    launches shorter than the host's time to issue them, where event_ms
    times the host: the replay has no host work between the kernels."""
    if not torch.cuda.is_available():
        raise RuntimeError("graph_ms needs a CUDA device")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        g.replay()
    end.record()
    end.synchronize()
    del g
    return start.elapsed_time(end) / (5 * reps)
