"""Reduce a ``torch.profiler`` trace of a few factorizations to what the
per-layer metrics read.

Device time is taken from the device's own activity (kernels, copies,
fills): by name, summed, and as the union of the intervals, so that work
on two streams that overlaps counts once (the arithmetic of
`mpf_tpu_torch/utils/profiling.py`, with the union in place of the sum).
Each idle gap between device activity is named by the innermost host
range open at its middle: an operator of the program, or one of the
harness's own ranges (``refill``, ``factorization``, ``info_read``).
"""

from __future__ import annotations

import bisect
import dataclasses
import re

from benchmark_torch.yardstick import merged

#: how far back from a gap's middle to look for the host range around it
_SCAN = 400


@dataclasses.dataclass
class TraceSummary:
    """Device activity of ``count`` traced factorizations, in seconds."""

    count: int
    kernels: dict
    busy_s: float
    span_s: float
    gaps: dict

    def seconds(self, patterns) -> float | None:
        """Device seconds of the operations whose name matches one of the
        regular expressions ``patterns``; None when none ran."""
        rx = [re.compile(p) for p in patterns]
        hits = [s for name, s in self.kernels.items() if any(r.search(name) for r in rx)]
        return sum(hits) if hits else None

    def top(self, table: dict, k: int = 10) -> list:
        """The ``k`` largest entries of ``table`` per factorization."""
        rows = sorted(table.items(), key=lambda kv: -kv[1])[:k]
        return [[name, s / self.count] for name, s in rows]


def _innermost(t: float, starts: list, host: list, outer: list) -> str:
    """The name of the innermost host range that holds time ``t``."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - _SCAN), -1):
        s, e, name = host[j]
        if e >= t:
            return name
    for s, e, name in outer:
        if s <= t <= e:
            return name
    return "(harness, between factorizations)"


def summarize(device: list, host: list, count: int, outer_names=()) -> TraceSummary:
    """``device`` and ``host``: ``(start_s, end_s, name)`` of the device's
    activity and of the host's ranges over ``count`` factorizations."""
    kernels = {}
    for s, e, name in device:
        kernels[name] = kernels.get(name, 0.0) + (e - s)
    busy = merged((s, e) for s, e, _ in device)
    if not busy:
        return TraceSummary(count, kernels, 0.0, 0.0, {})
    host = sorted(host)
    starts = [h[0] for h in host]
    outer = [h for h in host if h[2] in outer_names]
    gaps = {}
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        name = _innermost((e0 + s1) / 2, starts, host, outer)
        gaps[name] = gaps.get(name, 0.0) + (s1 - e0)
    return TraceSummary(count=count, kernels=kernels,
                        busy_s=sum(e - s for s, e in busy),
                        span_s=busy[-1][1] - busy[0][0], gaps=gaps)


def from_profiler(prof, count: int, outer_names=()) -> TraceSummary:
    """:func:`summarize` of a finished ``torch.profiler.profile``."""
    import torch

    device, host = [], []
    cuda = torch.autograd.DeviceType.CUDA
    for ev in prof.events():
        span = (ev.time_range.start / 1e6, ev.time_range.end / 1e6, ev.name)
        if ev.device_type != cuda:
            host.append(span)
        elif not (getattr(ev, "is_user_annotation", False) or ev.name in outer_names):
            # a host range's shadow on the device timeline is no device work
            device.append(span)
    return summarize(device, host, count, outer_names)
