"""Charge a ``torch.profiler`` trace of a few factorizations to the
program's stage spans, and measure one cell's spans on the card.

The program names the stages of its block-column loop with
``record_function`` ranges while a profiler records (``mpf.panel``, with
``mpf.update`` inside it, ``mpf.exchange``, ``mpf.u12``, ``mpf.trailing``;
`mpf_tpu_torch/ops/_lib.py:span`).  Three tables come from one trace:

* device seconds by the innermost span around the host operation that
  launched each device operation (the operation's ``linked_correlation_id``
  names that host operation; the program issues from one thread, on which
  ranges nest, so the innermost span holding the operation's start is the
  first span up its ``cpu_parent`` chain).  A kernel launched through the
  program's C interface with no operator open is linked to none: the CUDA
  runtime call that launched it, which shares its correlation id, stands
  in;
* host seconds inside each span, children included;
* idle seconds by the innermost span open at each gap's middle.

Work outside every span is charged to the harness's range around it
(``refill``, ``factorization``, ``info_read``), or to
:data:`OUTSIDE`.  The reduction is a pure function of event tuples, as
:func:`benchmark_torch.trace.summarize` is; the device list leaves out
every range's shadow on the device timeline, as
:func:`benchmark_torch.trace.from_profiler` does.

    python3 -m benchmark_torch.spans --workload <cell> --seed <n> [--seconds 10]

runs the cell's set-up and a window as :mod:`benchmark_torch.run` does,
with its traced factorizations, and prints one JSON line: the block-column
counters per factorization, the traced factorizations' host issue time
beside the untraced ones', the benchmark's trace readings, the span tables
and what each metric below reads.  The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

from benchmark_torch.yardstick import merged

#: the program's span names begin so
PREFIX = "mpf."
#: the label of work outside every span and every harness range
OUTSIDE = "(harness, between factorizations)"
#: a device operation whose launching host operation is not in the trace
UNLINKED = "(unlinked)"


@dataclasses.dataclass
class SpanSummary:
    """What ``count`` traced factorizations spent in each span, in seconds;
    each table is keyed by span name, or by the harness range (or
    :data:`OUTSIDE`, :data:`UNLINKED`) where no span was open."""

    count: int
    device: dict
    host: dict
    idle: dict
    kernels: dict
    busy_s: float

    def ms(self, table: dict, *names) -> float | None:
        """ms per factorization of ``names`` in ``table``; None when the
        trace has no device activity or none of them is there."""
        if self.busy_s <= 0 or not any(n in table for n in names):
            return None
        return sum(table.get(n, 0.0) for n in names) / self.count * 1e3

    def coverage(self) -> float | None:
        """The share of the device time launched inside the harness's
        ``factorization`` range that is charged to a span."""
        spans = sum(s for k, s in self.device.items() if k.startswith(PREFIX))
        whole = spans + self.device.get("factorization", 0.0)
        return spans / whole if whole > 0 else None


def _label(points: list, ranges: list) -> list:
    """The name of the innermost of the nested ``(start, end, name)``
    ``ranges`` that holds each time of ``points``, or None."""
    ranges = sorted(ranges, key=lambda x: (x[0], -x[1]))
    order = sorted(range(len(points)), key=lambda i: points[i])
    out = [None] * len(points)
    stack, j = [], 0
    for i in order:
        t = points[i]
        while j < len(ranges) and ranges[j][0] <= t:
            stack.append(ranges[j])
            j += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[i] = stack[-1][2] if stack else None
    return out


def split(events: list, outer_names=()) -> tuple:
    """``(device, host)`` from ``(start_s, end_s, name, kind, id, linked)``
    tuples, ``kind`` one of ``"device"``, ``"shadow"`` (a host range's
    image on the device timeline), ``"op"`` (an operator or a range),
    ``"runtime"`` (a CUDA runtime call, whose id is the correlation id of
    the device operations it launched) and ``"other"`` (the profiler's
    own).  ``device``: ``(start, end, name, launch_s)``, ``launch_s`` the
    start of the host operation whose id is the device operation's
    ``linked``, else of the runtime call with the device operation's id
    (None when neither is in the trace); ``host``: ``(start, end, name)``
    of every host event."""
    ops = {i: s for s, _, _, kind, i, _ in events if kind == "op"}
    calls = {i: s for s, _, _, kind, i, _ in events if kind == "runtime"}
    device, host = [], []
    for s, e, name, kind, i, linked in events:
        if kind == "device":
            if name not in outer_names:
                device.append((s, e, name, ops.get(linked, calls.get(i))))
        elif kind != "shadow":
            host.append((s, e, name))
    return device, host


def reduce(device: list, host: list, count: int, outer_names=()) -> SpanSummary:
    """The span tables of ``count`` factorizations from :func:`split`'s
    lists."""
    ranges = [h for h in host if h[2].startswith(PREFIX) or h[2] in outer_names]
    hosted = {}
    for s, e, name in ranges:
        hosted[name] = hosted.get(name, 0.0) + (e - s)
    labels = iter(_label([d[3] for d in device if d[3] is not None], ranges))
    kernels = {}
    for s, e, name, launch in device:
        lab = UNLINKED if launch is None else next(labels) or OUTSIDE
        k = kernels.setdefault(lab, {})
        k[name] = k.get(name, 0.0) + (e - s)
    busy = merged((s, e) for s, e, _, _ in device)
    gaps = [(e0, s1) for (_, e0), (s1, _) in zip(busy, busy[1:])]
    idle = {}
    for (e0, s1), lab in zip(gaps, _label([(e0 + s1) / 2 for e0, s1 in gaps], ranges)):
        lab = lab or OUTSIDE
        idle[lab] = idle.get(lab, 0.0) + (s1 - e0)
    return SpanSummary(count=count, device={lab: sum(k.values()) for lab, k in kernels.items()},
                       host=hosted, idle=idle, kernels=kernels,
                       busy_s=sum(e - s for s, e in busy))


def events_of(prof) -> list:
    """The event tuples of :func:`split` from a finished
    ``torch.profiler.profile``.  A host event is an operation when it is
    an ``aten::`` operator or a ``record_function`` range (the program's
    spans, the harness's ranges); a CUDA runtime call (``cuda*``, ``cu*``)
    carries the correlation id of what it launched; the rest are the
    profiler's own.  Where the
    profiler's events do not carry ``linked_correlation_id``, it is read
    from the profiler's raw events, keyed by the device operation's id."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    events = list(prof.events())
    linked = {}
    if events and not hasattr(events[0], "linked_correlation_id"):
        linked = {k.correlation_id(): k.linked_correlation_id()
                  for k in prof.profiler.kineto_results.events() if k.device_type() == cuda}
    out = []
    for ev in events:
        annotation = getattr(ev, "is_user_annotation", False)
        if ev.device_type == cuda:
            kind = "shadow" if annotation else "device"
        else:
            kind = ("op" if annotation or ev.name.startswith("aten::")
                    else "runtime" if ev.name.startswith("cu") else "other")
        link = getattr(ev, "linked_correlation_id", None)
        out.append((ev.time_range.start / 1e6, ev.time_range.end / 1e6, ev.name, kind,
                    ev.id, linked.get(ev.id, 0) if link is None else link))
    return out


def from_profiler(prof, count: int, outer_names=()) -> SpanSummary:
    """:func:`reduce` of a finished ``torch.profiler.profile``."""
    device, host = split(events_of(prof), outer_names)
    return reduce(device, host, count, outer_names)


# What each per-layer metric of the spans reads, in ms per factorization
# (None with no device activity: on the CPU a span's host time measures
# the plain versions' arithmetic, not issue).

def update_ms(s: SpanSummary):
    """Device time of the B update (kernel 3, or kernel 12's two passes;
    on the masked path L21, the in-block U12 and their update)."""
    return s.ms(s.device, "mpf.update")


def u12_ms(s: SpanSummary):
    """Device time of U12 := L11^-1 A12 (kernel 5, the U12 products and
    their casts)."""
    return s.ms(s.device, "mpf.u12")


def panel_issue_ms(s: SpanSummary):
    """Host time inside the ``mpf.panel`` spans of a traced factorization
    (profiler's own cost per operation included)."""
    return s.ms(s.host, "mpf.panel")


def panel_idle_ms(s: SpanSummary):
    """Device idle time whose gap's middle lies inside an ``mpf.panel``
    span (``mpf.update`` nests in it)."""
    return s.ms(s.idle, "mpf.panel", "mpf.update")


METRICS = {"update_ms": update_ms, "u12_ms": u12_ms, "panel_issue_ms": panel_issue_ms,
           "panel_idle_ms": panel_idle_ms}


def _per(table: dict, count: int) -> dict:
    return {k: v / count * 1e3 for k, v in sorted(table.items(), key=lambda kv: -kv[1])}


def measure(cell, seed: int, seconds: float, device: str = "cuda") -> dict:
    """One window of ``cell`` with its traced factorizations; the JSON
    line's fields."""
    import statistics

    import torch

    from benchmark_torch import readers, run, trace, window
    from mpf_tpu_torch.ops import _lib

    run.unset_knobs()
    t0 = time.perf_counter()
    conf = cell.config
    dev = torch.device(device)
    pool, work, fac, _, _ = run._setup(cell, seed, dev, None, True, True, t0)
    record = window.Record(config=conf)
    _lib.reset_counts()
    count = conf["trace_factorizations"]
    _, prof = window.closed_loop(fac, pool, work, record, seconds, 0, seed,
                                 trace_at=conf["check_sample"], trace_count=count)
    # a program without the block-column counters reports none
    counters = {"block_columns": getattr(_lib, "block_columns", {}),
                "panels": getattr(_lib, "panels", {}), "copies": _lib.copies,
                "launches": {k: v for k, v in _lib.launches.items() if v}}
    record.trace = trace.from_profiler(prof, count, window.RANGES)
    s = from_profiler(prof, count, window.RANGES)
    del prof
    t = record.trace
    return {
        "cell": cell.name, "seed": seed, "card": run.smi() if dev.type == "cuda" else None,
        "factorizations": record.count,
        "per_factorization": {k: {n: v / record.count for n, v in d.items()}
                              for k, d in counters.items()},
        "issue_ms_untraced": {"mean": readers.host_issue_ms(record),
                              "median": 1e3 * statistics.median(record.issue_s)},
        "issue_ms_traced": s.host.get("factorization", 0.0) / count * 1e3,
        "readings": {k: getattr(readers, k)(record) for k in
                     ("idle_pct", "device_ms", "panel_ms", "exchange_ms", "trailing_roofline")},
        "metrics": {k: f(s) for k, f in METRICS.items()},
        "coverage": s.coverage(),
        "span_device_ms": _per(s.device, count), "span_host_ms": _per(s.host, count),
        "span_idle_ms": _per(s.idle, count),
        "span_kernels_ms": {lab: {n[:64]: v for n, v in list(_per(k, count).items())[:8]}
                            for lab, k in s.kernels.items()},
        "device_ops": t.top(t.kernels, 14), "idle_gaps": t.top(t.gaps, 10)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    from benchmark_torch import run, spec

    run.pin_caches()
    run.few_threads()
    cell = spec.cell(spec.load(), args.workload)
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    print(json.dumps(measure(cell, args.seed, args.seconds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
