"""The measured window: one caller factoring matrices back to back.

Each factorization refills the working matrix from the next matrix of the
pool, calls the factorizer in place, and reads ``info`` on the host (a
LAPACK ``getrf`` caller waits for it).  Its time runs from the refill to
the end of the factorizer's last device operation, between two CUDA
events (a host clock is off by about half a millisecond, too much for one
factorization); the host's issue time, from the call to its return, is
taken on the host clock.  The window ends at the first completion past
``seconds``, once at least ``min_count`` factorizations have completed.

A seeded reservoir keeps copies of ``sample`` answers drawn evenly from
the window's untraced factorizations but the last; with the last answer
they are what the comparison checks once the window has closed.  Their
buffers are made before the window and held through it;
``Record.kept_bytes`` gives their size, so that the memory peak can leave
them out.  With ``trace`` the factorizations ``trace_at .. trace_at +
trace_count - 1`` run under ``torch.profiler`` (CPU and, on a card, CUDA
activity).
"""

from __future__ import annotations

import contextlib
import dataclasses
import random
import time

import torch

from benchmark_torch.reference import Answer
from benchmark_torch.yardstick import lu_flops

#: the harness's own host ranges, which name the idle gaps they hold
RANGES = ("refill", "factorization", "info_read")


@dataclasses.dataclass
class Record:
    """What the window measured; the metric readers read it."""

    config: dict
    count: int = 0
    wall_s: float = 0.0
    factor_s: list = dataclasses.field(default_factory=list)
    issue_s: list = dataclasses.field(default_factory=list)
    setup_s: float = 0.0
    nbe_last: float | None = None
    kept_bytes: int = 0
    trace: object = None

    @property
    def flops(self) -> float:
        """Operations of one factorization, 2n^3/3."""
        return lu_flops(self.config["n"])


@dataclasses.dataclass
class Kept:
    """An answer kept for the comparison: its window index and pool matrix."""

    index: int
    pool_index: int
    answer: Answer


class _Reservoir:
    """Keeps ``k`` answers drawn uniformly, by a seeded generator, from a
    stream of unknown length; copies go into buffers made at set-up from
    ``like`` (or at the first answer, without one)."""

    def __init__(self, k: int, seed: int, like: Answer | None):
        self.k = k
        self.rng = random.Random(seed)
        self.seen = 0
        self.kept = []
        if like is not None:
            self._alloc(like)

    def _alloc(self, like) -> None:
        self.kept = [Kept(-1, -1, Answer(torch.empty_like(like.lu), like.ipiv.clone(),
                                         like.info.clone(), like.perm.clone()))
                     for _ in range(self.k)]

    def offer(self, index: int, pool_index: int, res) -> None:
        if not self.kept:
            self._alloc(res)
        slot = self.seen if self.seen < self.k else self.rng.randrange(self.seen + 1)
        self.seen += 1
        if slot < self.k:
            kept = self.kept[slot]
            kept.index, kept.pool_index = index, pool_index
            kept.answer.lu.copy_(res.lu)
            kept.answer.ipiv.copy_(res.ipiv)
            kept.answer.info.copy_(res.info)
            kept.answer.perm.copy_(res.perm)

    def nbytes(self) -> int:
        """Device bytes of the kept copies."""
        return sum(t.numel() * t.element_size() for k in self.kept
                   for t in (k.answer.lu, k.answer.ipiv, k.answer.info, k.answer.perm))

    def answers(self) -> list:
        return [k for k in self.kept if k.index >= 0]


def as_answer(res) -> Answer:
    return Answer(lu=res.lu, ipiv=res.ipiv, info=res.info, perm=res.perm)


def closed_loop(fac, pool: list, work: torch.Tensor, record: Record, seconds: float,
                sample: int, seed: int, min_count: int = 1, trace_at: int = 0,
                trace_count: int = 0, like: Answer | None = None):
    """Run the window; fill ``record`` and return ``(kept, profiler)``:
    the answers to check (the reservoir's and the last) and the finished
    profiler, or None."""
    cuda = work.device.type == "cuda"
    rng_seed = (seed * 1_000_003 + 17) % (1 << 63)
    reservoir = _Reservoir(sample, rng_seed, like) if sample else None
    if cuda:
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof, done = None, None
    rf = torch.profiler.record_function
    res = None
    t_start = time.perf_counter()
    t_end = t_start + seconds
    i = 0
    while True:
        tracing = trace_count > 0 and trace_at <= i < trace_at + trace_count
        if tracing and prof is None:
            prof = torch.profiler.profile(activities=acts)
            prof.start()
        j = i % len(pool)
        scope = rf if tracing else (lambda _: contextlib.nullcontext())
        with scope("refill"):
            if cuda:
                ev0.record()
            t0 = time.perf_counter()
            work.copy_(pool[j])
        with scope("factorization"):
            res = None  # a factorizer that returns new tensors frees the last ones first
            t_call = time.perf_counter()
            res = fac(work)
            t_ret = time.perf_counter()
        if cuda:
            ev1.record()
        with scope("info_read"):
            int(res.info)
        if cuda:
            ev1.synchronize()
        t_done = time.perf_counter()
        record.factor_s.append(ev0.elapsed_time(ev1) / 1e3 if cuda else t_done - t0)
        i += 1
        last = (t_done >= t_end and i >= min_count
                and (trace_count == 0 or i >= trace_at + trace_count))
        if tracing:
            if i == trace_at + trace_count:
                prof.stop()
                done, prof = prof, None
        else:
            record.issue_s.append(t_ret - t_call)
            # the last answer is checked anyway: the reservoir draws from the others
            if reservoir is not None and not last:
                reservoir.offer(i - 1, j, res)
        if last:
            break
    record.count = i
    record.wall_s = t_done - t_start
    kept = reservoir.answers() if reservoir is not None else []
    record.kept_bytes = reservoir.nbytes() if reservoir is not None else 0
    return kept + [Kept(i - 1, j, as_answer(res))], done
