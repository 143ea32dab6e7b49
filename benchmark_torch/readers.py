"""What each metric reads from a run's :class:`benchmark_torch.window.Record`.

``metrics/<name>.py`` binds a metric of ``BENCHMARK.json`` to one of these
(a quantity that two groups of cells report under two names, each with the
bound its cells' spread allows, shares its reader).  Each returns None when
it finds nothing to read; the harness then leaves the metric out.
"""

from __future__ import annotations

from benchmark_torch.yardstick import p95, trailing_bound_s

#: kernel 1 (csrc/strip_pivots.cu) and kernel 2 (csrc/rowblock.cu)
PANEL = (r"\bstrip_kernel\b", r"\bdiag_kernel\b", r"\btail_kernel\b")
#: kernel 4 (csrc/exchange.cu): the pivot-row gather of rows:: in
#: csrc/common.cuh, then the scatter of displaced band rows
EXCHANGE = (r"rows::.*\bgather_kernel\b", r"\bscatter_band_kernel\b")
#: kernel 6 (csrc/gemm_sub.cu): the Hopper routine's register-epilogue
#: instance and the FFMA routine; kernel 12's update pass, the same
#: routine with C through shared memory (``<..., true>``), is not counted
TRAILING = (r"\btrailing_kernel<[^<>]*,\s*false>", r"\bffma_sub_kernel\b")


def tflops(run):
    """2n^3/3 over every factorization completed in the window, divided by
    the window's wall time (host clock) from its start to the last
    completion."""
    return run.count * run.flops / run.wall_s / 1e12 if run.count else None


def factor_ms_p95(run):
    """95th percentile (nearest rank) of every factorization's time in the
    window, from the refill to the factorizer's last device operation
    (CUDA events)."""
    return p95(run.factor_s) * 1e3 if run.factor_s else None


def nbe(run):
    """||L U - A[perm]||_F / (n ||A||_F) in fp64 on the card, of the
    window's last factorization (``reference.residual``)."""
    return run.nbe_last


def setup_s(run):
    """From the harness's start to the end of the warm-up factorization."""
    return run.setup_s


def host_issue_ms(run):
    """Mean host time from the factorizer's call to its return, before
    ``info`` is read, over the window's untraced factorizations."""
    return sum(run.issue_s) / len(run.issue_s) * 1e3 if run.issue_s else None


def idle_pct(run):
    """1 - (union of the device's activity) / (first device activity to
    last) over the traced factorizations, in percent."""
    t = run.trace
    if t is None or t.span_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.span_s)


def device_ms(run):
    """Device ms per factorization: the union of the device's activity over
    the traced factorizations, divided by their count.  It follows the
    kernels' work and not the host's pace, which sets ``tflops`` where the
    host issues more slowly than the device runs."""
    t = run.trace
    if t is None or t.busy_s <= 0:
        return None
    return t.busy_s / t.count * 1e3


def _kernel_ms(run, patterns):
    t = run.trace
    s = t.seconds(patterns) if t is not None else None
    return s / t.count * 1e3 if s is not None else None


def panel_ms(run):
    """Device ms per factorization of the panel chains (kernels 1 and 2)."""
    return _kernel_ms(run, PANEL)


def exchange_ms(run):
    """Device ms per factorization of the row exchange (kernel 4)."""
    return _kernel_ms(run, EXCHANGE)


def trailing_roofline(run):
    """The trailing updates' least time on the chip
    (``yardstick.trailing_bound_s``: counted from n and the block, C read
    and written once, L21 and U12 read once, against the published peaks)
    over the device time of kernel 6's launches, in percent."""
    ms = _kernel_ms(run, TRAILING)
    if ms is None:
        return None
    c = run.config
    bound = trailing_bound_s(c["n"], c["make_mpf"]["block"], c["storage"], c["gemm_operands"])
    return 100.0 * bound * 1e3 / ms
