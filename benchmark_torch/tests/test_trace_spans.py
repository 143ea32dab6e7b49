"""The span reduction of :mod:`benchmark_torch.spans` on a synthetic trace,
and its measurement end to end on the CPU at a tiny size."""

import pytest

from benchmark_torch import spans, trace
from benchmark_torch.tests.conftest import tiny
from benchmark_torch.window import RANGES

#: (start_s, end_s, name, kind, id, linked): one factorization and the
#: refill before it.  Stage ``mpf.panel`` holds ``mpf.update``, in which
#: ``aten::mm`` launches kernel A; ``aten::copy_`` launches kernel B inside
#: the factorization but outside every stage; inside ``mpf.trailing``
#: kernel C is launched with no operator open (linked to none; its runtime
#: call shares its id, 45, as an operator's id, 45, of another counter
#: does); kernel D's launcher is not in the trace; ``mpf.panel`` casts a
#: shadow on the device timeline; the profiler's own event carries id 43.
EVENTS = [
    (-1.0, -0.5, "refill", "op", 1, 0),
    (-0.9, -0.85, "aten::copy_", "op", 2, 0),
    (0.0, 10.0, "factorization", "op", 3, 0),
    (1.0, 5.0, "mpf.panel", "op", 4, 0),
    (2.0, 3.0, "mpf.update", "op", 5, 0),
    (2.1, 2.5, "aten::mm", "op", 6, 0),
    (2.2, 2.3, "cudaLaunchKernel", "runtime", 6, 6),
    (6.0, 6.2, "aten::copy_", "op", 7, 0),
    (7.0, 9.0, "mpf.trailing", "op", 8, 0),
    (7.2, 7.3, "cudaLaunchKernel", "runtime", 45, 0),
    (9.5, 9.6, "aten::fill_", "op", 45, 0),
    (9.7, 9.8, "Activity Buffer Request", "other", 43, 0),
    (-0.8, -0.6, "Memcpy DtoD", "device", 40, 2),
    (2.4, 2.9, "kernel_a", "device", 41, 6),
    (2.4, 4.0, "mpf.panel", "shadow", 42, 4),
    (3.5, 3.6, "kernel_d", "device", 43, 99),
    (6.3, 6.8, "kernel_b", "device", 44, 7),
    (7.5, 8.5, "kernel_c", "device", 45, 0),
]


def _close(got: dict, want: dict):
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v), k


def test_tables_of_a_synthetic_trace():
    device, host = spans.split(EVENTS, RANGES)
    assert all(d[2] != "mpf.panel" for d in device)  # the shadow is no device work
    s = spans.reduce(device, host, 1, RANGES)
    _close(s.device, {"mpf.update": 0.5, "factorization": 0.5, "mpf.trailing": 1.0,
                      "refill": 0.2, spans.UNLINKED: 0.1})
    assert s.kernels["mpf.update"] == {"kernel_a": pytest.approx(0.5)}
    assert s.kernels["mpf.trailing"] == {"kernel_c": pytest.approx(1.0)}
    _close(s.host, {"refill": 0.5, "factorization": 10.0, "mpf.panel": 4.0,
                    "mpf.update": 1.0, "mpf.trailing": 2.0})
    # gaps' middles: 0.9 (before the first stage), 3.2 and 4.95 (in the
    # panel stage after its update), 7.15 (in the trailing stage)
    _close(s.idle, {"factorization": 3.0, "mpf.panel": 3.3, "mpf.trailing": 0.7})
    assert s.busy_s == pytest.approx(2.3)
    assert s.coverage() == pytest.approx(0.75)
    assert spans.update_ms(s) == pytest.approx(500.0)
    assert spans.u12_ms(s) is None  # no such stage ran
    assert spans.panel_issue_ms(s) == pytest.approx(4000.0)
    assert spans.panel_idle_ms(s) == pytest.approx(3300.0)


def test_the_benchmark_trace_tables_do_not_move():
    """With and without the stages: the same device work, busy time and
    idle time; a gap named by the harness's range is now named by the
    stage that held it."""
    device, host = spans.split(EVENTS, RANGES)
    plain = [d[:3] for d in device]
    with_spans = trace.summarize(plain, host, 1, RANGES)
    bare = trace.summarize(plain, [h for h in host if not h[2].startswith("mpf.")], 1, RANGES)
    assert with_spans.kernels == bare.kernels
    assert with_spans.busy_s == bare.busy_s and with_spans.span_s == bare.span_s
    assert sum(with_spans.gaps.values()) == pytest.approx(sum(bare.gaps.values()))
    _close(bare.gaps, {"factorization": 7.0})
    _close(with_spans.gaps, {"factorization": 3.0, "mpf.panel": 3.3, "mpf.trailing": 0.7})


def test_nested_labels_with_equal_starts():
    ranges = [(0.0, 10.0, "outer"), (0.0, 4.0, "inner"), (5.0, 6.0, "next")]
    assert spans._label([0.0, 4.5, 5.5, 9.0, 11.0, -1.0], ranges) == [
        "inner", "outer", "next", "outer", None, None]


def test_no_device_activity_reads_nothing():
    device, host = spans.split([e for e in EVENTS if e[3] != "device"], RANGES)
    s = spans.reduce(device, host, 1, RANGES)
    assert s.busy_s == 0 and s.coverage() is None
    for name, read in spans.METRICS.items():
        assert read(s) is None, name


def test_measure_on_the_cpu():
    """The measurement end to end at a tiny size with the plain versions:
    counters of the cell's route, stages on the host, no device reading."""
    cell = tiny("mpf_bf16_n16384.hpl")
    out = spans.measure(cell, 2 ** 33 + 9, 0.3, device="cpu")
    n, block, r = cell.config["n"], cell.config["make_mpf"]["block"], cell.config["make_mpf"]["r"]
    per = out["per_factorization"]
    assert per["block_columns"] == {"fused": n // block, "masked": 0}
    assert per["panels"] == {"fused": n // r, "masked": 0}
    assert set(out["span_host_ms"]) >= {"mpf.panel", "mpf.update", "mpf.exchange", "mpf.u12",
                                        "mpf.trailing", "factorization"}
    assert out["issue_ms_traced"] > 0 and out["issue_ms_untraced"]["mean"] > 0
    assert all(v is None for v in out["metrics"].values()) and out["coverage"] is None
