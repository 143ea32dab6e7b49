"""The yardstick's arithmetic: operations, bytes, rooflines, percentiles,
and busy time as a union of intervals."""

import math
import types

import pytest

from benchmark_torch import readers, trace, yardstick


def test_lu_flops():
    assert yardstick.lu_flops(16384) == pytest.approx(2 * 16384 ** 3 / 3)
    assert yardstick.lu_flops(65536) == pytest.approx(1.876e14, rel=1e-3)


@pytest.mark.parametrize("n, c_dtype, bound_ms, ops_bound", [
    (16384, "float32", 3.2553, False),    # fp32 C: NB/4 = 256 flop/B, under the 295 ridge
    (65536, "bfloat16", 185.314, True),   # bf16 C: NB/2 = 512 flop/B, over it
])
def test_trailing_roofline(n, c_dtype, bound_ms, ops_bound):
    work = yardstick.trailing_work(n, 1024, c_dtype, "bfloat16")
    assert len(work) == n // 1024 - 1
    m = n - 1024
    flops, nbytes = work[0]
    assert flops == 2.0 * m * m * 1024
    cb = 4 if c_dtype == "float32" else 2
    assert nbytes == 2 * cb * m * m + 2 * 2 * m * 1024
    # the largest update is bound by operations with bf16 C, by bytes with fp32 C
    assert (flops / yardstick.PEAK_FLOPS["bfloat16"]
            > nbytes / yardstick.PEAK_BYTES_PER_S) == ops_bound
    got = yardstick.trailing_bound_s(n, 1024, c_dtype, "bfloat16") * 1e3
    assert got == pytest.approx(bound_ms, rel=1e-4)


def test_trailing_work_ragged_last_block():
    work = yardstick.trailing_work(2500, 1024, "float32", "bfloat16")
    assert [round(f / (2 * 1024)) for f, _ in work] == [1476 ** 2, 452 ** 2]


@pytest.mark.parametrize("count", [1, 19, 20, 21, 100, 215])
def test_p95_is_a_sample_of_all(count):
    values = [float(v) for v in range(count, 0, -1)]  # any order
    got = yardstick.p95(values)
    assert got in values
    assert sum(v <= got for v in values) >= 0.95 * count
    assert sum(v < got for v in values) < 0.95 * count
    assert got == math.ceil(0.95 * count)


def test_union_counts_overlaps_once():
    spans = [(5.0, 6.0), (0.0, 2.0), (1.0, 3.0), (5.5, 5.7), (3.0, 3.5)]
    assert yardstick.union_length(spans) == pytest.approx(4.5)
    assert yardstick.merged(spans) == [(0.0, 3.5), (5.0, 6.0)]
    assert yardstick.union_length([]) == 0


def test_trace_idle_share_and_gap_names():
    # two streams overlap in [1, 2]; the device idles in (3, 4) while the
    # host is in aten::item inside the harness's "factorization" range
    device = [(0.0, 2.0, "k1"), (1.0, 3.0, "k2"), (4.0, 5.0, "k1")]
    host = [(0.0, 5.0, "factorization"), (3.2, 3.9, "aten::item")]
    t = trace.summarize(device, host, count=2, outer_names=("factorization",))
    assert t.busy_s == pytest.approx(4.0)
    assert t.span_s == pytest.approx(5.0)
    assert t.kernels == {"k1": pytest.approx(3.0), "k2": pytest.approx(2.0)}
    assert t.gaps == {"aten::item": pytest.approx(1.0)}
    assert t.seconds([r"^k1$"]) == pytest.approx(3.0)
    assert t.seconds([r"^nothing$"]) is None
    assert t.top(t.kernels) == [["k1", pytest.approx(1.5)], ["k2", pytest.approx(1.0)]]


def test_device_ms_is_busy_time_per_factorization():
    device = [(0.0, 2.0, "k1"), (1.0, 3.0, "k2"), (4.0, 5.0, "k1")]
    run = types.SimpleNamespace(trace=trace.summarize(device, [], count=2))
    assert readers.device_ms(run) == pytest.approx(2000.0)
    # no device activity (the CPU): nothing to read
    run.trace = trace.summarize([], [], count=2)
    assert readers.device_ms(run) is None
    run.trace = None
    assert readers.device_ms(run) is None
