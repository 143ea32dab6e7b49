"""The cell ``mpf_fp16_n16384.uniform`` (MPF_FP16, the masked path) on the
CPU at a tiny size, through ``conftest.tiny`` (n = 256, block 128, r = 32):
the loader takes its entries, a sound run is correct, and the control and
each fault the masked path can have are refused, under limits set between
the program's and the control's readings as ``test_control.py`` sets them
(the faults: half of every trailing update's rows left out, a tile of the
update altered, one pivot altered, and the outer LASWP after each block
column left out).  Also the counts of :mod:`benchmark_torch.masked_work`
against a count by hand, the metrics' readers on a trace summary, and the
plain reference's imports."""

import json
import subprocess
import sys

import pytest

import mpf_tpu_torch.models.mpf as mpf_loop
from benchmark_torch import masked_work, readings, run, spec, trace, window
from benchmark_torch.tests.conftest import tiny
from benchmark_torch.tests.test_faults import _altered_pivot, _altered_update, _half_rows

CELL = "mpf_fp16_n16384.uniform"
SEEDS = [11, 2 ** 32 + 7, 3_000_000_101]
NEW_LAYER = ("masked_panel_ms.n16384", "prepivot_roofline.n16384", "npv_roofline.n16384",
             "laswp_roofline.n16384")
#: the existing metrics the cell is appended to; ``nbe`` is checked in every
#: run (its limit decides ``correct``) but not reported: across seeds it
#: spreads by more than half its bound
APPENDED = ("tflops.n16384", "factor_ms_p95", "host_issue_ms.n16384", "idle_pct.n16384",
            "device_ms.n16384", "trailing_roofline.n16384")


def _no_outer_laswp(orig):
    """Kernel 9 without the exchange outside the block column: at the tiny
    size a panel's LASWP moves at most 2r = 64 rows, the outer one 2
    block = 256."""
    def laswp(slab, cand, src):
        return slab if cand.numel() > 2 * 32 else orig(slab, cand, src)
    return laswp


@pytest.fixture(scope="module")
def limits():
    """The nbe limit between the program's largest and the control's
    smallest tiny reading (their geometric mean)."""
    cell = tiny(CELL, {"nbe": 1.0, "info": 0, "perm_diff": 0})
    prog = readings.read(cell, SEEDS, 0.2, False, device="cpu", out=lambda _: None)
    ctl = readings.read(cell, SEEDS, 0.2, True, device="cpu", out=lambda _: None)
    assert min(ctl["nbe"]) >= 10 * max(prog["nbe"])
    return {"nbe": (max(prog["nbe"]) * min(ctl["nbe"])) ** 0.5, "info": 0, "perm_diff": 0}


def test_loader_takes_the_new_entries():
    s = spec.load()
    cell = spec.cell(s, CELL)
    assert cell.chips == 1 and cell.config["policy"] == "MPF_FP16"
    assert cell.config["gemm_operands"] == "float32" and cell.config["saturate_panel"]
    assert cell.traffic["high"] == 9.9
    assert {m["name"] for m in cell.end_to_end} == {"tflops.n16384", "factor_ms_p95",
                                                    "setup_s"}
    assert {m["name"] for m in cell.per_layer} == set(NEW_LAYER) | set(APPENDED[2:])
    conf = next(c for c in s["configs"] if c["name"] == "mpf_fp16_n16384")
    assert conf["reduced"] == ["working_precision"]


FAULTS = ["none", "control", "half_rows", "altered_update", "altered_pivot", "no_outer_laswp"]


@pytest.mark.parametrize("fault", FAULTS)
def test_only_the_sound_program_is_correct(fault, limits, monkeypatch):
    cell = tiny(CELL, limits)
    fac = None
    if fault == "control":
        fac = run.control_factorizer(cell.config)
    elif fault == "half_rows":
        monkeypatch.setattr(mpf_loop, "trailing_gemm_sub",
                            _half_rows(mpf_loop.trailing_gemm_sub))
    elif fault == "altered_update":
        monkeypatch.setattr(mpf_loop, "trailing_gemm_sub",
                            _altered_update(mpf_loop.trailing_gemm_sub))
    elif fault == "altered_pivot":
        fac = _altered_pivot(run.program_factorizer(cell.config))
    elif fault == "no_outer_laswp":
        monkeypatch.setattr(mpf_loop, "laswp_apply", _no_outer_laswp(mpf_loop.laswp_apply))
    # make_mpf caches its factorizers; each case builds its own
    mpf_loop._make_mpf.cache_clear()
    result, _ = run.run_cell(cell, SEEDS[0] + 5, 0.2, False, device="cpu", factorizer=fac,
                             warmup=fault != "control", out=lambda _: None)
    mpf_loop._make_mpf.cache_clear()
    assert result["correct"] is (fault == "none"), result["checks"]


def test_tiny_run_takes_the_masked_path():
    cell = tiny(CELL, {"nbe": 1e-3, "info": 0, "perm_diff": 0})
    lines = []
    result, _ = run.run_cell(cell, SEEDS[1], 0.2, False, device="cpu", out=lines.append)
    assert result["correct"] is True
    assert set(result["metrics"]) == {"tflops.n16384", "factor_ms_p95", "setup_s"}
    assert set(result["checks"]) == {"nbe", "info", "perm_diff"}
    head = json.loads(lines[0])
    plain, count = head["plain_calls"], head["factorizations"]
    # 8 panels of 32 and 2 block columns a factorization, counted over the
    # window (the counters are reset after the warm-up)
    assert plain["hgetf2"] == 8 * count and plain["npv_inv"] == 8 * count
    assert plain["laswp"] == (8 + 2) * count
    assert "panel_update" not in plain and "strip_pivots" not in plain


def test_counts_by_hand():
    """n = 256, r = 32, block = 128: 8 panels, j0 = 0, 32, ..., 224."""
    n, r, block = 256, 32, 128
    pre = masked_work.prepivot_work(n, r, block)
    assert len(pre) == 8
    for t, (flops, nbytes) in enumerate(pre):
        m = n - 32 * t
        want = 0
        for j in range(r):
            below = m - j - 1
            want += below + 2 * below * (r - j - 1)
        assert flops == want and nbytes == 2 * m * r
    # j0 = 0: m = 256, sum of (255 - j)(63 - 2j) over j < 32
    assert pre[0][0] == 250_704
    npv = masked_work.npv_work(n, r, block)
    assert npv == [(4 * 32 ** 3 / 3, 4 * 4 * 32 * 32)] * 8
    lsw = masked_work.laswp_work(n, r, block)
    # 8 panels: 64 rows of 128 read and written; 2 block columns: 256 rows of 128
    assert lsw == [(0.0, 2 * 4 * 64 * 128)] * 8 + [(0.0, 2 * 4 * 256 * 128)] * 2


def test_readers_on_a_trace():
    """The readers pick the masked path's kernels by name, charge each its
    share of the roofline, and read nothing where kernel 9's gather cannot
    be told from kernel 4's."""
    conf = spec.cell(spec.load(), CELL).config
    names = {
        "void (anonymous namespace)::hgetf2_kernel<__half, __half, false>(int)": 0.050,
        "void (anonymous namespace)::npv_tile_kernel<true>(int)": 0.015,
        "void rows::(anonymous namespace)::gather_kernel<unsigned int>(int, unsigned int "
        "const*, long long, int const*, unsigned int*)": 0.004,
        "void (anonymous namespace)::scatter_kernel<unsigned int>(int, unsigned int*, long "
        "long, int const*, unsigned int const*)": 0.006,
        "void gemm::ffma_sub_kernel<true>(CUtensorMap, CUtensorMap, gemm::Args)": 0.056,
    }
    rec = window.Record(config=conf)
    rec.trace = trace.TraceSummary(count=1, kernels=names, busy_s=0.2, span_s=0.21, gaps={})
    assert masked_work.masked_panel_ms(rec) == pytest.approx(75.0)
    n, r, block = conf["n"], conf["make_mpf"]["r"], conf["make_mpf"]["block"]
    assert masked_work.laswp_roofline(rec) == pytest.approx(
        100 * masked_work.bound_s(masked_work.laswp_work(n, r, block)) / 0.010)
    for read in (masked_work.prepivot_roofline, masked_work.npv_roofline,
                 masked_work.laswp_roofline):
        assert 0 < read(rec) < 100
    rec.trace.kernels["void (anonymous namespace)::scatter_band_kernel<unsigned int>(int)"] = 1e-3
    assert masked_work.laswp_roofline(rec) is None and masked_work.masked_panel_ms(rec) is None
    assert masked_work.prepivot_roofline(window.Record(config=conf)) is None


def test_reference_imports_no_program():
    code = ("import sys, benchmark_torch.reference_mpf; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'mpf_tpu', 'mpf_tpu_torch')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(spec.ROOT))
    assert out.returncode == 0, out.stdout + out.stderr
