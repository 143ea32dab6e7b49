"""Each cell end to end on the CPU at a tiny size, with the plain versions
of the program's kernels: set-up, window, the kept answers' check, the
metric readers and the result line.  No number from these runs is a device
number: the command itself refuses to run without a card."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark_torch import run, spec
from benchmark_torch.tests.conftest import CELLS, tiny

#: generous limits for a tiny n: the cells' own are set at their real size
LOOSE = {"nbe": 1e-3, "max_err": 10.0, "info": 0, "perm_diff": 0}


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_end_to_end(name, trace):
    lines = []
    cell = tiny(name, LOOSE)
    result, record = run.run_cell(cell, 2 ** 33 + 5, 0.3, trace, device="cpu",
                                  out=lines.append)
    assert result["correct"] and result["failed"] == 0
    assert result["attempted"] == record.count >= cell.config["check_sample"] + 1
    assert list(result)[-1] == "checks"
    assert set(result["checks"]) == set(LOOSE)
    assert record.nbe_last is not None and 0 < record.nbe_last < 1e-3
    first = json.loads(lines[0])
    assert first["answers_checked"] == cell.config["check_sample"] + 1
    assert first["plain_calls"]["strip_pivots"] > 0  # the CPU runs the plain versions
    names = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    if trace:
        # no device activity on the CPU: the device readers find nothing and are left out
        assert {m.split(".")[0] for m in result["metrics"]} == {"host_issue_ms"}
        assert record.trace.busy_s == 0 and "breakdown" in result
    else:
        assert set(result["metrics"]) == names
    json.dumps(result)


def test_no_card_no_result():
    """Without a card the command exits nonzero and prints nothing."""
    root = spec.ROOT
    proc = subprocess.run([sys.executable, "-m", "benchmark_torch.run", "--workload",
                           CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=root, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""


def test_without_the_program_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files, the command exits nonzero and prints nothing."""
    shutil.copy(spec.SPEC, tmp_path / "BENCHMARK.json")
    shutil.copytree(spec.HERE, tmp_path / "benchmark_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-m", "benchmark_torch.run", "--workload",
                           CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=tmp_path, capture_output=True, text=True, timeout=120, env=env)
    assert proc.returncode != 0 and proc.stdout == ""
