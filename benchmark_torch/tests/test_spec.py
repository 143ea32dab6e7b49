"""BENCHMARK.json against the loader's rules, and each cell's files found
by name."""

import copy
import json

import pytest

from benchmark_torch import spec
from benchmark_torch.tests.conftest import CELLS


@pytest.fixture
def raw():
    with open(spec.SPEC) as f:
        return json.load(f)


def test_benchmark_json_keeps_the_rules(raw):
    spec.validate(raw)
    assert sorted(w["name"] for w in raw["workloads"]) == sorted(CELLS)
    assert raw["command"][:3] == ["python3", "-m", "benchmark_torch.run"]
    assert len(json.dumps(raw)) < 64 * 1024


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    cell = spec.cell(spec.load(), name)
    config, traffic = name.split(".")
    assert cell.config["name"] == config
    assert (spec.HERE / "traffic" / f"{traffic}.json").is_file()
    assert set(cell.limits["limits"]) <= spec.COMPARED
    names = {m["name"] for m in cell.end_to_end}
    assert {"nbe", "setup_s"} <= names and f"tflops.{config.split('_')[-1]}" in names
    for m in cell.end_to_end + cell.per_layer:
        assert (spec.HERE / "metrics" / f"{m['name']}.py").is_file()


def test_unknown_cell(raw):
    with pytest.raises(spec.SpecError):
        spec.cell(raw, "mpf_bf16_n16384.nothing")


def _break(raw, edit):
    bad = copy.deepcopy(raw)
    edit(bad)
    with pytest.raises(spec.SpecError):
        spec.validate(bad)


@pytest.mark.parametrize("edit", [
    lambda s: s["end_to_end"][0].update(name="tera flops"),
    lambda s: s["end_to_end"][0].update(name=".tflops"),
    lambda s: s["per_layer"][0].update(unit="milli seconds"),
    lambda s: s["per_layer"][0].update(unit="µs"),
    lambda s: s["per_layer"][0].update(workloads=["no_such.cell"]),
    lambda s: s["end_to_end"][1].update(workloads=["mpf_bf16_n16384.hpl", "gone.cell"]),
    lambda s: s["end_to_end"][0].update(bound=0.3),
    lambda s: s["end_to_end"][0].update(source="program_counter"),
    lambda s: s["per_layer"][0].update(moves="no_such_metric"),
    lambda s: s["per_layer"][0].update(why="metrics take no why"),
    lambda s: s["workloads"][0].update(traffic="missing_mix"),
    lambda s: s["workloads"][0].update(chips=2),
    lambda s: s["workloads"].append(dict(s["workloads"][0], name="dup.cell")),
    lambda s: s["configs"][0].update(reduced=["a width"]),
    lambda s: s.update(run_seconds=52),
    lambda s: s.update(extra=1),
    lambda s: next(m for m in s["end_to_end"] if m["name"] == "setup_s").update(
        workloads=[w["name"] for w in s["workloads"]]),
], ids=["space", "dot", "unit-space", "unit-greek", "missing-cell", "missing-cell-2",
        "loose-bound", "e2e-source", "moves", "metric-why", "traffic-file", "chips",
        "repeated-pair", "reduced-name", "run-seconds", "top-key", "setup-s-workloads"])
def test_loader_refuses(raw, edit):
    _break(raw, edit)
